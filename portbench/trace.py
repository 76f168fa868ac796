"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` records the CUDA activity of the window (kernels,
copies, sets); its events carry the host's wall clock (``time.time_ns``),
which the harness also stamps its own spans with. From them:

- busy: the union of the device's activity intervals inside the window;
- the device operations that took most time, summed by name;
- the idle time between them, summed by what the host was doing at each
  gap's middle (the program's stages, read from the harness's spans).
"""

from __future__ import annotations

import re
from collections import defaultdict

TOP = 10


class DeviceTrace:
    def __init__(self, events, w0_ns: int, w1_ns: int, spans=()):
        """``events``: (name, start_ns, end_ns) of device activity;
        ``spans``: (stage, start_ns, end_ns) the harness recorded."""
        self.w0, self.w1 = w0_ns, w1_ns
        self.events = [(n, max(s, w0_ns), min(e, w1_ns)) for n, s, e in events
                       if e > w0_ns and s < w1_ns and e > s]
        self.spans = list(spans)
        self.busy = _union(sorted((s, e) for _, s, e in self.events))

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def op_seconds(self, pattern: str):
        """(seconds, count) of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.events if rx.search(n)]
        return sum(hits) * 1e-9, len(hits)

    def device_ops(self):
        total = defaultdict(int)
        for n, s, e in self.events:
            total[short_name(n)] += e - s
        return [[n, ns * 1e-9] for n, ns in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self):
        gaps = []
        edge = self.w0
        for s, e in self.busy + [(self.w1, self.w1)]:
            if s > edge:
                gaps.append(((edge + s) // 2, s - edge))
            edge = max(edge, e)
        total = defaultdict(int)
        for label, ns in zip(self.hosts_at([m for m, _ in gaps]), (n for _, n in gaps)):
            total[label] += ns
        return [[n, ns * 1e-9] for n, ns in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def hosts_at(self, times):
        """What the host was doing at each of the sorted ``times``: the
        stages whose spans hold it, joined by ``+``, or ``no stage``."""
        edges = sorted([(s, 1, n) for n, s, e in self.spans]
                       + [(e, -1, n) for n, s, e in self.spans])
        active = defaultdict(int)
        i = 0
        for t in times:
            while i < len(edges) and edges[i][0] <= t:
                active[edges[i][2]] += edges[i][1]
                i += 1
            names = sorted(n for n, c in active.items() if c > 0)
            yield "+".join(names) if names else "no stage"


def _union(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and
    anonymous namespaces, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120]


def kineto_device_events(prof, names: bool = True):
    """(name, start_ns, end_ns) of every device event of a finished
    ``torch.profiler.profile``; with ``names=False`` each name is ``""``,
    which is enough for the busy time and reads faster."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name() if names else "", int(e.start_ns()), int(e.end_ns())))
    return out
