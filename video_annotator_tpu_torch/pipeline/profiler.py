"""Per-stage wall-clock profiler and live progress line.

Port of ``video_annotator_tpu/pipeline/profiler.py`` (pure Python): average
ms/frame, fps and share of the pipeline per stage, with the first samples
of each stage (kernel builds, allocator warm-up) reported separately.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Iterator


class _Open:
    """A stage open on one thread: its path of names from the thread's
    outermost open stage, and the seconds its finished children took."""

    __slots__ = ("path", "children")

    def __init__(self, path):
        self.path = path
        self.children = 0.0


class StageProfiler:
    """Host wall-clock time of named stages, on every thread a render hands
    it to.

    ``stage(name)`` is a span: the stage open on the same thread when it
    starts is its parent (a thread-local stack), and its self time is its
    time less its children's. A render's stages, by thread:

    - the caller's thread: ``phase-analyse`` and ``phase-encode`` (the
      two-phase render's phases, each around the stages below that it
      runs), ``open`` (a phase's set-up, from opening the
      source to the first pull of its loop), ``feed-wait`` (a pull from
      :class:`~video_annotator_tpu_torch.io.prefetch.DevicePrefetcher`),
      ``track`` (the analyse; the trackers' ``detect``, ``stage``, ``lk``,
      ``ransac`` with ``hypotheses``, ``chain`` and ``key frame`` inside
      it), ``collect``, ``smooth``, ``warp``, ``encode`` (handing frames
      to :class:`~video_annotator_tpu_torch.io.prefetch.AsyncFrameWriter`,
      and its close) and ``save`` (the trajectory file);
    - the feed thread: ``decode`` (a frame from the reader) and ``upload``;
    - the writer thread: ``readback`` and ``sink``.

    Times are the host's clock. On a CUDA device a stage that ends without
    a synchronisation measures the enqueue of its work, not the work:
    ``warp``, ``stage``, ``lk``, ``ransac`` and ``chain`` (the paired
    analyse never waits for the card). ``readback``, ``smooth``,
    ``collect``, ``key frame`` and ``save`` wait for the device's results
    they copy to the host; ``upload`` waits for its ring slot's last copy.

    ``totals()`` and ``all_totals()`` give seconds and calls by name,
    inclusive of children; ``report()`` groups the stages by thread, each
    thread's counters (``count``, ``note``) after its stages.
    Stages nest as ``with`` blocks do: a stage opened in a generator must
    close before it yields.
    """

    def __init__(self, warmup: int = 3):
        # (thread name, path of stage names) -> [calls, seconds, self
        # seconds, steady calls, warm-up seconds]; the first ``warmup``
        # calls of each carry one-time costs (kernel builds, allocator
        # growth) and are kept apart from the steady state.
        self._nodes = OrderedDict()
        # (thread name, counter name) -> value
        self._counters = OrderedDict()
        self._warmup = warmup
        self._lock = threading.Lock()
        self._local = threading.local()
        # The report's "% of pipeline" is over this thread's outermost stages.
        self._owner = threading.current_thread().name

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        frame = _Open((stack[-1].path if stack else ()) + (name,))
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1].children += dt
            key = (threading.current_thread().name, frame.path)
            with self._lock:
                node = self._nodes.get(key)
                if node is None:
                    node = self._nodes[key] = [0, 0.0, 0.0, 0, 0.0]
                node[0] += 1
                if node[0] <= self._warmup:
                    node[4] += dt
                else:
                    node[1] += dt
                    node[2] += dt - frame.children
                    node[3] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to this thread's counter ``name`` (the writer's frames
        by path)."""
        key = (threading.current_thread().name, name)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def note(self, name: str, value) -> None:
        """Set this thread's counter ``name`` to ``value`` (a size found)."""
        with self._lock:
            self._counters[(threading.current_thread().name, name)] = value

    def counts(self):
        """Counter name -> value, summed over threads, first seen first."""
        out = OrderedDict()
        with self._lock:
            for (_, name), value in self._counters.items():
                out[name] = out.get(name, 0) + value
        return out

    def wrap_iter(self, name: str, it):
        """Time each pull from an iterator (decode stages)."""
        while True:
            with self.stage(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def report(self) -> str:
        """The reference's per-stage report: avg ms/frame, fps, % of total,
        grouped by thread, a nested stage indented under its parent with
        its self time.

        Steady-state only (first ``warmup`` samples per stage excluded);
        the share of the pipeline is of the profiler's own thread's
        outermost stages with steady samples (those inside the phases
        where a render ran each phase ``warmup`` times or fewer), and
        their warmup/compile time is summarized on the last line.
        """
        with self._lock:
            nodes = [(k, list(v)) for k, v in self._nodes.items()]
            counters = list(self._counters.items())
        owned = [(path, v) for (thread, path), v in nodes if thread == self._owner]
        depth = min((len(path) for path, v in owned if v[3]), default=1)
        top = [v for path, v in owned if len(path) == depth]
        total = sum(v[1] for v in top) or 1e-12
        threads = sorted(dict.fromkeys(t for (t, _), _ in nodes + counters),
                         key=lambda t: t != self._owner)
        lines = []

        def emit(thread, parent):
            for (t, path), (_, secs, self_s, n, _) in nodes:
                if t != thread or path[:-1] != parent:
                    continue
                pad = "  " * len(path)
                if n == 0:
                    lines.append(f"{pad}{path[-1]}: (warmup only)")
                else:
                    ms = secs / n * 1000.0
                    fps = n / secs if secs > 0 else float("inf")
                    line = (f"{pad}{path[-1]}: avg {ms:8.2f} ms/frame ({fps:7.1f} fps), "
                            f"self {self_s / n * 1000.0:8.2f} ms")
                    if t == self._owner and len(path) == depth:
                        line += f", {secs / total * 100:5.1f}% of pipeline"
                    lines.append(line)
                emit(thread, path)

        for thread in threads:
            lines.append(f"[{thread}]")
            emit(thread, ())
            mine = [f"{name} {value}" for (t, name), value in counters if t == thread]
            if mine:
                lines.append("  counts: " + ", ".join(mine))
        warm = sum(v[4] for v in top)
        if warm > 0.01:
            lines.append(f"warmup/compile (excluded): {warm:.1f} s total")
        return "\n".join(lines)

    def _by_name(self):
        """name -> [calls, seconds, steady seconds, steady calls], first seen first."""
        out = OrderedDict()
        with self._lock:
            for (_, path), (seen, secs, _, n, warm) in self._nodes.items():
                acc = out.setdefault(path[-1], [0, 0.0, 0.0, 0])
                acc[0] += seen
                acc[1] += secs + warm
                acc[2] += secs
                acc[3] += n
        return out

    def totals(self):
        """(seconds, calls) per stage, steady state."""
        names = self._by_name()
        return ({k: v[2] for k, v in names.items()}, {k: v[3] for k, v in names.items()})

    def all_totals(self):
        """(seconds, calls) per stage, warm-up samples included."""
        names = self._by_name()
        return ({k: v[1] for k, v in names.items()}, {k: v[0] for k, v in names.items()})


class RecordFunctionProfiler(StageProfiler):
    """A :class:`StageProfiler` whose every stage is also a
    ``torch.profiler.record_function`` range, so that a trace of the run
    (``--trace DIR``) shows each stage on its thread above the operations
    it launched, on the trace's clock."""

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        import torch

        with torch.profiler.record_function(name), super().stage(name):
            yield


class Progress:
    """Live render progress on stderr — frames done, fps, ETA.

    The reference streams ffmpeg's progress events (percent + current
    fps) while a render runs (``src/render.ts:1357-1359``; join progress
    from frame counts, ``src/join.ts:36-41``). Prints a carriage-return
    status line at most every ``interval`` seconds, only when stderr is a
    terminal (captured/piped runs stay clean); ``close()`` finishes the
    line with wall time.
    """

    def __init__(self, label: str, total: int | None = None,
                 interval: float = 0.5, stream=None):
        import sys

        self._label = label
        self._total = total if (total or 0) > 0 else None
        self._interval = interval
        self._stream = stream if stream is not None else sys.stderr
        self._enabled = bool(getattr(self._stream, "isatty", lambda: False)())
        self._t0 = time.perf_counter()
        self._last = 0.0
        self._n = 0
        self._dirty = False

    def tick(self, n: int = 1):
        self._n += n
        if not self._enabled:
            return
        now = time.perf_counter()
        if now - self._last < self._interval:
            return
        self._last = now
        fps = self._n / max(now - self._t0, 1e-9)
        if self._total:
            pct = 100.0 * self._n / self._total
            eta = (self._total - self._n) / max(fps, 1e-9)
            msg = (f"\r{self._label}: {self._n}/{self._total} frames "
                   f"({pct:4.1f}%), {fps:.1f} fps, eta {eta:4.0f}s ")
        else:
            msg = f"\r{self._label}: {self._n} frames, {fps:.1f} fps "
        self._stream.write(msg)
        self._stream.flush()
        self._dirty = True

    def close(self):
        if not self._enabled:
            return
        dt = time.perf_counter() - self._t0
        fps = self._n / max(dt, 1e-9)
        self._stream.write(
            f"\r{self._label}: {self._n} frames in {dt:.1f}s "
            f"({fps:.1f} fps)      \n"
        )
        self._stream.flush()
        self._dirty = False
