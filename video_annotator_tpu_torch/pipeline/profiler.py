"""Per-stage wall-clock profiler and live progress line.

Port of ``video_annotator_tpu/pipeline/profiler.py`` (pure Python): average
ms/frame, fps and share of the pipeline per stage, with the first samples
of each stage (kernel builds, allocator warm-up) reported separately.
Stage times are host wall clock; on a CUDA device a stage that ends
without a synchronisation measures the enqueue, not the device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Iterator


class StageProfiler:
    def __init__(self, warmup: int = 3):
        self._total = OrderedDict()  # name -> seconds (post-warmup)
        self._count = OrderedDict()
        self._seen = OrderedDict()  # name -> total invocations
        self._warm_total = OrderedDict()  # warmup seconds (compile etc.)
        # The first few samples per stage carry one-time costs (kernel
        # builds, allocator growth); excluding them makes the steady-state
        # report meaningful. Warmup time is still reported.
        self._warmup = warmup

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            seen = self._seen.get(name, 0)
            self._seen[name] = seen + 1
            if seen < self._warmup:
                self._warm_total[name] = self._warm_total.get(name, 0.0) + dt
                # Keep the stage visible even if it never leaves warmup.
                self._total.setdefault(name, 0.0)
                self._count.setdefault(name, 0)
            else:
                self._total[name] = self._total.get(name, 0.0) + dt
                self._count[name] = self._count.get(name, 0) + 1

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
        """The reference's per-stage report: avg ms/frame, fps, % of total.

        Steady-state only (first ``warmup`` samples per stage excluded);
        total warmup/compile time is summarized on the last line.
        """
        total = sum(self._total.values()) or 1e-12
        lines = []
        for name, secs in self._total.items():
            n = self._count[name]
            if n == 0:
                lines.append(f"{name}: (warmup only)")
                continue
            ms = secs / n * 1000.0
            fps = n / secs if secs > 0 else float("inf")
            lines.append(
                f"{name}: avg {ms:8.2f} ms/frame ({fps:7.1f} fps), "
                f"{secs / total * 100:5.1f}% of pipeline"
            )
        warm = sum(self._warm_total.values())
        if warm > 0.01:
            lines.append(f"warmup/compile (excluded): {warm:.1f} s total")
        return "\n".join(lines)

    def totals(self):
        return dict(self._total), dict(self._count)

    def all_totals(self):
        """(seconds, calls) per stage, warm-up samples included."""
        names = list(self._seen)
        return ({n: self._total.get(n, 0.0) + self._warm_total.get(n, 0.0)
                 for n in names}, dict(self._seen))


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
