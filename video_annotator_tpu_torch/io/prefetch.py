"""Host->device frame feed and device->host writer, each on a worker thread,
and the readback-free device sink.

Port of ``video_annotator_tpu/io/prefetch.py`` (``DevicePrefetcher``,
``AsyncFrameWriter``, ``DeviceReduceSink``). On a CUDA device the prefetcher stages each
decoded frame in a ring of pinned host buffers and copies it with
``non_blocking`` on a side stream, a few frames ahead of the consumer;
the consumer's stream waits on the copy's event before using the frame.
On the CPU frames pass through as tensors. The writer reads frames bound
for a bare y4m sink back into one pinned frame record, which the sink
writes whole.

Both take the render's :class:`~video_annotator_tpu_torch.pipeline.profiler.StageProfiler`
(or none) and open their stages on their own threads.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from video_annotator_tpu_torch.io.y4m import FRAME_MARKER

_SENTINEL = object()


def _span(profiler):
    """``profiler.stage``, or a stage that records nothing."""
    return profiler.stage if profiler is not None else (lambda name: contextlib.nullcontext())


class DevicePrefetcher:
    """Wrap a planar-YUV frame iterator; yields (y, u, v) uint8 tensors on
    ``device`` with up to ``depth`` frames in flight.

    Stages of ``profiler``: ``upload`` on the feed thread (``frame-feed``)
    for each frame (on a card the copy into a pinned slot, the wait for
    that slot's last copy and the copy's enqueue; on the CPU the tensor
    conversion), and ``feed-wait`` on the consumer's thread for each pull
    from the queue, one a frame and one for the end of the stream."""

    def __init__(self, frames, depth: int = 3, device="cpu", profiler=None):
        self._frames = frames
        self._device = torch.device(device)
        self._depth = max(depth, 1)
        self._span = _span(profiler)
        self._q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name="frame-feed", daemon=True)
        self._thread.start()

    def _upload(self, planes, stream, ring, slot):
        """Copy host planes through pinned slot ``slot`` of ``ring``."""
        prev = ring[slot]
        if prev is not None:
            prev[1].synchronize()  # the slot's last copy has finished
        shapes = [np.shape(a) for a in planes]
        if prev is None or [tuple(b.shape) for b in prev[0]] != shapes:
            bufs = [torch.empty(s, dtype=torch.uint8, pin_memory=True)
                    for s in shapes]
        else:
            bufs = prev[0]
        for b, a in zip(bufs, planes):
            b.numpy()[...] = a
        with torch.cuda.stream(stream):
            dev = tuple(b.to(self._device, non_blocking=True) for b in bufs)
            event = torch.cuda.Event()
            event.record(stream)
        ring[slot] = (bufs, event)
        return dev, event

    def _worker(self):
        try:
            it = iter(self._frames)
            cuda = self._device.type == "cuda"
            stream = torch.cuda.Stream(self._device) if cuda else None
            # A slot is refilled only after its previous copy finished
            # (_upload waits on its event); more slots than the queue depth
            # keep that wait off the common path.
            ring = [None] * (self._depth + 2)
            slot = 0
            while not self._stop.is_set():
                try:
                    planes = next(it)
                except StopIteration:
                    break
                with self._span("upload"):
                    if cuda:
                        item = self._upload(planes, stream, ring, slot)
                        slot = (slot + 1) % len(ring)
                    else:
                        item = (tuple(torch.from_numpy(np.array(a, np.uint8))
                                      for a in planes), None)
                self._q.put(item)
            self._q.put(_SENTINEL)
        except BaseException as e:  # propagate into the consumer
            self._err = e
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        while True:
            with self._span("feed-wait"):
                item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            planes, event = item
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for p in planes:
                    p.record_stream(current)
            yield planes

    def close(self):
        """Stop and join the worker before the caller closes the source."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class AsyncFrameWriter:
    """Device->host readback + encode on a worker thread; ``depth`` bounds
    the frames in flight. Errors surface on the next ``write`` or on
    ``close``.

    The frames take one of two paths, chosen from the sink and counted in
    ``profiler`` by name:

    - ``record``, where the sink takes whole y4m frame records
      (``write_record``: a y4m file or pipe with no HUD, preview or
      display wrapped around it). The planes are copied, on the stream
      that made them, into one host buffer laid out as the frame's record
      (:data:`~video_annotator_tpu_torch.io.y4m.FRAME_MARKER`, Y, U, V),
      page-locked on a card and allocated at the first frame, which the
      sink writes whole. ``pipe_bytes`` notes the buffer of the pipe the
      records go into.
    - ``planes`` for every other sink: numpy copies of the planes, which
      the HUD and the preview draw on, to ``writer.write``.

    Stages of ``profiler``, on the writer thread (``frame-writer``), for
    each frame: ``readback``, the planes' copy to host memory, which
    first waits for the device work that made them (the warp); ``sink``,
    the write (the file, and what is wrapped around it: the HUD, the
    preview)."""

    def __init__(self, writer, depth: int = 3, profiler=None):
        self._writer = writer
        self._span = _span(profiler)
        self._count = profiler.count if profiler is not None else (lambda name: None)
        self._note = profiler.note if profiler is not None else (lambda name, value: None)
        self._records = hasattr(writer, "write_record")
        self._record = None  # (the host buffer as numpy, its Y, U and V views)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="frame-writer", daemon=True)
        self._thread.start()

    def _record_views(self, planes):
        if self._record is None:
            sizes = [p.numel() for p in planes]
            buf = torch.empty(len(FRAME_MARKER) + sum(sizes), dtype=torch.uint8,
                              pin_memory=planes[0].is_cuda)
            buf.numpy()[:len(FRAME_MARKER)] = np.frombuffer(FRAME_MARKER, np.uint8)
            views, at = [], len(FRAME_MARKER)
            for p, n in zip(planes, sizes):
                views.append(buf[at:at + n].view(p.shape))
                at += n
            self._record = (buf.numpy(), views)
        return self._record[1]

    def _write_record(self, planes, stream):
        with self._span("readback"):
            views = self._record_views(planes)
            if stream is None:
                for view, p in zip(views, planes):
                    view.copy_(p)
            else:
                with torch.cuda.stream(stream):
                    for view, p in zip(views, planes):
                        view.copy_(p, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()  # releases the interpreter lock
        with self._span("sink"):
            self._writer.write_record(self._record[0])
        self._count("record")
        if self._writer.pipe_bytes is not None:
            self._note("pipe_bytes", self._writer.pipe_bytes)

    def _write_planes(self, planes):
        with self._span("readback"):
            host = tuple(p.cpu().numpy() for p in planes)
        with self._span("sink"):
            self._writer.write(host)
        self._count("planes")

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._err is not None:
                continue  # drain after failure
            try:
                if self._records:
                    self._write_record(*item)
                else:
                    self._write_planes(item[0])
            except BaseException as e:
                self._err = e

    def write(self, planes):
        if self._err is not None:
            raise self._err
        p = planes[0]
        self._q.put((planes, torch.cuda.current_stream(p.device) if p.is_cuda else None))

    def close(self):
        self._q.put(_SENTINEL)
        self._thread.join()
        if self._err is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            raise self._err
        self._writer.close()


class DeviceReduceSink:
    """Output consumer that never reads a frame back: ``write((y, u, v))``
    folds each frame's planes into a running checksum on their device (a
    real data dependency, so the warps it consumes must complete);
    ``close()`` reads it once. With it a streaming render's device half
    (decode, upload, analyse, warp) can be timed apart from the readback
    and the write.

    ``checksum`` is the JAX package's: the sum of every byte written, in
    int32 arithmetic that wraps (one 3840x2880 luma plane of 255 already
    passes 2**31). The device accumulates exact int64 sums; the wrap to
    int32 is taken once, in ``close()``, which gives the same value
    because both are sums modulo 2**32."""

    def __init__(self):
        self._acc = None
        self.checksum: int = 0

    def write(self, planes):
        y, u, v = planes
        total = (y.sum(dtype=torch.int64) + u.sum(dtype=torch.int64)
                 + v.sum(dtype=torch.int64))
        self._acc = total if self._acc is None else self._acc + total

    def close(self):
        if self._acc is not None:
            self.checksum = (int(self._acc) + 2**31) % 2**32 - 2**31
