"""The seams between the analysers and what they call, on the CPU: the
trim window's device frames (``pipeline/render.py::TrimmedFrames``), the
paired tracker's ``push`` / ``finish`` against its chunk step, and the one
LK route (``ops/lk_kernel.py::LKRoute``) that every analyser takes."""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu_torch.camera import CameraModel, CameraPreset, camera_from_dfov
from video_annotator_tpu_torch.io.video import open_reader
from video_annotator_tpu_torch.models import similarity
from video_annotator_tpu_torch.ops import lk_kernel
from video_annotator_tpu_torch.parallel import pipeline as tpipeline
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler
from video_annotator_tpu_torch.tools import run

SRC = "synthetic://shaky?w=256&h=192&n=12&seed=6"
PRESET = CameraPreset.GOPRO_H4B_WIDE43_MEASURED


def lumas(src=SRC):
    reader = open_reader(src)
    frames = [np.array(y) for y, _, _ in reader]
    reader.close()
    return frames


@pytest.mark.parametrize("end", ["whole", "break", "raise"])
def test_trimmed_frames_yield_the_window_and_close(end):
    """Frames 3..8 of the 12 (the synthetic reader cannot seek, so the
    first three are decoded and skipped); the prefetcher stops and the
    reader closes after a whole pass, a ``break`` and an exception."""
    opts = trender.RenderOptions(start=0.1, duration=0.2)
    reader, _, first, last = trender.open_trimmed(SRC, opts, "cpu")
    assert (reader.start_frame, first, last) == (0, 3, 9)
    closed = []
    close = reader.close
    reader.close = lambda: closed.append(True) or close()
    got = []
    frames = trender.TrimmedFrames(reader, first, last, opts, "cpu", StageProfiler())
    with pytest.raises(RuntimeError) if end == "raise" else contextlib.nullcontext():
        with frames:
            for y, _, _ in frames:
                got.append(y.numpy())
                if end != "whole" and len(got) == 2:
                    if end == "raise":
                        raise RuntimeError("in the loop body")
                    break
    assert closed == [True]
    assert not frames.pre._thread.is_alive()
    want = lumas()[first:last]
    assert len(got) == (len(want) if end == "whole" else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_pair_tracker_push_is_the_chained_chunk_step(chunk):
    """``push`` returns the first frame's identity, nothing while a chunk
    fills and the chunk's rotations when it is full; ``finish`` the
    padded tail's. Together: the chunk step over ``paired_stacks``
    chained as the analyse chained it, bit for bit."""
    frames = [torch.from_numpy(y) for y in lumas()]
    n = len(frames)
    meta = trender.VideoMeta(256, 192, 30, n)
    opts = trender.RenderOptions(stabilise="smooth", analysis_mode="paired",
                                 analysis_chunk=chunk, preset=PRESET)
    tracker = trender.PairTracker(meta, opts, "cpu")
    got = [tracker.push(y) for y in frames]
    assert [len(r) for r in got] == [1] + [chunk if i % chunk == 0 else 0 for i in range(1, n)]
    got.append(tracker.finish())
    assert len(got[-1]) == (n - 1) % chunk
    assert len(tracker.finish()) == 0
    got = torch.cat(got)
    assert got.shape == (n, 3, 3)

    step = trender.PairTracker(meta, opts, "cpu")
    eye = torch.eye(3)
    r_base, prev_delta, offset, want = eye, eye, 0, [eye[None]]
    for stack in run.paired_stacks(frames, chunk):
        r_base, prev_delta, rs = step(r_base, prev_delta, offset, stack)
        want.append(rs)
        offset += stack.shape[0] - 1
    assert torch.equal(got, torch.cat(want)[:n])


CLIP = "synthetic://shaky?w=256&h=192&n=4&seed=3"


def run_caller(caller):
    """One analyser or ``track_pairs`` over CLIP, on the CPU."""
    if caller in ("tracked", "paired"):
        trender.analyse(CLIP, trender.RenderOptions(
            stabilise="smooth", analysis_mode=caller, analysis_chunk=2, preset=PRESET),
            device="cpu")
    elif caller == "similarity":
        similarity.analyse_similarity(CLIP, trender.RenderOptions(), device="cpu")
    else:
        seq = torch.from_numpy(np.stack(lumas(CLIP))).to(torch.float32)
        tpipeline.track_pairs(seq, camera_from_dfov(145.8, (256, 192), CameraModel.FISHEYE), 32)


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("caller", ["tracked", "paired", "track_pairs", "similarity"])
def test_every_analyser_takes_the_one_route(monkeypatch, route, caller):
    """With the route's rule patched, each caller stages and tracks as the
    rule says: the plain LK alone, or K3's staging and K2's form for its
    shape (per frame for the sequential trackers, pairs for the chunks)."""
    monkeypatch.setattr(lk_kernel, "resolve_lk", lambda device: route)
    calls = []
    for name in ("pyramidal_lk", "stage_pyramid_pairs", "pyramidal_lk_packed",
                 "pyramidal_lk_pairs"):
        real = getattr(lk_kernel, name)
        monkeypatch.setattr(lk_kernel, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    run_caller(caller)
    one_pair = caller in ("tracked", "similarity")
    want = ({"pyramidal_lk"} if route == "plain" else
            {"stage_pyramid_pairs", "pyramidal_lk_packed" if one_pair else "pyramidal_lk_pairs"})
    assert set(calls) == want
