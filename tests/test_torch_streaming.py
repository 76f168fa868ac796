"""The torch port's single-pass ``--streaming`` render on the CPU.

Against its own two-phase render: the same trajectory and the same frames
(within one count, from the two-phase path's exp(log(R)) round trip of
the saved trajectory), under trimming, short clips, both analysers and
both smoothers. Against the JAX package's streaming render: the measured
trajectory per frame, and, with the JAX render's trajectory replayed
through the port's ring, the written frames. And the options streaming
refuses."""

import os

import numpy as np
import pytest
import torch

from test_torch_pipeline import ANGLE_TOL_DEG, PRESET, angle_deg, few_threads  # noqa: F401
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.video import open_reader
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming
from video_annotator_tpu_torch.pipeline.streaming import render_streaming
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv

SRC = "synthetic://shaky?w=256&h=192&n=24&seed=5&shake=0.004&pan=0.0"
OPTS = dict(preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED, warp_batch=5)
MAX_DIFFERING = 0.05  # share of pixels one count apart (the rotation round trip)



def frames(path):
    r = open_reader(path)
    out = [tuple(np.array(p) for p in f) for f in r]
    r.close()
    return out


def assert_same_video(a_path, b_path):
    a, b = frames(a_path), frames(b_path)
    assert len(a) == len(b), (len(a), len(b))
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            d = np.abs(pa.astype(np.int16) - pb.astype(np.int16))
            assert d.max() <= 1, d.max()
            assert (d > 0).mean() <= MAX_DIFFERING, (d > 0).mean()


def render_both(tmp_path, src=SRC, **kw):
    two, one = str(tmp_path / "two.y4m"), str(tmp_path / "one.y4m")
    trender.render(src, two, trender.RenderOptions(**kw, **OPTS), device="cpu")
    trender.render(src, one, trender.RenderOptions(streaming=True, **kw, **OPTS),
                   device="cpu")
    return two, one


@pytest.mark.parametrize("kw", [
    dict(stabilise="smooth", stabilise_radius=8, analysis_mode="paired",
         analysis_chunk=5),
    dict(stabilise="smooth", stabilise_radius=8, analysis_mode="tracked"),
    dict(stabilise="smooth", stabilise_radius=0),  # degenerate window; auto = tracked
    dict(stabilise="fixed"),
    dict(stabilise="none"),
])
def test_streaming_matches_two_phase(tmp_path, kw):
    two, one = render_both(tmp_path, **kw)
    assert_same_video(two, one)
    if kw["stabilise"] == "none":  # identity: neither path tracks or saves
        assert not os.path.exists(trajectory_path(one))
        return
    t_two = Trajectory.load(trajectory_path(two))
    t_one = Trajectory.load(trajectory_path(one))
    assert t_one.num_frames == 24
    np.testing.assert_array_equal(t_one.params, t_two.params)


@pytest.mark.parametrize("kw", [
    dict(stabilise="smooth", stabilise_radius=8, analysis_mode="paired", analysis_chunk=5),
    dict(stabilise="smooth", stabilise_radius=8, analysis_mode="tracked"),
])
def test_streaming_frames_equal_two_phase_exactly(tmp_path, kw):
    """Savitzky-Golay streaming smooths the rotations the trajectory file
    gives back, on the host, as the two-phase encode does: the same
    corrections to the bit, so the same frames (a warp whose validity test
    is discontinuous, the per-tile mip at the source edge, would otherwise
    flip the odd pixel by tens of counts)."""
    two, one = render_both(tmp_path, **kw)
    for fa, fb in zip(frames(two), frames(one)):
        for pa, pb in zip(fa, fb):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("lock", [False, True])
def test_window_corrections_do_not_depend_on_the_window_length(lock):
    """Each frame's correction has the same bits from a streaming batch's
    window as from the whole clip's."""
    g = np.random.default_rng(3)
    t, radius = 40, 8
    meas = so3.exp(torch.from_numpy(g.standard_normal((t, 3)).astype(np.float32) * 0.05))
    fn = trender.make_window_corrections(radius, trender.RenderOptions(
        stabilise="smooth", horizon_lock=lock), None)
    clamp = lambda ks: meas[[min(max(k, 0), t - 1) for k in ks]]  # noqa: E731
    full = fn(clamp(range(-radius, t + radius)))
    for t0, n in ((0, 5), (3, 7), (16, 16), (35, 5)):
        part = fn(clamp(range(t0 - radius, t0 + n + radius)))
        assert torch.equal(part, full[t0:t0 + n])


def test_sg_conv_does_not_depend_on_the_block_length():
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.standard_normal((60, 9)).astype(np.float32))
    w = torch.from_numpy(savgol_weights(10))
    full = sg_conv(x, w)
    for a, b in ((0, 21), (5, 40), (17, 60)):
        assert torch.equal(sg_conv(x[a:b], w), full[a:b - 20])


def test_streaming_short_clip_shrinks_radius(tmp_path):
    """A clip shorter than the window: the radius clamps to T - 1 as in
    the two-phase compute_corrections."""
    src = "synthetic://shaky?w=256&h=192&n=6&seed=2&shake=0.004&pan=0.0"
    two, one = render_both(tmp_path, src, stabilise="smooth", stabilise_radius=30)
    assert_same_video(two, one)
    assert len(frames(one)) == 6


def test_streaming_respects_trim(tmp_path):
    two, one = render_both(tmp_path, start=0.2, end=0.6, stabilise="smooth",
                           stabilise_radius=4)
    assert_same_video(two, one)
    assert len(frames(one)) == 12  # 0.4 s at 30 fps


def test_streaming_kalman_end_to_end(tmp_path):
    """Fixed-lag Kalman: the same frame count and measured trajectory as
    the two-phase global RTS render; the smoothed corrections differ only
    within the fixed-lag bound (tests/test_torch_kalman.py)."""
    two, one = render_both(tmp_path, stabilise="smooth", smoother="kalman",
                           stabilise_radius=12)
    assert len(frames(one)) == len(frames(two)) == 24
    np.testing.assert_array_equal(Trajectory.load(trajectory_path(one)).params,
                                  Trajectory.load(trajectory_path(two)).params)


def replay_analyser(rotations: np.ndarray):
    """A stand-in for both of the ring's analysers that hands back the
    given (T, 3, 3) measured rotations through their interface: one a
    frame from ``push``, none from ``finish``."""
    r = torch.from_numpy(np.asarray(rotations, np.float32))

    class Replay:
        def __init__(self, meta, options, device, profiler=None):
            self.n = 0

        def push(self, frame):
            self.n += 1
            return r[self.n - 1:self.n]

        def finish(self):
            return r[:0]

    return Replay


@pytest.mark.parametrize("kw", [
    dict(stabilise_radius=8, analysis_mode="paired", analysis_chunk=5),
    dict(smoother="kalman", stabilise_radius=10, analysis_mode="tracked"),
])
def test_streaming_matches_jax(tmp_path, monkeypatch, kw):
    """The JAX package's ``render_streaming`` and the port's on one clip.
    The measured trajectories agree within ANGLE_TOL_DEG per frame (the
    JAX CPU path tracks with XLA LK and threefry RANSAC samples). With the
    JAX render's measured rotations replayed through the port's ring, its
    windows, radius and smoother (fixed-lag Kalman included) must give
    the JAX render's frames: within one count and at most MAX_DIFFERING
    of the pixels apart (the replay re-exponentiates the saved rotation
    vectors, and the JAX CPU warp rounds its own float map)."""
    jdest, tdest, rdest = (str(tmp_path / f"{n}.y4m") for n in ("jax", "port", "replay"))
    jrender(SRC, jdest, JRenderOptions(
        stabilise="smooth", streaming=True, warp_batch=5,
        preset=JCameraPreset(PRESET), **kw))
    opts = trender.RenderOptions(stabilise="smooth", streaming=True, **kw, **OPTS)
    trender.render(SRC, tdest, opts, device="cpu")
    jtraj = Trajectory.load(trajectory_path(jdest))
    ttraj = Trajectory.load(trajectory_path(tdest))
    assert ttraj.num_frames == jtraj.num_frames == 24
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG

    replay = replay_analyser(jtraj.rotations())
    monkeypatch.setattr(streaming, "Tracker", replay)
    monkeypatch.setattr(streaming, "PairTracker", replay)
    trender.render(SRC, rdest, opts, device="cpu")
    np.testing.assert_allclose(Trajectory.load(trajectory_path(rdest)).params,
                               jtraj.params, rtol=0, atol=1e-6)
    assert_same_video(rdest, jdest)


@pytest.mark.parametrize("kw,error,match", [
    (dict(analyse_only=True), ValueError, "single-pass"),
    (dict(encode_only=True), ValueError, "single-pass"),
    (dict(smoother="nope"), ValueError, "smoother"),
    # Fixed-lag Kalman below the filter's memory would seam at batch edges.
    (dict(smoother="kalman", stabilise_radius=4), ValueError, "stabilise-radius"),
])
def test_streaming_refuses(tmp_path, kw, error, match):
    with pytest.raises(error, match=match):
        render_streaming(SRC, str(tmp_path / "o.y4m"), trender.RenderOptions(
            stabilise="smooth", streaming=True, **kw, **OPTS), device="cpu")
    assert not os.path.exists(tmp_path / "o.y4m")
