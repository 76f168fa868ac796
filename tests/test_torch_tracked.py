"""The torch port's sequential tracker (``--analysis-mode tracked``) held
against the JAX package's ``_make_tracker`` and tracked ``analyse`` on
the CPU.

Both packages track with their plain ``pyramidal_lk`` on the CPU (float
frames, every level cv2's reduction keeps), so flows agree to float32
rounding; rotations still differ where RANSAC sums in another order.

The ``k2_`` cases force the card's branch on the CPU (``k2_branch``):
K2's plain twin over uint8-staged levels, against JAX's float XLA LK, so
flows differ by hundredths of a pixel and rotations by hundredths of a
degree."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_analyse import jax_hypothesis_pairs
from test_torch_pipeline import ANGLE_TOL_DEG, PRESET, angle_deg, rms_vs_truth
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.io.synthetic import SyntheticSource as JSyntheticSource
from video_annotator_tpu.io.video import VideoMeta as JVideoMeta
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import _make_tracker
from video_annotator_tpu.pipeline.render import analyse as janalyse
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.pipeline import render as trender

FLOW_ATOL = 1e-3  # px: the same float LK, summed in another order
MIN_STATUS_AGREEMENT = 0.995
K2_FLOW_ATOL = 0.05  # px: uint8-staged plain K2 against JAX's float XLA LK
K2_MIN_STATUS_AGREEMENT = 0.97


@pytest.fixture
def k2_branch(monkeypatch):
    """The analysers' card branch on the CPU: the LK route
    (``lk_kernel.LKRoute``, which the trackers, the similarity analyser
    and the parallel pipeline's ``track_pairs`` all take) resolves to K2,
    whose plain twin runs on CPU tensors."""
    from video_annotator_tpu_torch.ops import lk_kernel

    monkeypatch.setattr(lk_kernel, "resolve_lk", lambda device: "kernel")


def luma_frames(src):
    return [np.array(planes[0]) for planes in JSyntheticSource.from_uri(src)]


def trackers(w, h, n):
    jtracker = _make_tracker(
        JVideoMeta(w, h, Fraction(30), n),
        JRenderOptions(stabilise="smooth", analysis_mode="tracked",
                       preset=JCameraPreset(PRESET)))
    ttracker = trender.Tracker(
        trender.VideoMeta(w, h, Fraction(30), n),
        trender.RenderOptions(stabilise="smooth", analysis_mode="tracked",
                              preset=CameraPreset(PRESET)), "cpu")
    return jtracker, ttracker


def check_tracked_step(refresh_age, flow_atol, min_status_agreement):
    """Detect on frame 0, one step into frame 1. RANSAC takes the samples
    JAX draws from its split key, given the port's status. Returns the
    port's tracker, its carry and the frames."""
    frames = luma_frames("synthetic://shaky?w=640&h=480&n=2&seed=1")
    (jdetect, jstep, _), tracker = trackers(640, 480, 2)
    jpts, jvalid, jstate = jdetect(jnp.asarray(frames[0]))
    pts, valid, state = tracker.detect(torch.from_numpy(frames[0]))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    key = jax.random.PRNGKey(trender.RANSAC_SEED)
    sub = jax.random.split(key)[1]
    drawn = []

    def injected(status, pair_index):
        drawn.append(pair_index)
        return torch.tensor(jax_hypothesis_pairs(status[0].numpy(), sub))[None]

    tracker.hypothesis_pairs = injected
    eye = torch.eye(3)
    age = trender.KEY_FRAME_MAX_AGE if refresh_age else 0
    got_pts, got_valid, delta, r, new_state = tracker.step(
        state, torch.from_numpy(frames[1]), pts, valid, eye, eye, 0, age)
    want_pts, want_valid, jdelta, jr, _, _ = jstep(
        jstate, jnp.asarray(frames[1]), jpts, jvalid, jnp.eye(3), jnp.eye(3), key,
        refresh_age=refresh_age)
    assert drawn == [0]
    assert angle_deg(delta.numpy()[None], np.asarray(jdelta)[None]).max() <= 0.01
    assert angle_deg(r.numpy()[None], np.asarray(jr)[None]).max() <= 0.01
    np.testing.assert_allclose(r.numpy(), delta.numpy(), atol=1e-6)  # r_acc = I
    want_pts, want_valid = np.asarray(want_pts), np.asarray(want_valid)
    got_pts, got_valid = got_pts.numpy(), got_valid.numpy()
    if refresh_age:  # key frame: fresh corners of frame 1, exactly
        np.testing.assert_array_equal(got_pts, want_pts)
        np.testing.assert_array_equal(got_valid, want_valid)
    else:
        assert (got_valid == want_valid).mean() >= min_status_agreement
        both = got_valid & want_valid
        assert both.sum() > 100
        np.testing.assert_allclose(got_pts[both], want_pts[both], atol=flow_atol)
    # The carry is frame 1 at tracking resolution (and K2's staged pyramid).
    np.testing.assert_array_equal(new_state[0].numpy(), frames[1].astype(np.float32))
    return tracker, new_state


@pytest.mark.parametrize("refresh_age", [False, True])
def test_tracked_step_matches_jax_track_step(refresh_age):
    tracker, state = check_tracked_step(refresh_age, FLOW_ATOL, MIN_STATUS_AGREEMENT)
    # The plain LK stages no pyramid (the JAX package's CPU carry is the
    # frame alone too).
    assert tracker.lk.name == "plain" and state[1] == ()


@pytest.mark.parametrize("refresh_age", [False, True])
def test_k2_tracked_step_matches_jax_track_step(k2_branch, refresh_age):
    tracker, state = check_tracked_step(refresh_age, K2_FLOW_ATOL, K2_MIN_STATUS_AGREEMENT)
    assert tracker.lk.name == "kernel" and state[1][0].shape[-2:] == (480 + 32, 640)


def test_tracked_step_refreshes_when_too_few_points_survive():
    """The key-frame rule's count branch: with every point invalid the
    step re-detects (one host read of the status count)."""
    frames = luma_frames("synthetic://shaky?w=320&h=240&n=2&seed=2")
    _, tracker = trackers(320, 240, 2)
    pts, valid, state = tracker.detect(torch.from_numpy(frames[0]))
    eye = torch.eye(3)
    got_pts, got_valid, delta, _, _ = tracker.step(
        state, torch.from_numpy(frames[1]), pts, torch.zeros_like(valid), eye, eye,
        0, 0)
    want_pts, want_valid = tracker.detect(torch.from_numpy(frames[1]))[:2]
    assert tracker.host_syncs == 1
    assert torch.equal(got_pts, want_pts) and torch.equal(got_valid, want_valid)
    assert torch.equal(delta, eye)  # no inliers: the previous delta carries


def test_tracked_analyse_matches_jax():
    src = "synthetic://shaky?w=640&h=480&n=24&seed=1"
    jtraj = janalyse(src, JRenderOptions(stabilise="smooth", analysis_mode="tracked",
                                         preset=JCameraPreset(PRESET)))
    # auto resolves to tracked on the CPU, as in the JAX package.
    ttraj = trender.analyse(src, trender.RenderOptions(
        stabilise="smooth", preset=CameraPreset(PRESET)), device="cpu")
    assert ttraj.num_frames == jtraj.num_frames == 24
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG
    t_rms = rms_vs_truth(ttraj.rotations(), src)
    j_rms = rms_vs_truth(jtraj.rotations(), src)
    assert t_rms <= j_rms + max(0.2 * j_rms, 0.01), (t_rms, j_rms)


@pytest.mark.parametrize("mode", ["tracked", "paired"])
def test_k2_analyse_matches_jax(k2_branch, mode):
    """The card's branch of both analysers (K3's staging and K2's twin,
    the tracker's packed carry, the paired path's pair staging) against
    JAX's CPU analyse."""
    src = "synthetic://shaky?w=640&h=480&n=24&seed=1"
    jtraj = janalyse(src, JRenderOptions(stabilise="smooth", analysis_mode=mode,
                                         preset=JCameraPreset(PRESET)))
    ttraj = trender.analyse(src, trender.RenderOptions(
        stabilise="smooth", analysis_mode=mode, preset=CameraPreset(PRESET)), device="cpu")
    assert ttraj.num_frames == jtraj.num_frames == 24
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG
    t_rms = rms_vs_truth(ttraj.rotations(), src)
    j_rms = rms_vs_truth(jtraj.rotations(), src)
    assert t_rms <= j_rms + max(0.2 * j_rms, 0.01), (t_rms, j_rms)


@pytest.mark.parametrize("mode,atol", [
    ("tracked", 0.0),  # frame by frame whatever the chunk: bit-identical
    ("paired", 1e-6),  # the chunk regroups the float32 prefix products
])
def test_analysis_chunk_does_not_change_the_trajectory(mode, atol):
    src = "synthetic://shaky?w=256&h=192&n=12&seed=6"
    trajs = [trender.analyse(src, trender.RenderOptions(
        stabilise="smooth", analysis_mode=mode, analysis_chunk=chunk,
        preset=CameraPreset(PRESET)), device="cpu") for chunk in (1, 7)]
    assert trajs[0].num_frames == 12
    np.testing.assert_allclose(trajs[0].params, trajs[1].params, rtol=0, atol=atol)


@pytest.mark.parametrize("w,h", [(320, 240), (200, 150)])
@pytest.mark.parametrize("mode", ["tracked", "paired"])
def test_small_frames_track_every_level_like_jax(mode, w, h):
    """Below K2's 256 x 112 staging rule the CPU analysers still track
    every level cv2's reduction keeps, as JAX's CPU path does: the
    trajectory moves, and it is JAX's."""
    src = f"synthetic://shaky?w={w}&h={h}&n=10&seed=3&shake=0.01"
    jtraj = janalyse(src, JRenderOptions(stabilise="smooth", analysis_mode=mode,
                                         preset=JCameraPreset(PRESET)))
    ttraj = trender.analyse(src, trender.RenderOptions(
        stabilise="smooth", analysis_mode=mode, preset=CameraPreset(PRESET)), device="cpu")
    assert ttraj.num_frames == jtraj.num_frames == 10
    eye = np.broadcast_to(np.eye(3), (10, 3, 3))
    assert angle_deg(ttraj.rotations(), eye)[1:].min() > 0.05  # not the identity
    assert angle_deg(ttraj.rotations(), jtraj.rotations()).max() <= ANGLE_TOL_DEG


@pytest.mark.parametrize("w,h", [(320, 240), (200, 150)])
def test_small_frames_vidstab_analyse_matches_jax(w, h):
    from video_annotator_tpu.models import similarity as jsimilarity
    from video_annotator_tpu_torch.models import similarity

    src = f"synthetic://shaky?w={w}&h={h}&n=10&seed=3&shake=0.01"
    jtraj = jsimilarity.analyse_similarity(src, JRenderOptions())
    ttraj = similarity.analyse_similarity(src, trender.RenderOptions(), device="cpu")
    assert ttraj.num_frames == jtraj.num_frames == 10
    assert np.abs(ttraj.params[1:, :2]).max(axis=1).min() > 0.05  # it moves every frame
    np.testing.assert_allclose(ttraj.params[:, :2], jtraj.params[:, :2], atol=1e-3)
    np.testing.assert_allclose(ttraj.params[:, 2:], jtraj.params[:, 2:], atol=1e-5)
