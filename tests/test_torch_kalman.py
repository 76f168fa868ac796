"""Kalman smoothing of the torch port, its corrections (global RTS and the
fixed-lag window form) and the RANSAC inlier fallback, held against the
JAX package on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.ops.ransac import RotationEstimate as JRotationEstimate
from video_annotator_tpu.ops.ransac import rotation_with_fallback as jfallback
from video_annotator_tpu.pipeline.render import (
    RenderOptions as JRenderOptions,
    compute_corrections as jcompute_corrections,
    make_window_corrections as jmake_window_corrections,
)
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu.smoothing import kalman as jkalman
from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.ops import ransac as transac
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory
from video_annotator_tpu_torch.smoothing import kalman

ATOL = 1e-5  # float32 filters over O(1) values; sums taken in another order


def walk(n, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=n) * scale) + 1.0).astype(np.float32)


@pytest.mark.parametrize("rts", [True, False])
@pytest.mark.parametrize("n", [1, 2, 60])
def test_kalman_filter_1d_matches_jax(rts, n):
    z = walk(n, seed=n)
    want = np.asarray(jkalman.kalman_filter_1d(jnp.asarray(z), rts=rts))
    got = kalman.kalman_filter_1d(torch.from_numpy(z), rts=rts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_kalman_filter_1d_columns_are_independent_filters():
    z = np.stack([walk(40, 1), walk(40, 2), walk(40, 3)], axis=1)
    got = kalman.kalman_filter_1d(torch.from_numpy(z), process_noise=1e-4).numpy()
    for i in range(3):
        want = np.asarray(jkalman.kalman_filter_1d(jnp.asarray(z[:, i]),
                                                    process_noise=1e-4))
        np.testing.assert_allclose(got[:, i], want, atol=ATOL)


def spin_across_pi(n=50, turns=1.3):
    """Rotation vectors whose angle grows past pi (and past 2 pi)."""
    t = np.linspace(0.0, 2 * np.pi * turns, n)
    return np.stack([np.full_like(t, 0.1), t, 0.2 * np.sin(t)], 1).astype(np.float32)


@pytest.mark.parametrize("turns", [0.7, 1.3, 2.6])
def test_unwrap_rotvecs_across_pi_matches_jax(turns):
    w = spin_across_pi(turns=turns)
    logs = np.asarray(jso3.log(jso3.exp(jnp.asarray(w))))
    assert np.abs(np.diff(logs, axis=0)).max() > 1.0  # the wrap is there
    want = np.asarray(jkalman._unwrap_rotvecs(jnp.asarray(logs)))
    got = kalman.unwrap_rotvecs(torch.tensor(logs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, w, atol=1e-4)  # the continuous branch


@pytest.mark.parametrize("rts", [True, False])
def test_smooth_rotations_kalman_matches_jax(rts):
    rng = np.random.default_rng(4)
    w = spin_across_pi(60) + rng.normal(size=(60, 3)).astype(np.float32) * 0.01
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    want = np.asarray(jkalman.smooth_rotations_kalman(jnp.asarray(R), rts=rts))
    got = kalman.smooth_rotations_kalman(torch.tensor(R), rts=rts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def measured_trajectory(n=70, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    params = np.concatenate([0.002 * t, 0.01 * np.sin(t / 7.0), 0.005 * t], axis=1)
    return params + rng.normal(size=(n, 3)) * 0.004


@pytest.mark.parametrize("attitude", [(0.0, 0.0, 0.0), (2.0, -1.0, 3.0)])
def test_compute_corrections_kalman_matches_jax(attitude):
    params = measured_trajectory()
    roll, pitch, yaw = attitude
    kw = dict(stabilise="smooth", smoother="kalman", roll=roll, pitch=pitch, yaw=yaw)
    want = jcompute_corrections(JTrajectory(params=params), JRenderOptions(**kw))
    got = trender.compute_corrections(Trajectory(params=params),
                                      trender.RenderOptions(**kw), device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("radius", [10, 25])
def test_window_corrections_kalman_matches_jax(radius):
    """The fixed-lag form, on clamp-replicated windows as streaming builds
    them, batch by batch."""
    rots = np.asarray(jso3.exp(jnp.asarray(measured_trajectory(), jnp.float32)))
    t_len, batch = rots.shape[0], 16
    kw = dict(stabilise="smooth", smoother="kalman", stabilise_radius=radius)
    jfn = jmake_window_corrections(radius, JRenderOptions(**kw), None)
    tfn = trender.make_window_corrections(radius, trender.RenderOptions(**kw), None)
    for t0 in range(0, t_len, batch):
        idx = [min(max(k, 0), t_len - 1) for k in range(t0 - radius, t0 + batch + radius)]
        want = np.asarray(jfn(jnp.asarray(rots[idx])))
        got = tfn(torch.from_numpy(rots[idx])).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_fixed_lag_stays_near_global_rts():
    """Away from the clip's ends the fixed-lag window form agrees with the
    global RTS smoother to well under the filter's noise (the bound the
    JAX package's tests/test_streaming.py pins)."""
    rng = np.random.default_rng(3)
    t_len, radius, batch = 260, 60, 16
    rates = rng.normal(0, 0.01, (t_len, 3))
    rates[:, 1] += 0.002
    w = np.cumsum(rates, 0)
    opts = trender.RenderOptions(stabilise="smooth", smoother="kalman",
                                 stabilise_radius=radius)
    glob = trender.compute_corrections(Trajectory(params=w), opts, device="cpu")
    rots = so3.exp(torch.from_numpy(w.astype(np.float32)))
    fn = trender.make_window_corrections(radius, opts, None)
    outs = np.zeros_like(glob)
    for t0 in range(0, t_len, batch):
        idx = [min(max(k, 0), t_len - 1) for k in range(t0 - radius, t0 + batch + radius)]
        n = min(batch, t_len - t0)
        outs[t0:t0 + n] = fn(rots[idx]).numpy()[:n]
    rel = so3.matmul(torch.from_numpy(glob), so3.transpose(torch.from_numpy(outs)))
    deg = np.degrees(so3.log(rel).norm(dim=-1).numpy())
    assert deg[radius:-radius].max() < 0.06, deg[radius:-radius].max()
    assert deg.max() < 2.5


def test_rotation_with_fallback_matches_jax():
    rng = np.random.default_rng(8)
    rot = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=(5, 3)) * 0.1, jnp.float32)))
    prev = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)))
    counts = np.array([0, 39, 40, 41, 200], np.int32)
    got = transac.rotation_with_fallback(
        transac.RotationEstimate(rotation=torch.tensor(rot),
                                 num_inliers=torch.from_numpy(counts),
                                 inliers=torch.zeros((5, 1), dtype=torch.bool)),
        torch.tensor(prev)[None], min_inliers=40).numpy()
    for i in range(5):
        want = jfallback(JRotationEstimate(rotation=jnp.asarray(rot[i]),
                                           num_inliers=jnp.int32(counts[i]),
                                           inliers=jnp.zeros((1,), bool)),
                         jnp.asarray(prev), min_inliers=40)
        np.testing.assert_array_equal(got[i], np.asarray(want))
    np.testing.assert_array_equal(got[:2], np.stack([prev, prev]))
    np.testing.assert_array_equal(got[2:], rot[2:])
