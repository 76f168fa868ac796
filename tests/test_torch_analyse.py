"""Corners, RANSAC and trajectory smoothing of the torch port held against
the JAX package on the CPU."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.ops.corners import detect_corners as jdetect_corners
from video_annotator_tpu.ops.corners import shi_tomasi_response as jresponse
from video_annotator_tpu.ops.ransac import estimate_rotation as jestimate
from video_annotator_tpu.pipeline.render import (
    RenderOptions as JRenderOptions,
    compute_corrections as jcompute_corrections,
    max_rotation_deg as jmax_rotation_deg,
    resolve_analysis_scale as jresolve_analysis_scale,
    tracking_border as jtracking_border,
    tracking_gates as jtracking_gates,
)
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu.smoothing.savgol import savgol_weights as jsavgol_weights
from video_annotator_tpu_torch.ops import corners as tcorners
from video_annotator_tpu_torch.ops import ransac as transac
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv

ROT_ATOL = 1e-5


def textured(seed, w=640, h=480):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h // 6, w // 6)).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    # Quarter-valued, like a box-downsampled uint8 frame on the main path.
    return np.round(img * 4) / 4


def test_shi_tomasi_response_matches_jax():
    img = textured(0).astype(np.float32)
    got = tcorners.shi_tomasi_response(torch.from_numpy(img)).numpy()
    want = np.asarray(jresponse(jnp.asarray(img)))
    # float32 rounding of the structure-tensor sums differs by a few ulp and
    # the min-eigenvalue subtraction cancels: hold to the response's scale.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("min_distance,border", [(15, 8), (40, 20), (7, 4)])
def test_detect_corners_exact(min_distance, border):
    imgs = np.stack([textured(1), textured(2)]).astype(np.float32)
    got_pts, got_valid = tcorners.detect_corners(
        torch.from_numpy(imgs), max_corners=200, min_distance=min_distance,
        border=border)
    for t in range(2):
        want_pts, want_valid = jdetect_corners(
            jnp.asarray(imgs[t]), max_corners=200, min_distance=min_distance,
            border=border)
        np.testing.assert_array_equal(got_valid[t].numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(got_pts[t].numpy(), np.asarray(want_pts))


def test_detect_corners_pads_when_cells_are_few():
    img = torch.from_numpy(textured(3, 96, 64).astype(np.float32))
    pts, valid = tcorners.detect_corners(img, max_corners=256, min_distance=30)
    want_pts, want_valid = jdetect_corners(jnp.asarray(img.numpy()), max_corners=256,
                                           min_distance=30)
    assert pts.shape == (256, 2) and valid.shape == (256,)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(want_pts))


def jax_hypothesis_pairs(valid: np.ndarray, key) -> np.ndarray:
    """The sample pairs ``ops/ransac.py:97-108`` draws from ``key``."""
    order = jnp.argsort(~jnp.asarray(valid), stable=True)
    v = jnp.maximum(jnp.sum(jnp.asarray(valid)), 2)

    def sample(k):
        k1, k2 = jax.random.split(k)
        i = jax.random.randint(k1, (), 0, v)
        j = jax.random.randint(k2, (), 0, v - 1)
        j = jnp.where(j >= i, j + 1, j)
        return jnp.stack([order[i], order[j]])

    return np.asarray(jax.vmap(sample)(jax.random.split(key, 100)))


def ray_pairs(seed, n=200, outliers=0.3, noise=2e-4):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * [0.6, 0.45, 0.0] + [0.0, 0.0, 1.0]
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.02, jnp.float32)))
    q = p @ R.T + rng.normal(size=p.shape) * noise
    bad = rng.random(n) < outliers
    q[bad] += rng.normal(size=(bad.sum(), 3)) * 0.05
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) > 0.1
    return p.astype(np.float32), q.astype(np.float32), valid, R


def test_estimate_rotation_matches_jax_with_injected_samples():
    threshold = 8.0 / 600.0
    batch = [ray_pairs(s) for s in range(4)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(4)]
    pairs = np.stack([jax_hypothesis_pairs(b[2], k) for b, k in zip(batch, keys)])
    got = transac.estimate_rotation(
        torch.from_numpy(np.stack([b[0] for b in batch])),
        torch.from_numpy(np.stack([b[1] for b in batch])),
        torch.from_numpy(np.stack([b[2] for b in batch])),
        threshold_rad=threshold, pairs=torch.from_numpy(pairs).to(torch.int64))
    for i, ((p, q, valid, R), k) in enumerate(zip(batch, keys)):
        want = jestimate(jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid), k,
                         threshold_rad=threshold)
        np.testing.assert_allclose(got.rotation[i].numpy(), np.asarray(want.rotation),
                                   atol=ROT_ATOL)
        assert int(got.num_inliers[i]) == int(want.num_inliers)
        np.testing.assert_array_equal(got.inliers[i].numpy(), np.asarray(want.inliers))
        np.testing.assert_allclose(got.rotation[i].numpy(), R, atol=1e-3)


def test_sample_pairs_are_distinct_valid_indices():
    valid = torch.rand((5, 200), generator=torch.Generator().manual_seed(0)) > 0.3
    valid[4] = False
    valid[4, :3] = True
    u = torch.rand((5, 100, 2), generator=torch.Generator().manual_seed(1))
    pairs = transac.sample_pairs(valid, u)
    assert (pairs[..., 0] != pairs[..., 1]).all()
    assert torch.gather(valid, 1, pairs.reshape(5, -1)).all()


def test_estimate_rotation_generator_is_deterministic():
    p, q, valid, _ = ray_pairs(9)
    args = (torch.from_numpy(p)[None], torch.from_numpy(q)[None],
            torch.from_numpy(valid)[None])
    a = transac.estimate_rotation(*args, generator=torch.Generator().manual_seed(3))
    b = transac.estimate_rotation(*args, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.rotation, b.rotation)


@pytest.mark.parametrize("radius", [0, 1, 5, 30])
def test_savgol_weights_and_conv(radius):
    np.testing.assert_array_equal(savgol_weights(radius), jsavgol_weights(radius))
    x = np.random.default_rng(radius).normal(size=(40 + 2 * radius, 9)).astype(np.float32)
    from video_annotator_tpu.smoothing.savgol import sg_conv as jsg_conv
    want = np.asarray(jsg_conv(jnp.asarray(x), jnp.asarray(jsavgol_weights(radius))))
    got = sg_conv(torch.from_numpy(x), torch.from_numpy(savgol_weights(radius))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def measured_trajectory(n=50, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    params = np.concatenate([0.002 * t, 0.01 * np.sin(t / 7.0), 0.005 * t], axis=1)
    return params + rng.normal(size=(n, 3)) * 0.004


@pytest.mark.parametrize("stabilise,radius,attitude", [
    ("smooth", 90, (0.0, 0.0, 0.0)),
    ("smooth", 5, (2.0, -1.0, 3.0)),
    ("fixed", 90, (0.0, 0.0, 0.0)),
    ("none", 90, (1.0, 0.0, 0.0)),
])
def test_compute_corrections_matches_jax(stabilise, radius, attitude):
    params = measured_trajectory()
    roll, pitch, yaw = attitude
    kw = dict(stabilise=stabilise, stabilise_radius=radius, roll=roll, pitch=pitch,
              yaw=yaw)
    want = jcompute_corrections(JTrajectory(params=params),
                                       JRenderOptions(**kw))
    got = trender.compute_corrections(Trajectory(params=params),
                                      trender.RenderOptions(**kw), device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    # arccos near the identity turns the 1e-5 matrix tolerance into ~0.01 deg.
    np.testing.assert_allclose(trender.max_rotation_deg(got),
                               jmax_rotation_deg(np.asarray(want)), atol=0.01)


def test_tracking_policies_match_jax():
    for w, h in [(640, 480), (1920, 1440), (3840, 2880), (7680, 4320), (96, 64)]:
        assert trender.tracking_gates(w) == jtracking_gates(w)
        assert trender.tracking_border(w, h) == jtracking_border(w, h)
        meta = trender.VideoMeta(w, h, 30)
        assert trender.resolve_analysis_scale(trender.RenderOptions(), meta) == \
            jresolve_analysis_scale(JRenderOptions(), meta)
    assert trender.resolve_analysis_scale(trender.RenderOptions(), None) == 1.0


def test_analysis_mode_resolution():
    o = trender.RenderOptions()
    assert trender.resolve_analysis_mode(o, "cuda") == "paired"
    assert trender.resolve_analysis_mode(o, "cpu") == "tracked"
    o.analysis_mode = "tracked"
    assert trender.resolve_analysis_mode(o, "cuda") == "tracked"
    o.analysis_mode = "paired"
    assert trender.resolve_analysis_mode(o, "cpu") == "paired"
    o.analysis_mode = "sideways"
    with pytest.raises(ValueError):
        trender.resolve_analysis_mode(o, "cpu")
