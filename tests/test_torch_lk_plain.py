"""The port's plain pyramidal LK (``ops/lk.py::pyramidal_lk``) against
the JAX package's XLA ``pyramidal_lk`` on the CPU, and the rule that
picks it or kernel K2.

Both track float frames with the same window, gate and clamps; the
template's gradients and sums run in another order, so a point's flow
agrees to about 1e-5 px and a status bit can flip at the min-eigenvalue
gate."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.ops import lk as jlk
from video_annotator_tpu.ops.corners import detect_corners as jdetect_corners
from video_annotator_tpu_torch.ops import lk

FLOW_ATOL = 1e-3  # px, where both sides track
MIN_STATUS_AGREEMENT = 0.995


def texture(seed, w, h):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(max(h // 8, 2), max(w // 8, 2))).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)


def shifted(img, dx, dy):
    h, w = img.shape
    return cv2.warpAffine(img, np.float32([[1, 0, dx], [0, 1, dy]]), (w, h),
                          flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)


def corners(img, n=200):
    pts, valid = jdetect_corners(jnp.asarray(img), max_corners=n, min_distance=8, border=8)
    return np.array(pts), np.array(valid)


def assert_tracks_like_jax(got, want, min_tracked):
    (gp, gs), (wp, ws) = got, want
    gp, gs = np.asarray(gp), np.asarray(gs)
    wp, ws = np.asarray(wp), np.asarray(ws)
    assert gp.shape == wp.shape and gs.shape == ws.shape
    assert (gs == ws).mean() >= MIN_STATUS_AGREEMENT, (gs == ws).mean()
    both = gs & ws
    assert both.sum() >= min_tracked, both.sum()
    np.testing.assert_allclose(gp[both], wp[both], atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("w,h,levels", [(640, 480, 3), (320, 240, 3), (200, 150, 2)])
def test_pyramidal_lk_matches_jax(w, h, levels):
    """Every level cv2's reduction keeps is tracked, at any width."""
    a = texture(1, w, h)
    b = shifted(a, 3.25, -1.5)
    pts, valid = corners(a)
    assert lk.tracked_levels(h, w) == levels
    want = jlk.pyramidal_lk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts), jnp.asarray(valid))
    got = lk.pyramidal_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts),
                          torch.from_numpy(valid))
    assert_tracks_like_jax(got, want, min_tracked=80)
    moved = np.asarray(got[0]) - pts
    np.testing.assert_allclose(np.median(moved[np.asarray(got[1])], axis=0), [3.25, -1.5],
                               atol=0.05)


@pytest.mark.parametrize("levels,iters", [(1, 3), (2, 5), (3, 10)])
def test_pyramidal_lk_levels_and_iterations_match_jax(levels, iters):
    a = texture(2, 320, 240)
    b = shifted(a, -6.5, 4.25)
    pts, valid = corners(a)
    want = jlk.pyramidal_lk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                            jnp.asarray(valid), levels=levels, iters=iters)
    got = lk.pyramidal_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts),
                          torch.from_numpy(valid), levels=levels, iters=iters)
    assert_tracks_like_jax(got, want, min_tracked=60)


def test_pairs_axis_tracks_each_pair_as_alone():
    frames = [texture(3, 256, 192)]
    for dx, dy in [(2.5, 1.0), (-1.25, 3.5), (4.0, -2.0)]:
        frames.append(shifted(frames[-1], dx, dy))
    frames = np.stack(frames)
    pv = [corners(f, 100) for f in frames[:-1]]
    pts = np.stack([p for p, _ in pv])
    valid = np.stack([v for _, v in pv])
    t = torch.from_numpy
    got_p, got_s = lk.pyramidal_lk(t(frames[:-1]), t(frames[1:]), t(pts), t(valid))
    for i in range(3):
        one_p, one_s = lk.pyramidal_lk(t(frames[i]), t(frames[i + 1]), t(pts[i]), t(valid[i]))
        assert torch.equal(got_s[i], one_s)
        assert torch.equal(got_p[i], one_p)
        want = jlk.pyramidal_lk(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1]),
                                jnp.asarray(pts[i]), jnp.asarray(valid[i]))
        assert_tracks_like_jax((one_p, one_s), want, min_tracked=30)


def test_one_level_matches_jax_with_far_guesses():
    """``_lk_level`` alone, from guesses that push the windows against the
    frame's edges and past them: the window and patch clamps and the
    bounds check at full precision, point by point."""
    a = texture(4, 160, 120)
    b = shifted(a, 1.5, -0.75)
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform([0, 0], [160, 120], size=(150, 2)),
                          [[0.0, 0.0], [159.5, 119.5], [10.0, 110.0], [80.25, 0.5]]])
    pts = pts.astype(np.float32)
    guess = np.concatenate([rng.normal(size=(150, 2)) * 12.0,
                            [[-30.0, -30.0], [30.0, 30.0], [-200.0, 5.0], [0.0, 500.0]]])
    guess = guess.astype(np.float32)
    level = jax.vmap(lambda p, g: jlk._lk_level(jnp.asarray(a), jnp.asarray(b), p, g, 10))
    wf, wok = level(jnp.asarray(pts), jnp.asarray(guess))
    gf, gok = lk._lk_level(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts),
                           torch.from_numpy(guess), 10)
    assert_tracks_like_jax((gf, gok), (wf, wok), min_tracked=40)
    assert not np.asarray(gok)[-4:].any()  # the edge points and far guesses fail


def test_a_level_under_the_template_passes_the_guess_through():
    """Frames smaller than the 27-px template: flows stay at the guess
    and the status is the input mask, as in JAX."""
    a = texture(6, 40, 26)
    b = shifted(a, 1.0, 1.0)
    pts = np.asarray([[10.0, 10.0], [20.5, 12.25], [30.0, 5.0]], np.float32)
    valid = np.asarray([True, False, True])
    want = jlk.pyramidal_lk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts), jnp.asarray(valid))
    got = lk.pyramidal_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts),
                          torch.from_numpy(valid))
    assert lk.tracked_levels(26, 40) == 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), pts)


def test_failed_points_stay_finite_and_invalid():
    """Flat frames give singular gradient matrices: no NaN, status off."""
    a = np.full((96, 128), 77.0, np.float32)
    pts = np.asarray([[40.0, 40.0], [64.0, 48.0]], np.float32)
    got_p, got_s = lk.pyramidal_lk(torch.from_numpy(a), torch.from_numpy(a),
                                   torch.from_numpy(pts), torch.ones(2, dtype=torch.bool))
    assert torch.isfinite(got_p).all() and not got_s.any()


@pytest.mark.parametrize("device,want", [
    ("cpu", "plain"), ("cuda", "kernel"), ("cuda:0", "kernel"),
    (torch.device("cpu"), "plain"), (torch.device("cuda", 1), "kernel"),
])
def test_resolve_lk(device, want):
    """K2 on a CUDA device and the plain LK elsewhere, the JAX package's
    rule for its Pallas and XLA LK."""
    assert lk.resolve_lk(device) == want
