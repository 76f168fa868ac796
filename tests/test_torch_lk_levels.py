"""The analysers' LK on a card tracks every level cv2's rule keeps: K2 on
the levels it can stage, the plain level (``ops/lk.py::_lk_level``) on the
others. They stage with ``plain_levels=True`` (a mixed pyramid of uint8
and float levels), which ``ops/lk_kernel.py::pyramidal_lk_{packed,pairs}``
track; the default staging gives ``None`` for the small levels, which the
same loops skip, as the JAX Pallas loops do (the K2-only loop).

On the CPU the mixed loop runs K2's plain twin and the plain level. It is
held against the same composition of JAX pieces (the XLA LK's level, then
the Pallas level in interpret mode, the flow carried), and against the
JAX package's XLA ``pyramidal_lk`` on the quality clip's 13.4 px step,
which the K2-only loop, like the JAX Pallas loop, loses."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.ops import lk as jlk
from video_annotator_tpu.ops.lk_pallas import PGROUP, _lk_level_pallas, lk_pack_pyramid
from video_annotator_tpu_torch.io.synthetic import SyntheticSource, render_frame
from video_annotator_tpu_torch.ops import lk, lk_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.pipeline import render as trender

QUALITY_CLIP = "synthetic://shaky?w=640&h=480&n=150&seed=11&shake=0.008&pan=0.002"
STEP = 97  # frames 97 -> 98 of the clip move 13.4 px
FLOW_ATOL = 1e-3  # px: the mixed loop against the JAX composition
XLA_ATOL = 0.1  # px: the mixed loop against JAX's XLA pyramidal_lk


def clip_frames(t: int):
    """Frames t and t + 1 of the quality tool's clip, float32 luma."""
    cfg = SyntheticSource.from_uri(QUALITY_CLIP).config
    cam, rots = cfg.camera(), torch.from_numpy(cfg.rotations())
    return [render_frame(cam, rots[i])[0].to(torch.float32).numpy() for i in (t, t + 1)]


def tracker_corners(img: np.ndarray):
    """The tracked analyser's corners on a 640x480 frame."""
    h, w = img.shape
    min_distance, _, _ = trender.tracking_gates(w)
    pts, valid = detect_corners(torch.from_numpy(img), max_corners=trender.MAX_CORNERS,
                                min_distance=min_distance,
                                border=trender.tracking_border(w, h))
    return pts, valid


@pytest.fixture(scope="module")
def step():
    a, b = clip_frames(STEP)
    pts, valid = tracker_corners(a)
    return a, b, pts, valid


def jax_composition(a, b, pts, valid, iters=lk.DEF_ITERS):
    """JAX's XLA level where the Pallas window cannot stage a level, then
    ``_lk_level_pallas`` (interpret mode) on the staged levels, coarse to
    fine, the flow carried; the Pallas loop's final bounds check."""
    h, w = a.shape
    n = pts.shape[0]
    pts_p = jnp.pad(jnp.asarray(pts), ((0, -n % PGROUP), (0, 0)), constant_values=4.0 * 10)
    pyr_a = jlk.build_pyramid(jnp.asarray(a), 3)
    pyr_b = jlk.build_pyramid(jnp.asarray(b), 3)
    packed_a = lk_pack_pyramid(jnp.asarray(a), 3, interpret=True)
    packed_b = lk_pack_pyramid(jnp.asarray(b), 3, interpret=True)
    flow = pts_p * 0.0
    status = jnp.asarray(valid)
    for lvl in (2, 1, 0):
        scale = 2.0 ** lvl
        if packed_a[lvl] is None:
            f, ok = jax.vmap(lambda p, g: jlk._lk_level(pyr_a[lvl], pyr_b[lvl], p, g, iters))(
                pts_p / scale, flow / scale)
            flow = f * scale
        else:
            words = packed_a[lvl]
            vx, vy, ok = _lk_level_pallas(words, packed_b[lvl], pts_p / scale, flow / scale,
                                          (words.shape[0], words.shape[1]), iters, True)
            flow = jnp.stack([vx, vy], axis=-1) * scale
        status = status & ok[:n]
    new = jnp.asarray(pts) + flow[:n]
    half = 10.0
    inb = ((pts[:, 0] >= half) & (pts[:, 0] < w - half) & (pts[:, 1] >= half)
           & (pts[:, 1] < h - half) & (new[:, 0] >= half) & (new[:, 0] < w - half)
           & (new[:, 1] >= half) & (new[:, 1] < h - half))
    return np.asarray(new), np.asarray(status & inb)


def mixed(frame):
    return lk_kernel.stage_pyramid(torch.as_tensor(frame), plain_levels=True)


def test_mixed_levels_at_640x480():
    """At 640x480 levels 0 and 1 are staged and level 2 (160x120) is not."""
    levels = mixed(torch.zeros((480, 640)))
    assert [lv.dtype for lv in levels] == [torch.uint8, torch.uint8, torch.float32]
    assert tuple(levels[2].shape) == (120, 160)
    assert [s is None for s in lk_kernel.stage_pyramid(torch.zeros((480, 640)))] == [
        False, False, True]


def test_mixed_loop_matches_jax_composition(step):
    a, b, pts, valid = step
    before = lk_kernel.PLAIN_LEVEL.launches
    got_p, got_s = lk_kernel.pyramidal_lk_packed(mixed(a), mixed(b), a.shape, pts, valid)
    assert lk_kernel.PLAIN_LEVEL.launches == before + 1
    want_p, want_s = jax_composition(a, b, pts.numpy(), valid.numpy())
    got_p, got_s = got_p.numpy(), got_s.numpy()
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s.sum() > 100, got_s.sum()
    np.testing.assert_allclose(got_p[got_s], want_p[got_s], atol=FLOW_ATOL, rtol=0)


def xla_tracks(a, b, pts, valid):
    p, s = jlk.pyramidal_lk(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts.numpy()),
                            jnp.asarray(valid.numpy()))
    return np.asarray(p), np.asarray(s)


def test_mixed_loop_tracks_the_large_step_as_xla(step):
    """Within 0.1 px of the XLA LK on every point both mark tracked; the
    K2-only loop (two levels here) is pixels off on the same points."""
    a, b, pts, valid = step
    want_p, want_s = xla_tracks(a, b, pts, valid)
    mixed_p, mixed_s = lk_kernel.pyramidal_lk_packed(mixed(a), mixed(b), a.shape, pts, valid)
    k2_p, k2_s = lk_kernel.pyramidal_lk_packed(
        lk_kernel.stage_pyramid(torch.from_numpy(a)),
        lk_kernel.stage_pyramid(torch.from_numpy(b)), a.shape, pts, valid)
    both = mixed_s.numpy() & want_s
    assert both.sum() > 100, both.sum()
    err = np.abs(mixed_p.numpy()[both] - want_p[both]).max()
    assert err <= XLA_ATOL, err
    k2_both = k2_s.numpy() & want_s
    k2_err = np.abs(k2_p.numpy()[k2_both] - want_p[k2_both]).max(axis=1)
    assert k2_err.max() > 5.0, k2_err.max()


def test_mixed_pairs_match_per_frame_form(step):
    """The pairs form over the pair axis gives the per-frame form's tracks,
    one plain level call for all pairs."""
    a, b, pts, valid = step
    frames = torch.from_numpy(np.stack([a, b, a]))
    points = torch.stack([pts, pts])
    valids = torch.stack([valid, valid])
    before = lk_kernel.PLAIN_LEVEL.launches
    pair_p, pair_s = lk_kernel.pyramidal_lk_pairs(
        lk_kernel.stage_pyramid_pairs(frames, plain_levels=True), (480, 640), points, valids,
        iters=8)
    assert lk_kernel.PLAIN_LEVEL.launches == before + 1
    staged = [mixed(f) for f in frames]
    for p in range(2):
        one_p, one_s = lk_kernel.pyramidal_lk_packed(staged[p], staged[p + 1], (480, 640),
                                                      points[p], valids[p], iters=8)
        assert torch.equal(pair_s[p], one_s)
        assert float((pair_p[p][one_s] - one_p[one_s]).abs().max()) <= 1e-4


def test_mixed_loop_is_k2_where_every_level_stages():
    """Where K2 stages every tracked level (1024x512: 256x128 at level 2)
    the mixed staging is the default one, and the loop runs no plain
    level."""
    rng = np.random.default_rng(5)
    small = rng.uniform(0, 255, size=(64, 128)).astype(np.float32)
    a = torch.nn.functional.interpolate(torch.from_numpy(small)[None, None], size=(512, 1024),
                                        mode="bilinear", align_corners=False)[0, 0]
    b = torch.roll(a, shifts=(3, -5), dims=(0, 1))
    pts, valid = detect_corners(a, max_corners=64, min_distance=24, border=24)
    before = lk_kernel.PLAIN_LEVEL.launches
    staged = mixed(a), mixed(b)
    assert [lv.dtype for lv in staged[0]] == [torch.uint8] * 3
    got = lk_kernel.pyramidal_lk_packed(*staged, (512, 1024), pts, valid)
    assert lk_kernel.PLAIN_LEVEL.launches == before
    want = lk_kernel.pyramidal_lk_packed(lk_kernel.stage_pyramid(a), lk_kernel.stage_pyramid(b),
                                         (512, 1024), pts, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 20
