"""The torch port's 2D filter families (vidstab, deshake) on the CPU, held
against the JAX package: the similarity algebra and fit, phase
correlation, the corrections, the plain warps, the analysers'
trajectories on a synthetic clip, and ``encode_2d`` driven by a
JAX-written trajectory.

Both packages compute in float32; where the order of operations differs
the tolerance says by how much. Both analysers track with their plain
``pyramidal_lk`` on the CPU (float frames), so the similarity
trajectories differ by float32 rounding, accumulated over the clip; on
the card's branch (``k2_branch``: K2's plain twin over uint8-staged
frames) by hundredths of a pixel per frame."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import assert_u8_close, read_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from test_torch_tracked import k2_branch  # noqa: F401 (fixture)
from video_annotator_tpu.models import FILTER_ALIASES as JFILTER_ALIASES
from video_annotator_tpu.models import deshake as jdeshake
from video_annotator_tpu.models import similarity as jsimilarity
from video_annotator_tpu.ops import affine as jaffine
from video_annotator_tpu.ops.phasecorr import phase_correlate as jphase_correlate
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import encode_2d as jencode_2d
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu_torch.models import FILTER_ALIASES, deshake, similarity
from video_annotator_tpu_torch.ops import affine
from video_annotator_tpu_torch.ops.phasecorr import phase_correlate
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory

PARAM_ATOL = 1e-4  # float32 sums in another order, coordinates up to 640
WARP_ATOL = 0.02  # counts: 1e-5 px of coordinate error times a 255 step


def rng_params(n, seed, shift=6.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=n) * shift, rng.normal(size=n) * shift,
                     rng.normal(size=n) * 0.03, rng.normal(size=n) * 0.02],
                    axis=-1).astype(np.float32)


def texture(h, w, seed):
    """A smooth integer-valued float frame with broadband content."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h // 4 + 2, w // 4 + 2))
    img = np.kron(img, np.ones((4, 4)))[:h, :w]
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for axis in (0, 1):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), axis, img)
    return np.round(img).astype(np.float32)


def test_filter_aliases_match_jax():
    assert FILTER_ALIASES == JFILTER_ALIASES


@pytest.mark.parametrize("outliers", [0, 12])
def test_fit_similarity_matches_jax(outliers):
    rng = np.random.default_rng(outliers + 1)
    prev = rng.uniform(20, 620, size=(200, 2)).astype(np.float32)
    true = np.array([3.5, -2.25, 0.02, 0.01], np.float32)
    s, ca, sa = np.exp(true[3]), np.cos(true[2]), np.sin(true[2])
    curr = np.stack([s * (ca * prev[:, 0] - sa * prev[:, 1]) + true[0],
                     s * (sa * prev[:, 0] + ca * prev[:, 1]) + true[1]], axis=-1)
    curr = (curr + rng.normal(size=curr.shape) * 0.05).astype(np.float32)
    # Gross outliers on both sides; IRLS cuts them at 4 px.
    curr[:outliers] += (rng.uniform(10, 60, size=(outliers, 2))
                        * rng.choice([-1, 1], size=(outliers, 2))).astype(np.float32)
    valid = rng.uniform(size=200) > 0.1
    want, want_n = jaffine.fit_similarity(jnp.asarray(prev), jnp.asarray(curr),
                                          jnp.asarray(valid))
    got, got_n = affine.fit_similarity(torch.from_numpy(prev), torch.from_numpy(curr),
                                       torch.from_numpy(valid))
    assert got_n.dtype == torch.int32
    assert int(got_n) == int(want_n) >= (200 - outliers) * 0.8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PARAM_ATOL)
    np.testing.assert_allclose(got.numpy(), true, atol=0.05)


def test_fit_similarity_without_valid_points_stays_finite():
    pts = torch.zeros((8, 2))
    got, n = affine.fit_similarity(pts, pts, torch.zeros(8, dtype=torch.bool))
    want, want_n = jaffine.fit_similarity(jnp.zeros((8, 2)), jnp.zeros((8, 2)),
                                          jnp.zeros(8, bool))
    assert int(n) == int(want_n) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("op", ["compose", "invert", "matrix", "roundtrip"])
def test_similarity_algebra_matches_jax(op):
    a, b = rng_params(16, 1), rng_params(16, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if op == "compose":
        want = jax.vmap(jaffine.compose_similarity)(jnp.asarray(a), jnp.asarray(b))
        got = affine.compose_similarity(ta, tb)
    elif op == "invert":
        want = jax.vmap(jaffine.invert_similarity)(jnp.asarray(a))
        got = affine.invert_similarity(ta)
    elif op == "matrix":
        want = jax.vmap(jaffine.similarity_matrix)(jnp.asarray(a))
        got = affine.similarity_matrix(ta)
        assert got.shape == (16, 3, 3)
        # one (4,) vector gives one (3, 3) matrix
        np.testing.assert_allclose(affine.similarity_matrix(ta[3]).numpy(),
                                   got[3].numpy(), atol=0)
    else:  # a o a^-1 is the identity
        want = np.zeros((16, 4), np.float32)
        got = affine.compose_similarity(ta, affine.invert_similarity(ta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("out_size", [None, (80, 120)])
def test_warp_similarity_matches_jax(out_size):
    img = texture(64, 96, 3)
    params = np.array([2.5, -1.75, 0.03, -0.02], np.float32)
    want = jaffine.warp_similarity(jnp.asarray(img), jnp.asarray(params),
                                   out_size=out_size)
    got = affine.warp_similarity(torch.from_numpy(img), torch.from_numpy(params),
                                 out_size=out_size)
    assert got.shape == want.shape == (out_size or img.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WARP_ATOL)


def test_warp_similarity_refuses_other_resamplers():
    """Refused until the 4-tap resamplers were ported: bicubic now
    resamples as the JAX function does."""
    img = texture(64, 96, 7)
    params = np.array([-1.25, 2.5, -0.02, 0.015], np.float32)
    want = jaffine.warp_similarity(jnp.asarray(img), jnp.asarray(params), interp="bicubic")
    got = affine.warp_similarity(torch.from_numpy(img), torch.from_numpy(params),
                                 interp="bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WARP_ATOL)


@pytest.mark.parametrize("shift", [(5, -3), (0, 0), (-11, 7)])
def test_phase_correlate_shift_matches_jax(shift):
    base = texture(96, 128, 4)
    moved = np.roll(base, (shift[1], shift[0]), axis=(0, 1))
    want_d, want_c = jphase_correlate(jnp.asarray(moved), jnp.asarray(base))
    got_d, got_c = phase_correlate(torch.from_numpy(moved), torch.from_numpy(base))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-2)
    np.testing.assert_allclose(got_d.numpy(), shift, atol=0.2)
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=1e-3)
    assert float(got_c) > deshake.CONF_MIN


@pytest.mark.parametrize("whiten_reg", [1.0, 0.0])
def test_phase_correlate_confidence_of_unrelated_frames_matches_jax(whiten_reg):
    a, b = texture(96, 128, 5), texture(96, 128, 6)
    _, want_c = jphase_correlate(jnp.asarray(a), jnp.asarray(b), whiten_reg=whiten_reg)
    _, got_c = phase_correlate(torch.from_numpy(a), torch.from_numpy(b),
                               whiten_reg=whiten_reg)
    # The peak of a noise surface is one of many near-equal bins; its
    # height, not its place, is what both must agree on.
    np.testing.assert_allclose(float(got_c), float(want_c), rtol=2e-2)


def trajectories(kind, t, seed, width=320, height=240):
    dim = {"similarity": 4, "translation": 2}[kind]
    rng = np.random.default_rng(seed)
    params = np.cumsum(rng.normal(size=(t, dim)), axis=0) * \
        np.array([2.0, 2.0, 0.004, 0.003])[:dim]
    kw = dict(params=params, kind=kind, width=width, height=height, source="x.y4m")
    return JTrajectory(**kw), Trajectory(**kw)


CORRECTION_CASES = [
    dict(stabilise="smooth", stabilise_radius=4),
    dict(stabilise="smooth", stabilise_radius=90),  # clamps to t - 1
    dict(stabilise="smooth", stabilise_radius=4, stabilise_buffer=0.0),
    dict(stabilise="fixed"),
    dict(stabilise="none"),
]


@pytest.mark.parametrize("kw", CORRECTION_CASES)
def test_similarity_corrections_match_jax(kw):
    jtraj, ttraj = trajectories("similarity", 12, 7)
    want = jsimilarity.similarity_corrections(jtraj, JRenderOptions(**kw))
    got = similarity.similarity_corrections(ttraj, trender.RenderOptions(**kw))
    assert got.shape == want.shape == (12, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PARAM_ATOL)


@pytest.mark.parametrize("kw", CORRECTION_CASES)
def test_deshake_corrections_match_jax(kw):
    jtraj, ttraj = trajectories("translation", 12, 8)
    want = jdeshake.deshake_corrections(jtraj, JRenderOptions(**kw))
    got = deshake.deshake_corrections(ttraj, trender.RenderOptions(**kw))
    assert got.shape == want.shape == (12, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind,dim", [("similarity", 4), ("translation", 2)])
def test_empty_trajectory_gives_empty_corrections(kind, dim):
    traj = Trajectory(params=np.zeros((0, dim)), kind=kind, width=64, height=48)
    fn = (similarity.similarity_corrections if kind == "similarity"
          else deshake.deshake_corrections)
    assert fn(traj, trender.RenderOptions(stabilise="smooth")).shape == (0, dim)


def yuv_float(h, w, seed):
    return (texture(h, w, seed), texture(h // 2, w // 2, seed + 1),
            texture(h // 2, w // 2, seed + 2))


@pytest.mark.parametrize("blur_edges", [True, False])
@pytest.mark.parametrize("offset", [(3.25, -2.5), (-7.75, 5.0), (0.0, 0.0)])
def test_warp_frame_deshake_matches_jax(blur_edges, offset):
    planes = yuv_float(64, 96, 9)
    off = np.asarray(offset, np.float32)
    want = jdeshake.warp_frame_deshake(*(jnp.asarray(p) for p in planes),
                                       jnp.asarray(off), blur_edges=blur_edges)
    got = deshake.warp_frame_deshake(*(torch.from_numpy(p) for p in planes),
                                     torch.from_numpy(off), blur_edges=blur_edges)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=WARP_ATOL)


def test_warp_frame_deshake_fills_revealed_edges_with_blur():
    y, u, v = (torch.from_numpy(p) for p in yuv_float(64, 96, 10))
    off = torch.tensor([12.0, 0.0])
    filled = deshake.warp_frame_deshake(y, u, v, off, blur_edges=True)[0]
    black = deshake.warp_frame_deshake(y, u, v, off, blur_edges=False)[0]
    assert float(black[:, -11:].abs().max()) == 0.0
    assert float(filled[:, -11:].min()) > 0.0
    assert torch.equal(filled[:, :-12], black[:, :-12])


@pytest.mark.parametrize("out_size", [None, (96, 144)])
def test_warp_frame_similarity_matches_jax(out_size):
    planes = yuv_float(64, 96, 11)
    params = np.array([1.5, -2.25, 0.02, 0.03], np.float32)
    want = jsimilarity.warp_frame_similarity(*(jnp.asarray(p) for p in planes),
                                             jnp.asarray(params), out_size=out_size)
    got = similarity.warp_frame_similarity(*(torch.from_numpy(p) for p in planes),
                                           torch.from_numpy(params), out_size=out_size)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=WARP_ATOL)


@pytest.mark.parametrize("out_size", [None, (96, 144)])
def test_similarity_warper_matches_the_plain_similarity_warp(out_size):
    """The identity-camera trick: K1's plain version over f = 1 (luma) and
    f = 0.5 (chroma) pinhole cameras with ``similarity_matrix`` samples
    where ``warp_similarity`` does; within one count after rounding."""
    planes = yuv_float(64, 96, 12)
    params = rng_params(3, 13, shift=3.0)
    params[:, 3] += 0.0 if out_size is None else -np.log(1.5)
    warper = similarity.SimilarityWarper(96, 64, out_size=out_size)
    mats = torch.from_numpy(similarity.SimilarityWarper.matrices(params))
    assert mats.shape == (3, 3, 3) and mats.dtype == torch.float32
    u8 = [torch.from_numpy(p).to(torch.uint8) for p in planes]
    batch = warper.warp_yuv_batch([u8[0]] * 3, [u8[1]] * 3, [u8[2]] * 3, mats)
    for t in range(3):
        want = jsimilarity.warp_frame_similarity(
            *(jnp.asarray(p) for p in planes), jnp.asarray(params[t]),
            out_size=out_size)
        single = warper.warp_yuv(*u8, mats[t])
        for g, b, w in zip(single, batch[t], want):
            assert g.dtype == torch.uint8 and torch.equal(g, b)
            assert_u8_close(g.numpy(), np.clip(np.round(np.asarray(w)), 0, 255))


def test_similarity_warper_refuses_other_resamplers():
    """Refused until K1's 4-tap mode was ported: lanczos now warps as JAX
    ``warp_frame_similarity`` does (the mode's plain version here)."""
    planes = [texture(64, 96, 8), texture(32, 48, 9), texture(32, 48, 10)]
    params = np.array([2.0, -1.5, 0.01, -0.01], np.float32)
    warper = similarity.SimilarityWarper(96, 64, interp="lanczos")
    got = warper.warp_yuv(*(torch.from_numpy(p).to(torch.uint8) for p in planes),
                          torch.from_numpy(similarity.SimilarityWarper.matrices(params[None])[0]))
    want = jsimilarity.warp_frame_similarity(*(jnp.asarray(p) for p in planes),
                                             jnp.asarray(params), interp="lanczos")
    for g, w in zip(got, want):
        assert_u8_close(g.numpy(), np.clip(np.round(np.asarray(w)), 0, 255))


CLIP = "synthetic://shaky?w=640&h=480&n=8&seed=3"


@pytest.mark.parametrize("scale", ["auto", 0.5])
def test_analyse_similarity_matches_jax(scale):
    jtraj = jsimilarity.analyse_similarity(CLIP, JRenderOptions(analysis_scale=scale))
    ttraj = similarity.analyse_similarity(
        CLIP, trender.RenderOptions(analysis_scale=scale), device="cpu")
    assert (ttraj.kind, ttraj.num_frames) == (jtraj.kind, jtraj.num_frames) == \
        ("similarity", 8)
    assert (ttraj.width, ttraj.height, ttraj.fps) == (640, 480, jtraj.fps)
    assert ttraj.params.dtype == np.float64 and np.all(ttraj.params[0] == 0)
    # The same float LK summed in another order, accumulated over 7 pairs.
    np.testing.assert_allclose(ttraj.params[:, :2], jtraj.params[:, :2], atol=1e-3)
    np.testing.assert_allclose(ttraj.params[:, 2:], jtraj.params[:, 2:], atol=1e-5)
    assert np.abs(ttraj.params[-1, :2]).max() > 1.0  # the clip does move


@pytest.mark.parametrize("scale", ["auto", 0.5])
def test_k2_analyse_similarity_matches_jax(k2_branch, scale):
    """The card's branch: K3-staged pyramids carried frame to frame into
    K2's per-frame form."""
    jtraj = jsimilarity.analyse_similarity(CLIP, JRenderOptions(analysis_scale=scale))
    ttraj = similarity.analyse_similarity(
        CLIP, trender.RenderOptions(analysis_scale=scale), device="cpu")
    assert (ttraj.kind, ttraj.num_frames) == (jtraj.kind, jtraj.num_frames) == \
        ("similarity", 8)
    # uint8-staged plain K2 against JAX's float XLA LK: hundredths of a
    # pixel per fitted frame pair, accumulated over 7 pairs.
    np.testing.assert_allclose(ttraj.params[:, :2], jtraj.params[:, :2], atol=0.15)
    np.testing.assert_allclose(ttraj.params[:, 2:], jtraj.params[:, 2:], atol=5e-4)
    assert np.abs(ttraj.params[-1, :2]).max() > 1.0


@pytest.mark.parametrize("scale", ["auto", 0.5])
def test_analyse_deshake_matches_jax(scale):
    src = "synthetic://shaky?w=320&h=240&n=8&seed=4"
    jtraj = jdeshake.analyse_deshake(src, JRenderOptions(analysis_scale=scale))
    ttraj = deshake.analyse_deshake(src, trender.RenderOptions(analysis_scale=scale),
                                    device="cpu")
    assert (ttraj.kind, ttraj.num_frames) == (jtraj.kind, jtraj.num_frames) == \
        ("translation", 8)
    assert ttraj.params.dtype == np.float64 and ttraj.params.shape == (8, 2)
    # The same float32 FFTs from two libraries: the subpixel peak moves by
    # about 1e-5 px per pair.
    np.testing.assert_allclose(ttraj.params, jtraj.params, atol=1e-3)
    assert np.abs(ttraj.params[-1]).max() > 0.5


def test_analysers_honour_the_trim_window():
    src = "synthetic://shaky?w=320&h=240&n=12&seed=4"
    o = dict(start=0.2, duration=0.1)  # frames 6, 7, 8
    for fn in (similarity.analyse_similarity, deshake.analyse_deshake):
        traj = fn(src, trender.RenderOptions(**o), device="cpu")
        assert traj.num_frames == 3 and np.all(traj.params[0] == 0)


@pytest.mark.parametrize("kind", ["similarity", "translation"])
def test_2d_trajectory_files_interchange(tmp_path, kind):
    jtraj, ttraj = trajectories(kind, 5, 14)
    jtraj.save(str(tmp_path / "j.npz"))
    ttraj.save(str(tmp_path / "t.npz"))
    from_j = Trajectory.load(str(tmp_path / "j.npz"))
    from_t = JTrajectory.load(str(tmp_path / "t.npz"))
    assert from_j.kind == from_t.kind == kind
    np.testing.assert_array_equal(from_j.params, jtraj.params)
    np.testing.assert_array_equal(from_t.params, ttraj.params)
    with pytest.raises(ValueError, match="so3"):
        from_j.rotations()


def jax_trajectory(family, src, tmp_path, **kw):
    """The JAX package's trajectory of ``src``, saved where the port's
    ``--encode-only`` looks for it."""
    analyse = (jsimilarity.analyse_similarity if family == "similarity"
               else jdeshake.analyse_deshake)
    jtraj = analyse(src, JRenderOptions(**kw))
    tdest = str(tmp_path / "torch.y4m")
    jtraj.save(tdest + ".traj.npz")
    return jtraj, tdest


@pytest.mark.parametrize("flt,upsample", [
    ("vidstab", 0.0), ("vidstab", 150.0), ("deshake", 0.0), ("deshake_opencl", 0.0),
])
def test_encode_2d_matches_jax(tmp_path, flt, upsample):
    """The same JAX-written trajectory through both packages' encode
    phases: the frames agree within one count."""
    src = "synthetic://shaky?w=320&h=240&n=6&seed=5"
    kw = dict(filter=flt, stabilise="smooth", stabilise_radius=3, upsample=upsample)
    jtraj, tdest = jax_trajectory(FILTER_ALIASES[flt], src, tmp_path, **kw)
    jdest = str(tmp_path / "jax.y4m")
    jmeta_out = jencode_2d(src, jdest, jtraj, JRenderOptions(**kw))
    trender.render(src, tdest, trender.RenderOptions(encode_only=True, **kw),
                   device="cpu")
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    up = upsample / 100.0 if upsample else 1.0
    assert (tmeta.width, tmeta.height) == (jmeta_out.width, jmeta_out.height) == \
        (int(320 * up), int(240 * up))
    assert len(tframes) == len(jframes) == 6
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
    assert np.abs(tframes[3][0].astype(int) - tframes[0][0].astype(int)).mean() > 1


@pytest.mark.parametrize("flt", ["vidstab", "deshake"])
def test_render_2d_family_end_to_end(tmp_path, flt):
    """analyse + save + encode through ``render``; the saved trajectory is
    the family's kind and drives an ``--encode-only`` rerun to the same
    bytes."""
    src = "synthetic://shaky?w=320&h=240&n=6&seed=6"
    dest = str(tmp_path / "out.y4m")
    opts = trender.RenderOptions(filter=flt, stabilise="smooth", stabilise_radius=2)
    prof = trender.StageProfiler()
    trender.render(src, dest, opts, profiler=prof, device="cpu")
    traj = Trajectory.load(dest + ".traj.npz")
    assert traj.kind == {"vidstab": "similarity", "deshake": "translation"}[flt]
    assert traj.num_frames == 6
    _, first = read_frames(dest)
    os.remove(dest)
    trender.render(src, dest, dataclasses.replace(opts, encode_only=True), device="cpu")
    _, again = read_frames(dest)
    for a, b in zip(first, again):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    assert {"decode", "track", "warp", "encode"} <= set(prof.totals()[0])


@pytest.mark.parametrize("flt", ["vidstab", "deshake"])
def test_render_2d_family_without_stabilising_copies_the_frames(tmp_path, flt):
    """``--stabilise none``: the family's identity trajectory (no analyse,
    no trajectory file) and the zoom-free identity warp."""
    src = "synthetic://shaky?w=96&h=64&n=3&seed=7"
    dest = str(tmp_path / "out.y4m")
    trender.render(src, dest, trender.RenderOptions(filter=flt, stabilise="none"),
                   device="cpu")
    assert not os.path.exists(dest + ".traj.npz")
    _, got = read_frames(dest)
    _, want = read_frames(src)
    assert len(got) == 3
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)


def test_encode_2d_empty_trajectory_writes_no_frames(tmp_path):
    src = "synthetic://shaky?w=96&h=64&n=3&seed=7"
    for kind, dim in (("similarity", 4), ("translation", 2)):
        dest = str(tmp_path / f"{kind}.y4m")
        traj = Trajectory(params=np.zeros((0, dim)), kind=kind, width=96, height=64)
        meta = trender.encode_2d(src, dest, traj,
                                 trender.RenderOptions(stabilise="smooth"), device="cpu")
        assert (meta.width, meta.height, meta.num_frames) == (96, 64, 0)
        assert read_frames(dest)[1] == []


def test_encode_2d_refuses_an_so3_trajectory(tmp_path):
    traj = Trajectory(params=np.zeros((2, 3)), kind="so3", width=96, height=64)
    with pytest.raises(ValueError, match="so3"):
        trender.encode_2d("synthetic://shaky?w=96&h=64&n=2", None, traj,
                          trender.RenderOptions(), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(filter="deshake", upsample=150.0), "upsample"),
    (dict(filter="deshake_opencl", upsample=50.0), "upsample"),
    (dict(filter="vidstab", horizon_lock=True), "horizon-lock"),
    (dict(filter="deshake", rolling_shutter=0.75), "rolling-shutter"),
    (dict(filter="vidstab", streaming=True), "streaming"),
    (dict(filter="optical"), "unknown --filter"),
])
def test_render_2d_family_refusals_match_jax(kw, match):
    """Both packages refuse these with a ValueError, before any analyse."""
    from video_annotator_tpu.pipeline.render import render as jrender

    src = "synthetic://shaky?w=96&h=64&n=2"
    with pytest.raises(ValueError, match=match):
        jrender(src, None, JRenderOptions(stabilise="smooth", **kw))
    with pytest.raises(ValueError, match=match):
        trender.render(src, None, trender.RenderOptions(stabilise="smooth", **kw),
                       device="cpu")


def test_encode_2d_refuses_upsample_for_a_translation(tmp_path):
    traj = Trajectory(params=np.zeros((2, 2)), kind="translation", width=96, height=64)
    with pytest.raises(ValueError, match="upsample"):
        trender.encode_2d("synthetic://shaky?w=96&h=64&n=2", None, traj,
                          trender.RenderOptions(upsample=150.0), device="cpu")


@pytest.mark.parametrize("flt", ["vidstab", "deshake"])
def test_2d_families_refuse_unported_options(tmp_path, flt):
    """``--interp bicubic``, refused until K1's 4-tap mode was ported, now
    encodes as the JAX package does from the JAX analyser's trajectory
    (deshake's warp ignores it in both packages)."""
    from video_annotator_tpu.pipeline.render import render as jrender

    src = "synthetic://shaky?w=96&h=64&n=3"
    kw = dict(filter=flt, stabilise="smooth", interp="bicubic")
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jrender(src, str(jdest), JRenderOptions(analyse_only=True, **kw))
    os.link(str(jdest) + ".traj.npz", str(tdest) + ".traj.npz")
    jrender(src, str(jdest), JRenderOptions(encode_only=True, **kw))
    trender.render(src, str(tdest), trender.RenderOptions(encode_only=True, **kw),
                   device="cpu")
    (jmeta, jframes), (tmeta, tframes) = read_frames(jdest), read_frames(tdest)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 3)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
