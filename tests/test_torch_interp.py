"""The torch port's 4-tap resamplers (``--interp bicubic|lanczos``) on the
CPU, held against the JAX package: the weights and samplers against
``ops/warp_xla.py``, K1's batch, one-frame and float entries (their plain
versions here) with and without per-tile-row rotations against the JAX CPU
``FrameWarper``, the edge band that only 4 taps reach, the similarity
family's warps, and the renders: ``--interp bicubic|lanczos`` and
``--filter vidstab --interp bicubic`` encoded from JAX-written
trajectories, ``--compare ... --interp bicubic`` from the JAX analysers'
trajectories, against the JAX renders.

Tolerances as in ``tests/test_torch_warp.py``: float output within 0.05
of the XLA oracle (float32 sums of 16 taps in another order), uint8
within one count with at least 99.9% of values equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_compare import render_both
from test_torch_models import texture
from test_torch_pipeline import PRESET, assert_u8_close, read_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from test_torch_warp import FLOAT_ATOL, cameras, rotations, to_port, yuv_frames
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.models import similarity as jsimilarity
from video_annotator_tpu.ops import affine as jaffine
from video_annotator_tpu.ops import warp_xla as jwx
from video_annotator_tpu.pipeline.render import FrameWarper as JFrameWarper
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu_torch.camera import Camera, CameraModel, CameraPreset, camera_from_dfov
from video_annotator_tpu_torch.models import similarity
from video_annotator_tpu_torch.ops import affine, cuda_lib, warp_kernel, warp_plain
from video_annotator_tpu_torch.ops.mip import TileLevels
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.render import FrameWarper

WEIGHT_ATOL = 1e-6  # float32 sinf/cubics in two libraries
FOUR_TAP = ("bicubic", "lanczos")
JAX_SAMPLERS = {"bicubic": jwx.bicubic_sample, "lanczos": jwx.lanczos_sample}


def test_keys_weight_matches_jax():
    t = np.linspace(-2.5, 2.5, 2001).astype(np.float32)
    got = warp_plain.keys_weight(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jwx.keys_weight(jnp.asarray(t))),
                               atol=WEIGHT_ATOL)


def test_lanczos_weight_matches_jax():
    t = np.linspace(-2.5, 2.5, 2001).astype(np.float32)
    got = warp_plain.lanczos_weight(torch.from_numpy(t)).numpy()
    want = np.asarray(jwx.lanczos_weight(jnp.asarray(t), 2.0))
    np.testing.assert_allclose(got, want, atol=WEIGHT_ATOL)


@pytest.mark.parametrize("interp", FOUR_TAP)
def test_four_tap_sampler_matches_jax(interp):
    """Coordinates over the image and two pixels beyond each edge."""
    img = np.round(np.random.default_rng(0).uniform(0, 255, (48, 64))).astype(np.float32)
    rng = np.random.default_rng(1)
    coords = np.stack([rng.uniform(-3, 66, 4000), rng.uniform(-3, 50, 4000)],
                      axis=-1).astype(np.float32)
    got = warp_plain.sample(torch.from_numpy(img), torch.from_numpy(coords), interp).numpy()
    want = np.asarray(JAX_SAMPLERS[interp](jnp.asarray(img), jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("interp,model,mip,suffix", [
    ("bilinear", CameraModel.RECTILINEAR, 0, ""),
    ("lanczos", CameraModel.RECTILINEAR, 0, "_lanczos"),
    ("bilinear", CameraModel.EQUIRECT, 0, "_rays"),
    ("bilinear", CameraModel.RECTILINEAR, 1, "_mip"),
    ("bicubic", CameraModel.STEREOGRAPHIC, 2, "_bicubic_rays_mip"),
])
def test_each_variant_counts_under_one_kernel_object(interp, model, mip, suffix, rs):
    """A launch of K1 counts once, under the object of the variant it is:
    the entry's object name, the modes it runs, then ``_rs``; the same
    object at every call, replacing the entry's TPU launch site. A level
    map at level 0 everywhere runs no mip."""
    out_cam = camera_from_dfov(90.0, (256, 64), model)
    levels = TileLevels(torch.full((8, 2), mip, dtype=torch.uint8), mip)
    assert warp_kernel.variant(out_cam, interp, levels) == suffix
    if not suffix:
        return
    for whole in (*warp_kernel.BATCH_KERNELS[rs], *warp_kernel.ONE_FRAME_KERNELS[rs],
                  warp_kernel.FRAME_F32_KERNELS[rs], warp_kernel.PLANES_F32_KERNELS[rs]):
        obj = warp_kernel.mode_kernel(whole, suffix)
        base = whole.name[:-3] if rs else whole.name
        assert obj.name == base + suffix + ("_rs" if rs else "")
        assert obj.replaces == whole.replaces
        assert obj.source == "video_annotator_tpu_torch/csrc/warp_modes.cu"
        assert warp_kernel.mode_kernel(whole, suffix) is obj
        assert cuda_lib.KERNELS[obj.name] is obj


def test_sample_refuses_an_unknown_resampler():
    with pytest.raises(ValueError, match="interp"):
        warp_plain.sample(torch.zeros((4, 4)), torch.zeros((2, 2)), "lanczos9000")
    with pytest.raises(ValueError, match="interp"):
        FrameWarper(*(to_port(c) for c in cameras(64, 48, False)), interp="nearest")


def row_stack(ny, seed):
    return np.array(jso3.exp(jnp.asarray(
        np.random.default_rng(seed).normal(size=(ny, 3)) * 0.01, jnp.float32)))


def warpers(interp, w=320, h=240):
    jin, jout = cameras(w, h, False, zoom=1.0 / 1.2)
    return (JFrameWarper(jin, jout, 8.0, interp=interp),
            FrameWarper(to_port(jin), to_port(jout), 8.0, interp=interp))


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("interp", FOUR_TAP)
def test_batch_matches_jax_framewarper(interp, rs):
    jw, tw = warpers(interp)
    ys, us, vs = yuv_frames(2, 320, 240, 2)
    rots = (np.stack([row_stack(-(-tw.out_h // 8), s) for s in (3, 4)]) if rs
            else rotations(2, 3))
    got = tw.warp_yuv_batch(list(torch.from_numpy(ys)), list(torch.from_numpy(us)),
                            list(torch.from_numpy(vs)), torch.from_numpy(rots))
    for i in range(2):
        want = jw.warp_yuv(jnp.asarray(ys[i]), jnp.asarray(us[i]), jnp.asarray(vs[i]),
                           jnp.asarray(rots[i]))
        for g, w in zip(got[i], want):
            assert_u8_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("interp", FOUR_TAP)
def test_one_frame_and_float_match_jax_framewarper(interp, rs):
    jw, tw = warpers(interp)
    ys, us, vs = yuv_frames(1, 320, 240, 5)
    rot = row_stack(-(-tw.out_h // 8), 6) if rs else rotations(1, 6)[0]
    planes = [a[0] for a in (ys, us, vs)]
    want = jw.warp_yuv(*(jnp.asarray(p) for p in planes), jnp.asarray(rot))
    got = tw.warp_yuv(*(torch.from_numpy(p) for p in planes), torch.from_numpy(rot))
    for g, w in zip(got, want):
        assert_u8_close(g.numpy(), np.asarray(w))
    fplanes = [p.astype(np.float32) for p in planes]
    want = jw(*(jnp.asarray(p) for p in fplanes), jnp.asarray(rot))
    got = tw(*(torch.from_numpy(p) for p in fplanes), torch.from_numpy(rot))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLOAT_ATOL)


@pytest.mark.parametrize("interp", FOUR_TAP)
def test_edge_band_only_four_taps_reach(interp):
    """Pixels whose source lies between one and two pixels outside the
    image: border under bilinear, a blend of the edge under 4 taps, as in
    the XLA oracle. Identity cameras shifted by 1.5 px put the first output
    column there."""
    img = np.full((24, 32), 200.0, np.float32)
    ident = Camera.make(1.0, 1.0, 0.0, 0.0, 32, 24, CameraModel.RECTILINEAR)
    shift = np.array([[1.0, 0.0, -1.5], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    coords = warp_plain.compute_warp_map(ident, ident, torch.from_numpy(shift), (24, 32))
    band = (coords[..., 0] > -2.0) & (coords[..., 0] <= -1.0)
    assert bool(band[:, 0].all())
    got4 = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(shift), ident,
                                      ident, (24, 32), interp=interp)
    got2 = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(shift), ident,
                                      ident, (24, 32))
    want = np.asarray(JAX_SAMPLERS[interp](jnp.asarray(img), jnp.asarray(coords.numpy())))
    assert (got2[:, 0] == 0).all()
    assert (got4[4:-4, 0].abs() > 1.0).all()
    np.testing.assert_allclose(got4.numpy(), want, atol=FLOAT_ATOL)


@pytest.mark.parametrize("interp", FOUR_TAP)
def test_warp_similarity_matches_jax(interp):
    img = texture(64, 96, 3)
    params = np.array([2.5, -1.75, 0.03, -0.02], np.float32)
    want = jaffine.warp_similarity(jnp.asarray(img), jnp.asarray(params), interp=interp)
    got = affine.warp_similarity(torch.from_numpy(img), torch.from_numpy(params),
                                 interp=interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_ATOL)


def test_similarity_warper_bicubic_matches_jax():
    """K1's 4-tap mode between identity cameras (its plain version here)
    against JAX ``warp_frame_similarity`` with bicubic, batch and one frame."""
    planes = [texture(64, 96, 4), texture(32, 48, 5), texture(32, 48, 6)]
    params = np.array([[1.5, -2.25, 0.02, 0.01], [-3.0, 0.5, -0.01, -0.02]], np.float32)
    warper = similarity.SimilarityWarper(96, 64, interp="bicubic")
    mats = torch.from_numpy(similarity.SimilarityWarper.matrices(params))
    u8 = [torch.from_numpy(p).to(torch.uint8) for p in planes]
    batch = warper.warp_yuv_batch([u8[0]] * 2, [u8[1]] * 2, [u8[2]] * 2, mats)
    for t in range(2):
        want = jsimilarity.warp_frame_similarity(*(jnp.asarray(p) for p in planes),
                                                 jnp.asarray(params[t]), interp="bicubic")
        single = warper.warp_yuv(*u8, mats[t])
        for g, b, w in zip(single, batch[t], want):
            assert torch.equal(g, b)
            assert_u8_close(g.numpy(), np.clip(np.round(np.asarray(w)), 0, 255))


def encode_both(tmp_path, src, jopts, topts):
    """The JAX analyser's trajectory, encoded by both packages; the
    frames within one count."""
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jrender(src, str(jdest), dataclasses.replace(jopts, analyse_only=True))
    os.link(str(jdest) + ".traj.npz", str(tdest) + ".traj.npz")
    jrender(src, str(jdest), dataclasses.replace(jopts, encode_only=True))
    trender.render(src, str(tdest), dataclasses.replace(topts, encode_only=True),
                   device="cpu")
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    assert (tmeta.width, tmeta.height, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.num_frames)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


@pytest.mark.parametrize("interp", FOUR_TAP)
def test_render_interp_matches_jax(tmp_path, interp):
    """``render --interp`` end to end: a rolled and pitched attitude with
    the stabilise buffer's canvas, so no analyser runs."""
    src = "synthetic://shaky?w=160&h=120&n=4&seed=7"
    kw = dict(interp=interp, roll=3.0, pitch=-2.0, stabilise_buffer=20.0)
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jrender(src, str(jdest), JRenderOptions(preset=JCameraPreset(PRESET), **kw))
    trender.render(src, str(tdest), trender.RenderOptions(preset=CameraPreset(PRESET), **kw),
                   device="cpu")
    jmeta, jframes = read_frames(jdest)
    tmeta, tframes = read_frames(tdest)
    assert (tmeta.width, tmeta.height, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.num_frames) == (jmeta.width, jmeta.height, 4)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


def test_render_vidstab_bicubic_matches_jax(tmp_path):
    encode_both(tmp_path, "synthetic://shaky?w=160&h=120&n=6&seed=8",
                JRenderOptions(filter="vidstab", stabilise="smooth", interp="bicubic"),
                trender.RenderOptions(filter="vidstab", stabilise="smooth", interp="bicubic"))


def test_render_compare_bicubic_matches_jax(monkeypatch, tmp_path):
    """The rotation and similarity cells of the grid with bicubic, from
    the JAX analysers' trajectories."""
    src = "synthetic://shaky?w=160&h=120&n=4&fps=30&seed=5&shake=0.005"
    (jmeta, jframes), (tmeta, tframes), _ = render_both(
        monkeypatch, tmp_path, src, ["none", "smooth", "vidstab"], interp="bicubic",
        cell_labels=False)
    assert (tmeta.width, tmeta.height) == (jmeta.width, jmeta.height)
    assert len(tframes) == len(jframes) == 4
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
