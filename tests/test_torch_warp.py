"""The torch port's warp (plain versions of kernel K1's uint8 and float
modes) against the JAX package: the XLA oracle, the CPU ``FrameWarper``
paths (batch, one frame, float planes) and the Pallas kernels in
interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import (
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu.ops.warp_pallas import (
    plan_warp,
    warp_frame_pallas,
    warp_planes_pallas,
    warp_yuv_batch_pallas,
    warp_yuv_pallas,
)
from video_annotator_tpu.ops.warp_xla import _scaled_camera, warp_image_xla
from video_annotator_tpu.pipeline.render import FrameWarper as JaxFrameWarper
from video_annotator_tpu_torch import camera as tcamera
from video_annotator_tpu_torch.ops import warp_kernel, warp_plain
from video_annotator_tpu_torch.pipeline.render import FrameWarper

FLOAT_ATOL = 0.05  # the bar tests/test_warp_pallas.py sets for the Pallas kernel
MIN_EQUAL = 0.999  # uint8 outputs: within 1 count, at least 99.9% equal
# Source coordinates, port against the XLA oracle: 4 float32 ulps of a
# coordinate below 512. Both maps evaluate the same expressions in
# float32, each within about 2 ulps of a float64 evaluation; the oracle's
# rounding moves with the host's instruction set (XLA's vectorised atan
# and sqrt), so its map, not the port's, is what differs between hosts.
MAP_ATOL = 1.25e-4
SAMPLE_ATOL = 1e-4  # the bilinear sampler alone, on the oracle's coordinates


def to_port(jcam):
    leaves = {f: np.asarray(getattr(jcam, f)) for f in ("fx", "fy", "cx", "cy", "dist")}
    leaves.update(width=jcam.width, height=jcam.height, model=jcam.model)
    return tcamera.camera_from_numpy(leaves)


def cameras(w, h, crop_borders, zoom=1.0):
    jin = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    jout = get_output_camera(jin, scale=1.0, crop_borders=crop_borders, zoom=zoom)
    return jin, jout


def yuv_frames(t, w, h, seed):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 256, size=(t, h, w)).astype(np.uint8)
    us = rng.integers(0, 256, size=(t, h // 2, w // 2)).astype(np.uint8)
    vs = rng.integers(0, 256, size=(t, h // 2, w // 2)).astype(np.uint8)
    return ys, us, vs


def rotations(t, seed):
    w = (np.random.default_rng(seed).normal(size=(t, 3)) * 0.03).astype(np.float32)
    return np.array(jso3.exp(jnp.asarray(w)))


def assert_u8_close(got, want):
    got = np.asarray(got, np.int16)
    want = np.asarray(want, np.int16)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()


def noise_plane(w, h, seed):
    """Integer-valued uniform noise in [0, 255]: neighbours differ by up to
    255, the sampler's hardest input."""
    return np.round(np.random.default_rng(seed).uniform(0, 255, size=(h, w))).astype(
        np.float32)


def smooth_planes(p, w, h, seed):
    """``p`` integer-valued planes of smooth texture in [0, 255] (sums of
    sinusoids): neighbours differ by about 18 counts along each axis, so
    :data:`MAP_ATOL` bounds a warp's error from the map to about
    36 * MAP_ATOL, far below :data:`FLOAT_ATOL` (:func:`max_step`)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for _ in range(p):
        a, b, c, d = rng.uniform(7.0, 11.0, 4)
        ph = rng.uniform(0.0, 6.3, 2)
        img = (127.5 + 60.0 * np.sin(xx / a + ph[0]) * np.cos(yy / b)
               + 60.0 * np.cos(xx / c - yy / d + ph[1]))
        out.append(np.round(np.clip(img, 0, 255)).astype(np.float32))
    return np.stack(out)


def max_step(img):
    """The largest difference between horizontal plus vertical neighbours:
    a bilinear sample moves by at most this times a coordinate error."""
    img = np.asarray(img, np.float64)
    return float(np.abs(np.diff(img, axis=-1)).max() + np.abs(np.diff(img, axis=-2)).max())


def assert_map_bounds_error(img):
    """The map tolerance holds a bilinear warp of ``img`` below FLOAT_ATOL."""
    assert max_step(img) * MAP_ATOL < FLOAT_ATOL / 4, max_step(img)


@pytest.mark.parametrize("crop_borders", [True, False])
def test_warp_map_matches_xla_oracle(crop_borders):
    """The port's source coordinates against ``warp_xla.compute_warp_map``,
    everywhere in front of the input camera, within MAP_ATOL px; the rays
    behind it are pinned to -1e6 in both."""
    from video_annotator_tpu.ops.warp_xla import compute_warp_map as jmap

    jin, jout = cameras(320, 240, crop_borders)
    rot = rotations(1, 1)[0]
    want = np.asarray(jmap(jout, jin, jnp.asarray(rot)))
    got = warp_plain.compute_warp_map(to_port(jout), to_port(jin),
                                      torch.tensor(rot)).numpy()
    assert got.shape == want.shape
    behind = want == -1e6
    np.testing.assert_array_equal(got == -1e6, behind)
    np.testing.assert_allclose(got[~behind], want[~behind], rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("crop_borders", [True, False])
def test_bilinear_sample_matches_xla_oracle(crop_borders):
    """The port's sampler given the oracle's own coordinates, on noise,
    against ``warp_xla.bilinear_sample``: the same float32 products and
    sums, so no map rounding enters."""
    from video_annotator_tpu.ops.warp_xla import bilinear_sample as jsample
    from video_annotator_tpu.ops.warp_xla import compute_warp_map as jmap

    jin, jout = cameras(320, 240, crop_borders)
    img = noise_plane(320, 240, 0)
    coords = np.array(jmap(jout, jin, jnp.asarray(rotations(1, 1)[0])))
    want = np.asarray(jsample(jnp.asarray(img), jnp.asarray(coords)))
    got = warp_plain.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("crop_borders", [True, False])
def test_warp_image_matches_xla_oracle(crop_borders):
    """The whole warp against ``warp_image_xla``. On noise a bilinear
    sample moves by up to 2 * 255 counts per px of coordinate error, so
    FLOAT_ATOL would hold the two maps to 1e-4 px: a few float32 ulps at
    x ~ 300, which the oracle's own rounding crosses on some hosts. The
    map (MAP_ATOL) and the sampler (SAMPLE_ATOL) are held apart above;
    here the image is smooth, its neighbours about 36 counts apart in x
    plus y, so MAP_ATOL bounds the warp's difference below a quarter
    of FLOAT_ATOL."""
    jin, jout = cameras(320, 240, crop_borders)
    img = smooth_planes(1, 320, 240, 0)[0]
    assert_map_bounds_error(img)
    rot = rotations(1, 1)[0]
    want = np.asarray(warp_image_xla(jnp.asarray(img), jout, jin, jnp.asarray(rot)))
    got = warp_plain.warp_image(torch.from_numpy(img), to_port(jout), to_port(jin),
                                torch.tensor(rot)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)


def test_warp_yuv_batch_matches_jax_framewarper():
    t, w, h = 3, 320, 240
    jin, jout = cameras(w, h, False, zoom=1.0 / 1.2)
    ys, us, vs = yuv_frames(t, w, h, 2)
    rots = rotations(t, 3)
    jw = JaxFrameWarper(jin, jout, max_correction_deg=8.0)
    want = jw.warp_yuv_batch([jnp.asarray(a) for a in ys], [jnp.asarray(a) for a in us],
                             [jnp.asarray(a) for a in vs], jnp.asarray(rots))
    tw = FrameWarper(to_port(jin), to_port(jout))
    got = tw.warp_yuv_batch(list(torch.from_numpy(ys)), list(torch.from_numpy(us)),
                            list(torch.from_numpy(vs)), torch.from_numpy(rots))
    assert (tw.out_w, tw.out_h) == (jw.out_w, jw.out_h)
    for g, wnt in zip(got, want):
        for gp, wp in zip(g, wnt):
            assert_u8_close(gp.numpy(), np.asarray(wp))


def test_warp_yuv_batch_matches_pallas_interpret():
    t, w, h = 2, 320, 240
    jin, jout = cameras(w, h, True)
    ys, us, vs = yuv_frames(t, w, h, 4)
    rots = rotations(t, 5)
    out_w, out_h = jout.width - jout.width % 2, jout.height - jout.height % 2
    jin_c, jout_c = _scaled_camera(jin, 0.5), _scaled_camera(jout, 0.5)
    plan_y = plan_warp(jout, jin, 8.0, (out_h, out_w))
    plan_c = plan_warp(jout_c, jin_c, 8.0, (out_h // 2, out_w // 2))
    want = warp_yuv_batch_pallas(
        [jnp.asarray(a) for a in ys], [jnp.asarray(a) for a in us],
        [jnp.asarray(a) for a in vs], jnp.asarray(rots), plan_y, jout, jin,
        plan_c, jout_c, jin_c, interpret=True)
    wy, wu, wv = warp_kernel.warp_yuv_batch(
        torch.from_numpy(ys), torch.from_numpy(us), torch.from_numpy(vs),
        torch.from_numpy(rots), to_port(jout), to_port(jin), to_port(jout_c),
        to_port(jin_c), (out_h, out_w))
    for i in range(t):
        for gp, wp in zip((wy[i], wu[i], wv[i]), want[i]):
            assert_u8_close(gp.numpy(), np.asarray(wp))


def test_chroma_border_is_neutral():
    """Rays behind the input camera sample the border: 128 for chroma."""
    jin, jout = cameras(64, 48, False)
    src = torch.zeros((1, 2, 24, 32), dtype=torch.uint8)
    backward = torch.tensor(np.asarray(jso3.exp(jnp.asarray([0.0, 3.0, 0.0]))))[None]
    out = warp_kernel.warp_planes_u8(src, backward, to_port(_scaled_camera(jout, 0.5)),
                                     to_port(_scaled_camera(jin, 0.5)), (10, 12),
                                     border=128.0)
    assert out.shape == (1, 2, 10, 12)
    assert (out == 128).all()


def test_warp_rejects_bad_operands():
    jin, jout = cameras(64, 48, False)
    with pytest.raises(ValueError):
        warp_kernel.warp_planes_u8(torch.zeros((1, 3, 8, 8), dtype=torch.uint8),
                                   torch.eye(3)[None], to_port(jout), to_port(jin),
                                   (4, 4))
    with pytest.raises(ValueError):
        warp_kernel.warp_planes_u8(torch.zeros((1, 1, 8, 8), dtype=torch.float32),
                                   torch.eye(3)[None], to_port(jout), to_port(jin),
                                   (4, 4))


def float_planes(w, h, seed):
    """Integer-valued smooth float planes, as the compare grid passes them
    (luma full size, chroma half): smooth so that MAP_ATOL bounds the
    warp's difference (see test_warp_image_matches_xla_oracle)."""
    y = smooth_planes(1, w, h, seed)[0]
    u, v = smooth_planes(2, w // 2, h // 2, seed + 1)
    for p in (y, u, v):
        assert_map_bounds_error(p)
    return y, u, v


@pytest.mark.parametrize("crop_borders,zoom", [(True, 1.0), (False, 1.0 / 1.2)])
def test_framewarper_call_matches_jax_framewarper(crop_borders, zoom):
    """Float planes in, float planes out, neither rounded nor clamped; on
    smooth planes, for the reason test_warp_image_matches_xla_oracle
    gives."""
    w, h = 320, 240
    jin, jout = cameras(w, h, crop_borders, zoom=zoom)
    y, u, v = float_planes(w, h, 6)
    rot = rotations(1, 7)[0]
    want = JaxFrameWarper(jin, jout, max_correction_deg=8.0)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(rot))
    tw = FrameWarper(to_port(jin), to_port(jout))
    got = tw(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
             torch.from_numpy(rot))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=FLOAT_ATOL)
    if not crop_borders:  # outside the image: luma 0, chroma the neutral 128
        assert float(got[0][0, 0]) == 0.0
        assert float(got[1][0, 0]) == float(got[2][0, 0]) == 128.0


def test_framewarper_warp_yuv_matches_jax_framewarper():
    w, h = 320, 240
    jin, jout = cameras(w, h, False, zoom=1.0 / 1.2)
    ys, us, vs = yuv_frames(1, w, h, 8)
    rot = rotations(1, 9)[0]
    want = JaxFrameWarper(jin, jout, max_correction_deg=8.0).warp_yuv(
        jnp.asarray(ys[0]), jnp.asarray(us[0]), jnp.asarray(vs[0]), jnp.asarray(rot))
    tw = FrameWarper(to_port(jin), to_port(jout))
    got = tw.warp_yuv(torch.from_numpy(ys[0]), torch.from_numpy(us[0]),
                      torch.from_numpy(vs[0]), torch.from_numpy(rot))
    batch = tw.warp_yuv_batch([torch.from_numpy(ys[0])], [torch.from_numpy(us[0])],
                              [torch.from_numpy(vs[0])], torch.from_numpy(rot)[None])
    for g, b, wnt in zip(got, batch[0], want):
        assert g.dtype == torch.uint8 and torch.equal(g, b)
        assert_u8_close(g.numpy(), np.asarray(wnt))


def test_warp_yuv_matches_pallas_interpret():
    """One frame, one matrix, against the TPU kernels of ``_build_warp_yuv_fn``."""
    w, h = 320, 240
    jin, jout = cameras(w, h, True)
    ys, us, vs = yuv_frames(1, w, h, 10)
    rot = rotations(1, 11)[0]
    out_w, out_h = jout.width - jout.width % 2, jout.height - jout.height % 2
    jin_c, jout_c = _scaled_camera(jin, 0.5), _scaled_camera(jout, 0.5)
    plan_y = plan_warp(jout, jin, 8.0, (out_h, out_w))
    plan_c = plan_warp(jout_c, jin_c, 8.0, (out_h // 2, out_w // 2))
    want = warp_yuv_pallas(jnp.asarray(ys[0]), jnp.asarray(us[0]), jnp.asarray(vs[0]),
                           jnp.asarray(rot), plan_y, jout, jin, plan_c, jout_c, jin_c,
                           interpret=True)
    got = warp_kernel.warp_yuv(
        torch.from_numpy(ys[0]), torch.from_numpy(us[0]), torch.from_numpy(vs[0]),
        torch.from_numpy(rot), to_port(jout), to_port(jin), to_port(jout_c),
        to_port(jin_c), (out_h, out_w))
    for g, wnt in zip(got, want):
        assert_u8_close(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("planes", [1, 2, 3])
def test_warp_planes_f32_matches_pallas_interpret_and_oracle(planes):
    """P planes of one frame through one map: against the TPU kernels of
    ``_build_warp_fn`` (P = 1) and ``_build_warp_planes_fn`` in interpret
    mode, and against the XLA oracle plane by plane; on smooth planes, for
    the reason test_warp_image_matches_xla_oracle gives."""
    w, h = 320, 240
    jin, jout = cameras(w, h, True)
    src = smooth_planes(planes, w, h, 12 + planes)
    assert_map_bounds_error(src)
    rot = rotations(1, 13)[0]
    border = 0.0 if planes == 1 else 128.0
    plan = plan_warp(jout, jin, max_correction_deg=6.0)
    if planes == 1:
        pallas = [warp_frame_pallas(jnp.asarray(src[0]), jnp.asarray(rot), plan, jout,
                                    jin, interpret=True)]
        got = warp_kernel.warp_frame_f32(
            torch.from_numpy(src[0]), torch.from_numpy(rot), to_port(jout), to_port(jin),
            (jout.height, jout.width))[None]
    else:
        pallas = warp_planes_pallas([jnp.asarray(p) for p in src], jnp.asarray(rot),
                                    plan, jout, jin, interpret=True, border=border)
        got = warp_kernel.warp_planes_f32(
            torch.from_numpy(src), torch.from_numpy(rot), to_port(jout), to_port(jin),
            (jout.height, jout.width), border=border)
    assert got.shape == (planes, jout.height, jout.width) and got.dtype == torch.float32
    for p in range(planes):
        oracle = warp_image_xla(jnp.asarray(src[p]) - border, jout, jin,
                                jnp.asarray(rot)) + border
        np.testing.assert_allclose(got[p].numpy(), np.asarray(oracle), atol=FLOAT_ATOL)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(pallas[p]), atol=FLOAT_ATOL)


def test_float_warp_samples_the_float_source_unrounded():
    """The port holds to the oracle: a fractional source is sampled as it
    is (the TPU kernel rounded it to bytes while packing), and values
    outside [0, 255] pass through unclamped."""
    jin, jout = cameras(64, 48, True)
    src = torch.full((1, 48, 64), 300.25)
    out = warp_kernel.warp_planes_f32(src, torch.eye(3), to_port(jout), to_port(jin),
                                      (jout.height, jout.width))
    centre = out[0, jout.height // 2, jout.width // 2]
    assert abs(float(centre) - 300.25) < 1e-3


@pytest.mark.parametrize("src,rot", [
    (torch.zeros((5, 8, 8)), torch.eye(3)),  # more than 4 planes
    (torch.zeros((0, 8, 8)), torch.eye(3)),
    (torch.zeros((2, 8, 8), dtype=torch.uint8), torch.eye(3)),
    (torch.zeros((8, 8)), torch.eye(3)),
    # A batch's (T, ny, 3, 3) stack: the float warp takes one frame's
    # matrix or its (ny, 3, 3) per-tile-row stack.
    (torch.zeros((2, 8, 8)), torch.eye(3)[None, None]),
])
def test_float_warp_rejects_bad_operands(src, rot):
    jin, jout = cameras(64, 48, False)
    with pytest.raises(ValueError):
        warp_kernel.warp_planes_f32(src, rot, to_port(jout), to_port(jin), (4, 4))


def test_warp_yuv_rejects_a_matrix_stack():
    """A batch's (T, ny, 3, 3) stack; one frame's (ny, 3, 3) per-tile-row
    stack is the rolling-shutter form and is taken."""
    jin, jout = cameras(64, 48, False)
    y = torch.zeros((48, 64), dtype=torch.uint8)
    c = torch.zeros((24, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one"):
        warp_kernel.warp_yuv(y, c, c, torch.eye(3)[None, None], to_port(jout), to_port(jin),
                             to_port(jout), to_port(jin), (8, 8))


def test_time_warp_builds_needs_a_card(capsys):
    """The build-comparison script imports without a card or ``nvcc`` and
    refuses to run without one."""
    from video_annotator_tpu_torch.tools import time_warp_builds

    if torch.cuda.is_available():
        pytest.skip("the refusal is for a host without a card")
    assert time_warp_builds.main([]) == 1
    assert "CUDA" in capsys.readouterr().err


def row6_row9_case(interp, projection):
    """(jin, jout, plan) at 320x240: the stock fisheye to its auto-fit
    rectilinear output, or to a stereographic one (the ray grid)."""
    jin, jout = cameras(320, 240, True)
    if projection != "rect":
        from video_annotator_tpu.camera import CameraModel, camera_from_dfov

        jout = camera_from_dfov(120.0, (jout.width, jout.height), CameraModel(projection))
    return jin, jout, plan_warp(jout, jin, max_correction_deg=6.0, interp=interp)


ROW6_ROW9_CASES = [("bilinear", "rect"), ("bicubic", "rect"), ("bilinear", "stereographic")]


@pytest.mark.parametrize("interp,projection", ROW6_ROW9_CASES)
def test_warp_frames_f32_matches_pallas_interpret(interp, projection):
    """Row 6's plain version against ``warp_frames_pallas`` in interpret
    mode (the TPU kernel of ``_build_warp_batch_fn``), and frame by frame
    against the one-frame float warp; on smooth frames, for the reason
    test_warp_image_matches_xla_oracle gives."""
    from video_annotator_tpu.ops.warp_pallas import warp_frames_pallas

    jin, jout, plan = row6_row9_case(interp, projection)
    frames = smooth_planes(3, 320, 240, 21)
    assert_map_bounds_error(frames)
    rots = rotations(3, 22)
    want = np.asarray(warp_frames_pallas(jnp.asarray(frames), jnp.asarray(rots), plan,
                                         jout, jin, interpret=True))
    size = (jout.height, jout.width)
    got = warp_kernel.warp_frames_f32(torch.from_numpy(frames), torch.from_numpy(rots),
                                      to_port(jout), to_port(jin), size, interp=interp)
    assert got.shape == (3, *size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL)
    for t in range(3):
        one = warp_kernel.warp_frame_f32(torch.from_numpy(frames[t]), torch.from_numpy(rots[t]),
                                         to_port(jout), to_port(jin), size, interp=interp)
        torch.testing.assert_close(got[t], one, rtol=0, atol=0)


@pytest.mark.parametrize("interp,projection,nshards", [
    ("bilinear", "rect", 2), ("bilinear", "rect", 3), ("bilinear", "rect", 4),
    ("bicubic", "rect", 3), ("bilinear", "stereographic", 3)])
def test_warp_frame_band_f32_matches_pallas_interpret(interp, projection, nshards):
    """Row 9's plain version for every band against
    ``warp_frame_band_pallas`` in interpret mode over the rows inside the
    output, and the bands, concatenated and cropped, equal the whole
    frame's float warp; on a smooth frame, for the reason
    test_warp_image_matches_xla_oracle gives."""
    from video_annotator_tpu.ops.warp_pallas import warp_frame_band_pallas

    jin, jout, plan = row6_row9_case(interp, projection)
    frame = smooth_planes(1, 320, 240, 23)[0]
    assert_map_bounds_error(frame)
    rot = rotations(1, 24)[0]
    size = (jout.height, jout.width)
    ny = warp_plain.num_tile_rows(size[0])
    ny_band = warp_kernel.band_tile_rows(size[0], nshards)
    assert ny_band == -(-ny // nshards) and plan.grid[0] == ny
    bands = []
    for rank in range(nshards):
        off = rank * ny_band
        got = warp_kernel.warp_frame_band_f32(
            torch.from_numpy(frame), torch.from_numpy(rot), to_port(jout), to_port(jin),
            size, nshards, off, interp=interp)
        assert got.shape == (ny_band * 8, size[1]) and got.dtype == torch.float32
        want = np.asarray(warp_frame_band_pallas(jnp.asarray(frame), jnp.asarray(rot), plan,
                                                 jout, jin, nshards, off, interpret=True))
        # Rows inside the output and outside the overflow tiles: those
        # are crop fodder, and the ray-grid Pallas kernel leaves them
        # unlike its final tile row (the port recomputes that row).
        own = torch.arange(ny_band).repeat_interleave(8) + off < ny
        inside = ((warp_kernel.band_rows(size[0], nshards, off) < size[0]) & own).numpy()
        np.testing.assert_allclose(got.numpy()[inside], want[inside], atol=FLOAT_ATOL)
        bands.append(got)
    whole = warp_kernel.warp_frame_f32(torch.from_numpy(frame), torch.from_numpy(rot),
                                       to_port(jout), to_port(jin), size, interp=interp)
    torch.testing.assert_close(torch.cat(bands)[:size[0]], whole, rtol=0, atol=0)


def test_band_clamps_past_the_last_tile_row():
    """A band that starts past the frame's last tile row repeats it, and
    the last tile's rows past out_h are computed from the map."""
    jin, jout = cameras(320, 240, True)
    size = (jout.height, jout.width)
    ny = warp_plain.num_tile_rows(size[0])
    frame = torch.from_numpy(np.round(np.random.default_rng(25).uniform(
        0, 255, size=(240, 320))).astype(np.float32))
    rot = torch.from_numpy(rotations(1, 26)[0])
    last = warp_kernel.warp_frame_band_f32(frame, rot, to_port(jout), to_port(jin), size,
                                           ny, ny - 1)
    past = warp_kernel.warp_frame_band_f32(frame, rot, to_port(jout), to_port(jin), size,
                                           ny, ny + 3)
    torch.testing.assert_close(past, last, rtol=0, atol=0)
    padded = warp_kernel.warp_frame_f32(frame, rot, to_port(jout), to_port(jin),
                                        (ny * 8, size[1]))
    torch.testing.assert_close(last, padded[-8:], rtol=0, atol=0)


@pytest.mark.parametrize("call", [
    lambda f, r, o, i: warp_kernel.warp_frames_f32(f[0], r, o, i, (8, 8)),  # one plane
    lambda f, r, o, i: warp_kernel.warp_frames_f32(f, r[:1], o, i, (8, 8)),  # 1 rotation
    lambda f, r, o, i: warp_kernel.warp_frames_f32(f.to(torch.uint8), r, o, i, (8, 8)),
    lambda f, r, o, i: warp_kernel.warp_frame_band_f32(f, r[0], o, i, (8, 8), 2, 0),
    lambda f, r, o, i: warp_kernel.warp_frame_band_f32(f[0], r, o, i, (8, 8), 2, 0),
    lambda f, r, o, i: warp_kernel.warp_frame_band_f32(f[0], r[0], o, i, (8, 8), 0, 0),
    lambda f, r, o, i: warp_kernel.warp_frame_band_f32(f[0], r[0], o, i, (8, 8), 2, -1),
])
def test_frames_and_band_reject_bad_operands(call):
    jin, jout = cameras(64, 48, False)
    frames = torch.zeros((2, 48, 64))
    rots = torch.eye(3).expand(2, 3, 3)
    with pytest.raises(ValueError):
        call(frames, rots, to_port(jout), to_port(jin))
