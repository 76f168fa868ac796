"""The torch port's rolling-shutter path on the CPU, held against the JAX
package on the same numpy inputs: the scan fractions and the per-tile-row
rotations (velocity model and telemetry-exact), the plain version of
kernel K1's per-tile-row mode against the XLA oracle and the Pallas kernel
in interpret mode, the chroma row rule and the clipped row index, the
``FrameWarper`` entries with per-tile-row stacks, the ``--encode-only
--rolling-shutter`` render through both packages, jello removal end to
end, and the modes that refuse the option."""

import importlib
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_pipeline import PRESET, assert_u8_close, read_frames
from test_torch_warp import FLOAT_ATOL, cameras, to_port, yuv_frames
from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.ops.warp_pallas import (
    _chroma_row_rotations,
    plan_warp,
    warp_frame_pallas,
    warp_yuv_pallas,
)
from video_annotator_tpu.ops.warp_xla import _scaled_camera, warp_image_xla
from video_annotator_tpu.pipeline.render import FrameWarper as JaxFrameWarper
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu.smoothing import rolling as jrolling
from video_annotator_tpu_torch import so3 as tso3
from video_annotator_tpu_torch.camera import CameraPreset, get_preset_camera
from video_annotator_tpu_torch.io.synthetic import (
    SyntheticCamera,
    render_frame,
    write_telemetry_mp4,
)
from video_annotator_tpu_torch.io.video import VideoMeta, open_writer
from video_annotator_tpu_torch.ops import warp_kernel, warp_plain
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.render import FrameWarper
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing import rolling as trolling

jrender_mod = importlib.import_module("video_annotator_tpu.pipeline.render")

ATOL = 1e-5  # float32 geometry against the JAX functions on the CPU


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_rotations(ny, seed=0, scale=0.03):
    """(ny, 3, 3): a pose that drifts down the frame, plus a little noise."""
    rng = np.random.default_rng(seed)
    ramp = np.outer(np.arange(ny) / ny, [0.01, -0.02, 0.03])
    w = (ramp + rng.normal(0, scale / 10, (ny, 3))).astype(np.float32)
    return np.array(jso3.exp(jnp.asarray(w)))


def tile_rows(h):
    return -(-h // 8)


# --- scan fractions and row rotations -------------------------------------------


@pytest.mark.parametrize("crop_borders,zoom", [(True, 1.0), (False, 1.0), (False, 1 / 1.2)])
def test_scan_fractions_match_jax(crop_borders, zoom):
    jin, jout = cameras(256, 192, crop_borders, zoom)
    ny = tile_rows(jout.height)
    want = np.asarray(jrolling.scan_fractions(jout, jin, ny))
    got = trolling.scan_fractions(to_port(jout), to_port(jin), ny)
    assert got.dtype == torch.float32 and got.shape == (ny,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert (np.diff(got.numpy()) >= 0).all() and 0 <= got.min() and got.max() <= 1


def trajectory_and_corrections(t, seed):
    rng = np.random.default_rng(seed)
    measured = np.array(jso3.exp(jnp.asarray(
        np.cumsum(rng.normal(0, 0.02, (t, 3)), 0), jnp.float32)))
    corr = np.array(jso3.exp(jnp.asarray(rng.normal(0, 0.05, (t, 3)), jnp.float32)))
    return measured, corr


@pytest.mark.parametrize("t", [1, 2, 9])
def test_rs_row_rotations_match_jax(t):
    measured, corr = trajectory_and_corrections(t, t)
    f = np.linspace(0.1, 0.9, 14).astype(np.float32)
    want = np.asarray(jrolling.rs_row_rotations(
        jnp.asarray(corr), jnp.asarray(measured), 0.75, jnp.asarray(f)))
    got = trolling.rs_row_rotations(torch.from_numpy(corr), torch.from_numpy(measured),
                                    0.75, torch.from_numpy(f))
    assert tuple(got.shape) == want.shape == (t, 14, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_rs_row_rotations_constant_velocity():
    """Constant angular velocity: the row rotations interpolate exactly
    (the JAX package's test of the same name, for the port)."""
    t, ny, readout = 6, 12, 0.8
    w = np.asarray([0.02, -0.01, 0.05])
    measured = tso3.exp(torch.from_numpy(-np.outer(np.arange(t), w).astype(np.float32)))
    f = torch.from_numpy(((np.arange(ny) * 8.0 + 4.0) / (ny * 8.0)).astype(np.float32))
    rows = trolling.rs_row_rotations(measured, measured, readout, f).numpy()
    for j in (0, 5, 11):
        want = tso3.exp(torch.from_numpy((-w * (2 + float(f[j]) * readout)).astype(np.float32)))
        np.testing.assert_allclose(rows[2, j], want.numpy(), atol=1e-5)


def test_rs_row_rotations_gyro_match_jax():
    rng = np.random.default_rng(3)
    t, ny, fps = 8, 24, 30.0
    n = 500
    ts = (np.arange(n) / 400.0 + rng.uniform(0, 1e-4, n)).astype(np.float32)
    omega = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    frame_ts = (0.2 + np.arange(t) / fps).astype(np.float32)
    f = np.linspace(0.05, 0.95, ny).astype(np.float32)
    _, corr = trajectory_and_corrections(t, 5)
    want = np.asarray(jrolling.rs_row_rotations_gyro(
        jnp.asarray(corr), jnp.asarray(omega), jnp.asarray(ts), jnp.asarray(frame_ts),
        0.75 / fps, jnp.asarray(f)))
    got = trolling.rs_row_rotations_gyro(
        torch.from_numpy(corr), torch.from_numpy(omega), torch.from_numpy(ts),
        torch.from_numpy(frame_ts), 0.75 / fps, torch.from_numpy(f))
    assert tuple(got.shape) == want.shape == (t, ny, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_rs_row_rotations_gyro_exact():
    """An accelerating roll rate w(t) = a t: the telemetry-exact rows
    follow the true integral, which the velocity model cannot (the JAX
    package's test of the same name, for the port)."""
    t, ny, fps, a, s = 4, 8, 30.0, 3.0, 2000
    readout_s = 1.0 / fps
    frame_ts = torch.from_numpy((np.arange(t) / fps).astype(np.float32))
    f = torch.from_numpy(((np.arange(ny) * 8.0 + 4.0) / (ny * 8.0)).astype(np.float32))
    ts = np.arange(s) / (s / (t / fps + 0.1))
    omega = np.stack([np.zeros(s), np.zeros(s), a * ts], axis=1)
    corr = torch.eye(3).expand(t, 3, 3)
    rows = trolling.rs_row_rotations_gyro(
        corr, torch.from_numpy(omega.astype(np.float32)),
        torch.from_numpy(ts.astype(np.float32)), frame_ts, readout_s, f).numpy()
    for ti in (1, 3):
        for j in (0, 7):
            tf = ti / fps + float(f[j]) * readout_s
            want = -(0.5 * a * tf * tf - 0.5 * a * (ti / fps) ** 2)
            got = np.arctan2(rows[ti, j][1, 0], rows[ti, j][0, 0])
            assert abs(got - want) < 2e-3, (ti, j, got, want)


# --- the plain per-tile-row warp against the oracle ----------------------------------


@pytest.mark.parametrize("crop_borders", [True, False])
def test_rs_warp_float_matches_xla_oracle(crop_borders):
    jin, jout = cameras(256, 192, crop_borders)
    oh, ow = jout.height - jout.height % 2, jout.width - jout.width % 2
    rots = row_rotations(tile_rows(oh))
    img = np.round(np.random.default_rng(0).uniform(0, 255, (192, 256))).astype(np.float32)
    want = np.asarray(warp_image_xla(jnp.asarray(img), jout, jin, jnp.asarray(rots), (oh, ow)))
    got = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(rots),
                                     to_port(jout), to_port(jin), (oh, ow)).numpy()
    assert got.shape == want.shape == (oh, ow)
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)
    one = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(rots[0]),
                                     to_port(jout), to_port(jin), (oh, ow)).numpy()
    np.testing.assert_array_equal(got[:8], one[:8])  # tile row 0 uses rotation 0
    assert np.abs(got[-8:] - one[-8:]).max() > 1.0  # the last one does not


def test_rs_warp_map_rows_take_their_tile_rows_rotation():
    """Row r of the per-tile-row map equals row r of the map of rotation
    r // 8, bit for bit: the stack only selects."""
    jin, jout = cameras(128, 96, True)
    out_cam, in_cam = to_port(jout), to_port(jin)
    size = (out_cam.height, out_cam.width)
    rots = torch.from_numpy(row_rotations(tile_rows(size[0]), 2))
    got = warp_plain.compute_warp_map(out_cam, in_cam, rots, size)
    for j in range(rots.shape[0]):
        want = warp_plain.compute_warp_map(out_cam, in_cam, rots[j], size)
        assert torch.equal(got[8 * j:8 * j + 8], want[8 * j:8 * j + 8]), j


@pytest.mark.parametrize("short_by", [1, 3])
def test_rs_warp_clips_the_row_index(short_by):
    """A stack shorter than ceil(out_h / 8): the rows beyond it take the
    last rotation, as the oracle clips (``warp_xla.py:56``)."""
    jin, jout = cameras(256, 192, True)
    oh, ow = jout.height - jout.height % 2, jout.width - jout.width % 2
    ny = tile_rows(oh) - short_by
    rots = row_rotations(ny, 1)
    img = np.round(np.random.default_rng(1).uniform(0, 255, (192, 256))).astype(np.float32)
    want = np.asarray(warp_image_xla(jnp.asarray(img), jout, jin, jnp.asarray(rots), (oh, ow)))
    args = (to_port(jout), to_port(jin), (oh, ow))
    got = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(rots), *args)
    np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL)
    padded = np.concatenate([rots] + [rots[-1:]] * short_by)
    full = warp_kernel.warp_frame_f32(torch.from_numpy(img), torch.from_numpy(padded), *args)
    assert torch.equal(got, full)
    ys = torch.from_numpy(img.astype(np.uint8))[None, None]
    got_u8 = warp_kernel.warp_planes_u8(ys, torch.from_numpy(rots)[None], *args)
    assert_u8_close(got_u8[0, 0].numpy(), np.clip(np.round(want), 0, 255))


def test_rs_warp_matches_pallas_interpret():
    """The Pallas kernel's ``rs`` mode in interpret mode, as the JAX
    package's own ``tests/test_rolling.py`` runs it, against the port's
    entries: the float luma warp and the one-frame uint8 YUV warp."""
    rng = np.random.default_rng(0)
    jin, jout = cameras(256, 192, True)
    oh, ow = jout.height - jout.height % 2, jout.width - jout.width % 2
    plan = plan_warp(jout, jin, 5.0, (oh, ow))
    rots = row_rotations(plan.grid[0], 4)
    frame = rng.integers(0, 255, (192, 256)).astype(np.float32)
    want = np.asarray(warp_frame_pallas(jnp.asarray(frame), jnp.asarray(rots), plan,
                                        jout, jin, interpret=True))
    got = warp_kernel.warp_frame_f32(torch.from_numpy(frame), torch.from_numpy(rots),
                                     to_port(jout), to_port(jin), (oh, ow)).numpy()
    assert np.abs(got - want).max() < 0.6  # the bar of tests/test_rolling.py:72

    in_half, out_half = _scaled_camera(jin, 0.5), _scaled_camera(jout, 0.5)
    plan_c = plan_warp(out_half, in_half, 5.0, (oh // 2, ow // 2))
    u = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    v = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    wy, wu, wv = warp_yuv_pallas(
        jnp.asarray(frame.astype(np.uint8)), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(rots), plan, jout, jin, plan_c, out_half, in_half, interpret=True)
    ty, tu, tv = FrameWarper(to_port(jin), to_port(jout)).warp_yuv(
        torch.from_numpy(frame.astype(np.uint8)), torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(rots))
    for got_p, want_p in ((ty, wy), (tu, wu), (tv, wv)):
        d = np.abs(got_p.numpy().astype(np.int16) - np.asarray(want_p).astype(np.int16))
        assert d.shape == got_p.shape and d.max() <= 1


# --- the chroma row rule and the FrameWarper entries -------------------------------------


@pytest.mark.parametrize("nyy,nyc", [(22, 11), (23, 12), (22, 12), (5, 9), (1, 4)])
def test_chroma_row_rule_matches_jax(nyy, nyc):
    """Chroma tile row j takes luma tile row 2j, clipped: for one frame's
    stack and for a batch's."""
    rot_y = np.arange(3 * nyy * 9, dtype=np.float32).reshape(3, nyy, 3, 3)
    for stack in (rot_y, rot_y[0]):
        want = np.asarray(_chroma_row_rotations(jnp.asarray(stack), nyc))
        got = warp_kernel.chroma_row_rotations(torch.from_numpy(stack), nyc)
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[-1], torch.from_numpy(rot_y[0, min(2 * (nyc - 1), nyy - 1)]))


def both_warpers(w=256, h=192, crop_borders=True):
    jin, jout = cameras(w, h, crop_borders)
    return JaxFrameWarper(jin, jout, 5.0), FrameWarper(to_port(jin), to_port(jout))


def test_frame_warper_rs_batch_matches_jax():
    jw, tw = both_warpers()
    t = 3
    ys, us, vs = yuv_frames(t, 256, 192, 0)
    rots = np.stack([row_rotations(tile_rows(tw.out_h), s) for s in range(t)])
    want = jw.warp_yuv_batch([jnp.asarray(y) for y in ys], [jnp.asarray(u) for u in us],
                             [jnp.asarray(v) for v in vs], jnp.asarray(rots))
    got = tw.warp_yuv_batch(torch.from_numpy(ys), torch.from_numpy(us),
                            torch.from_numpy(vs), torch.from_numpy(rots))
    assert len(got) == len(want) == t
    for g, w_ in zip(got, want):
        for gp, wp in zip(g, w_):
            assert gp.dtype == torch.uint8
            assert_u8_close(gp.numpy(), np.asarray(wp))


def test_frame_warper_rs_one_frame_and_float_match_jax():
    jw, tw = both_warpers(crop_borders=False)
    ys, us, vs = yuv_frames(1, 256, 192, 1)
    rots = row_rotations(tile_rows(tw.out_h), 7)
    want = jw.warp_yuv(jnp.asarray(ys[0]), jnp.asarray(us[0]), jnp.asarray(vs[0]),
                       jnp.asarray(rots))
    got = tw.warp_yuv(torch.from_numpy(ys[0]), torch.from_numpy(us[0]),
                      torch.from_numpy(vs[0]), torch.from_numpy(rots))
    for gp, wp in zip(got, want):
        assert_u8_close(gp.numpy(), np.asarray(wp))
    planes = [p[0].astype(np.float32) for p in (ys, us, vs)]
    want_f = jw(*(jnp.asarray(p) for p in planes), jnp.asarray(rots))
    got_f = tw(*(torch.from_numpy(p) for p in planes), torch.from_numpy(rots))
    for gp, wp in zip(got_f, want_f):
        assert gp.dtype == torch.float32
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=FLOAT_ATOL)
    # The batch entry on one frame is the one-frame entry.
    batch = tw.warp_yuv_batch(torch.from_numpy(ys), torch.from_numpy(us),
                              torch.from_numpy(vs), torch.from_numpy(rots)[None])
    for gp, bp in zip(got, batch[0]):
        assert torch.equal(gp, bp)


@pytest.mark.parametrize("shape", [(3, 3, 3), (2, 0, 3, 3), (2, 5, 3, 2), (1, 5, 3, 3), (5, 3, 3)])
def test_warp_entries_refuse_malformed_rotations(shape):
    jin, jout = cameras(64, 48, True)
    args = (to_port(jout), to_port(jin), (48, 64))
    src = torch.zeros((2, 1, 48, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rotations must be"):
        warp_kernel.warp_planes_u8(src, torch.zeros(shape), *args)
    if len(shape) != 3:
        with pytest.raises(ValueError, match="rotations must be"):
            warp_kernel.warp_frame_f32(torch.zeros((48, 64)), torch.zeros(shape), *args)


def test_rs_kernel_objects_name_what_they_replace():
    """The per-tile-row launches are counted under kernel objects of their
    own, each naming the ``rs`` line of its TPU build function; on CPU tensors no
    entry launches anything."""
    from video_annotator_tpu_torch.ops import cuda_lib

    lines = {"warp_luma_rs": 2163, "warp_chroma_rs": 2187, "warp_frame_f32_rs": 1784,
             "warp_planes_f32_rs": 1939, "warp_yuv_luma_rs": 2036, "warp_yuv_chroma_rs": 2061}
    source = (trender.__file__.rsplit("/", 3)[0]
              + "/video_annotator_tpu/ops/warp_pallas.py")
    with open(source) as f:
        text = f.read().splitlines()
    for name, line in lines.items():
        k = cuda_lib.KERNELS[name]
        assert k.replaces == f"video_annotator_tpu/ops/warp_pallas.py:{line}"
        assert "rs=rs" in text[line - 1], (name, text[line - 1])
        assert k.source == "video_annotator_tpu_torch/csrc/warp.cu"
    before = {n: k.launches for n, k in cuda_lib.KERNELS.items()}
    test_rs_warp_map_rows_take_their_tile_rows_rotation()
    assert before == {n: k.launches for n, k in cuda_lib.KERNELS.items()}


# --- the render ------------------------------------------------------------------------


SRC = "synthetic://shaky?w=256&h=192&n=10&seed=5&shake=0.006"


@pytest.mark.parametrize("kw", [
    dict(stabilise="smooth", stabilise_radius=4),
    dict(stabilise="fixed", horizon_lock=True, warp_batch=4),
])
def test_rolling_shutter_encode_matches_jax(tmp_path, kw):
    """The whole slice: one trajectory file, ``--encode-only
    --rolling-shutter`` through both packages (the velocity model)."""
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    cfg = SyntheticCamera(width=256, height=192, num_frames=10, seed=5, shake=0.006)
    r_true = torch.from_numpy(cfg.rotations())
    measured = tso3.matmul(tso3.transpose(r_true), r_true[0])
    JTrajectory(params=tso3.log(measured).numpy().astype(np.float64), fps=Fraction(30, 1),
                width=256, height=192, source=SRC).save(jdest + ".traj.npz")
    os.link(jdest + ".traj.npz", tdest + ".traj.npz")
    jrender_mod.render(SRC, jdest, JRenderOptions(
        rolling_shutter=0.75, encode_only=True, preset=JCameraPreset(PRESET), **kw))
    prof = trender.StageProfiler()
    trender.render(SRC, tdest, trender.RenderOptions(
        rolling_shutter=0.75, encode_only=True, preset=CameraPreset(PRESET), **kw),
        profiler=prof, device="cpu")
    assert "scanline" in prof.all_totals()[0]
    (jmeta, jframes), (tmeta, tframes) = read_frames(jdest), read_frames(tdest)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 10)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
    plain = str(tmp_path / "plain.y4m")
    os.link(jdest + ".traj.npz", plain + ".traj.npz")
    trender.render(SRC, plain, trender.RenderOptions(
        encode_only=True, preset=CameraPreset(PRESET), **kw), device="cpu")
    differing = [np.abs(a[0].astype(np.int16) - b[0].astype(np.int16)).max()
                 for a, b in zip(tframes, read_frames(plain)[1])]
    assert max(differing) > 1  # the scanline poses change the picture


def test_rolling_shutter_gyro_rows_come_from_telemetry(tmp_path, monkeypatch):
    """``--gyro --rolling-shutter`` on a source with telemetry takes the
    scanline poses from the gyro stream, in both packages alike; without
    telemetry it falls back to the velocity model; an error that is not
    "no telemetry" propagates."""
    path = str(tmp_path / "telemetry.mp4")
    cfg = SyntheticCamera(width=128, height=96, num_frames=12, seed=2)
    write_telemetry_mp4(path, cfg)
    opts = dict(gyro=True, rolling_shutter=0.75, stabilise="smooth", stabilise_radius=3)
    ttraj = trender.analyse_gyro(path, trender.RenderOptions(**opts), device="cpu")
    cam = get_preset_camera(CameraPreset(PRESET), (128, 96))
    meta = VideoMeta(128, 96, Fraction(30, 1), 12)
    in_cam, out_cam = trender.build_cameras(meta, trender.RenderOptions(
        preset=CameraPreset(PRESET), **opts))
    assert in_cam == cam
    ny = tile_rows(out_cam.height - out_cam.height % 2)
    corr = trender.compute_corrections(ttraj, trender.RenderOptions(**opts), device="cpu")
    rows = trender._scanline_corrections(
        path, ttraj, corr, trender.RenderOptions(**opts), meta, in_cam, out_cam, ny, "cpu")
    assert rows.shape == (12, ny, 3, 3) and rows.dtype == np.float32

    from video_annotator_tpu.io.gpmf import extract_gyro as jextract_gyro

    omega, gts = jextract_gyro(path)
    f_ts = jrender_mod._gyro_frame_times(path, gts)[0]
    jin, jout = cameras(128, 96, False, zoom=1 / 1.2)
    want = np.asarray(jrolling.rs_row_rotations_gyro(
        jnp.asarray(corr), jnp.asarray(omega, jnp.float32), jnp.asarray(gts, jnp.float32),
        jnp.asarray(f_ts, jnp.float32), 0.75 / 30.0,
        jrolling.scan_fractions(jout, jin, ny)))
    np.testing.assert_allclose(rows, want, atol=ATOL)

    velocity = trender._scanline_corrections(
        "synthetic://shaky?w=128&h=96&n=12", ttraj, corr, trender.RenderOptions(**opts),
        meta, in_cam, out_cam, ny, "cpu")
    want_v = trolling.rs_row_rotations(
        torch.from_numpy(corr), torch.from_numpy(ttraj.rotations()), 0.75,
        trolling.scan_fractions(out_cam, in_cam, ny)).numpy()
    np.testing.assert_array_equal(velocity, want_v)
    assert np.abs(velocity - rows).max() > 1e-5

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(trender, "rs_row_rotations_gyro", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        trender._scanline_corrections(path, ttraj, corr, trender.RenderOptions(**opts),
                                      meta, in_cam, out_cam, ny, "cpu")


def test_rolling_shutter_gyro_rows_trim_at_the_readers_frame_rate(tmp_path):
    """A trim window in seconds selects the scanline frame times at the
    frame rate of the encode's reader, as the reference's encode counts
    it (``render.py:1884-1891``), not at the rate of the telemetry's own
    frame grid: here a 60 fps reader over a 30 fps grid."""
    path = str(tmp_path / "telemetry.mp4")
    cfg = SyntheticCamera(width=128, height=96, num_frames=12, seed=2)
    write_telemetry_mp4(path, cfg)
    opts = dict(gyro=True, rolling_shutter=0.75, stabilise="smooth", stabilise_radius=3,
                start=0.1, duration=0.2)
    options = trender.RenderOptions(preset=CameraPreset(PRESET), **opts)
    meta = VideoMeta(128, 96, Fraction(60, 1), 12)
    in_cam, out_cam = trender.build_cameras(meta, options)
    ny = tile_rows(out_cam.height - out_cam.height % 2)

    from video_annotator_tpu.io.gpmf import extract_gyro as jextract_gyro

    omega, gts = jextract_gyro(path)
    all_ts = jrender_mod._gyro_frame_times(path, gts)[0]
    first, last = jrender_mod._frame_range(
        jrender_mod.VideoMeta(128, 96, Fraction(60, 1), len(all_ts)), JRenderOptions(**opts))
    assert (first, last) == (6, 12)  # at the grid's 30 fps it would be (3, 9)
    f_ts = all_ts[first:last]

    whole = trender.analyse_gyro(path, trender.RenderOptions(gyro=True), device="cpu")
    traj = Trajectory(params=whole.params[first:last], fps=Fraction(60, 1), width=128,
                      height=96, source=path)
    corr = trender.compute_corrections(traj, options, device="cpu")
    rows = trender._scanline_corrections(path, traj, corr, options, meta, in_cam, out_cam,
                                         ny, "cpu")
    jin, jout = cameras(128, 96, False, zoom=1 / 1.2)
    want = np.asarray(jrolling.rs_row_rotations_gyro(
        jnp.asarray(corr), jnp.asarray(omega, jnp.float32), jnp.asarray(gts, jnp.float32),
        jnp.asarray(f_ts, jnp.float32), 0.75 / 60.0,
        jrolling.scan_fractions(jout, jin, ny)))
    assert rows.shape == (6, ny, 3, 3)
    np.testing.assert_allclose(rows, want, atol=ATOL)


def test_gyro_frame_times_raise_for_a_video_no_reader_opens(tmp_path, monkeypatch):
    """Only a container whose tracks parse and hold no video gets the
    30 fps grid; a source the readers cannot open (a missing decoder) is
    an error, not a made-up frame rate."""
    path = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(path, SyntheticCamera(width=128, height=96, num_frames=12, seed=2))
    gts = np.linspace(0.0, 0.4, 161)

    def no_decoder(*args, **kwargs):
        raise ImportError("No module named 'cv2'")

    monkeypatch.setattr(trender, "open_reader", no_decoder)
    frame_ts, fps, w, h = trender._gyro_frame_times(path, gts)
    assert (len(frame_ts), fps, w, h) == (13, Fraction(30, 1), 0, 0)
    other = str(tmp_path / "video.mp4")
    with open(other, "wb") as f:
        f.write(b"not a container")
    with pytest.raises(ImportError, match="cv2"):
        trender._gyro_frame_times(other, gts)


def test_rs_render_removes_jello(tmp_path):
    """End to end (``tests/test_rolling.py:92-165`` for the port): an
    oscillating roll read out row by row makes jello; ``--rolling-shutter``
    with the known trajectory removes most of it."""
    W, H, N, readout, steps = 192, 144, 10, 1.0, 64
    cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (W, H))
    # Integrate the ray rotation R(t) once at fine steps; band j of frame
    # t is captured at time t + f_j * readout.
    poses = [torch.eye(3, dtype=torch.float64)]
    for k in range(N * steps + steps):
        rate = torch.tensor([0.0, 0.0, 0.05 * np.sin(2 * np.pi * (k / steps) / 10.0)],
                            dtype=torch.float64)
        poses.append(tso3.exp(rate / steps) @ poses[-1])

    def pose_at(time):
        return poses[int(round(time * steps))].to(torch.float32)

    src = str(tmp_path / "jello_src.y4m")
    wtr = open_writer(src, VideoMeta(W, H, Fraction(30, 1)))
    rotvecs = []
    for t in range(N):
        bands = []
        for j in range(H // 8):
            y, u, v = render_frame(cam, pose_at(t + (j * 8.0 + 4.0) / H * readout))
            bands.append((y.numpy()[j * 8:(j + 1) * 8], u.numpy()[j * 4:(j + 1) * 4],
                          v.numpy()[j * 4:(j + 1) * 4]))
        wtr.write(tuple(np.concatenate([b[i] for b in bands]) for i in range(3)))
        # The measured trajectory at scanline 0: M_t = R(t)^T.
        rotvecs.append(tso3.log(pose_at(float(t)).T).numpy())
    wtr.close()

    opts = dict(preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED, stabilise="fixed",
                encode_only=True)
    scores = {}
    for name, rs in (("plain", 0.0), ("rs", readout)):
        out = str(tmp_path / f"{name}.y4m")
        Trajectory(params=np.stack(rotvecs).astype(np.float64), kind="so3",
                   fps=Fraction(30, 1)).save(trajectory_path(out))
        trender.render(src, out, trender.RenderOptions(rolling_shutter=rs, **opts),
                       device="cpu")
        fs = [f[0].astype(np.float64) for f in read_frames(out)[1]]
        assert len(fs) == N
        h, w = fs[0].shape
        c = (slice(h // 4, -h // 4), slice(w // 4, -w // 4))
        # Fixed stabilisation of a static world: the frames should be
        # identical; what moves between them is the jello.
        scores[name] = np.mean([np.abs(f[c] - fs[0][c]).mean() for f in fs[1:]])
    assert scores["rs"] < scores["plain"] * 0.6, scores


def test_rs_rejects_wrong_modes(tmp_path):
    src = "synthetic://shaky?w=64&h=48&n=4"
    with pytest.raises(ValueError, match="rotation family"):
        trender.render(src, str(tmp_path / "o.y4m"),
                       trender.RenderOptions(filter="vidstab", rolling_shutter=0.7),
                       device="cpu")
    with pytest.raises(ValueError, match="two-phase"):
        trender.render(src, str(tmp_path / "o.y4m"),
                       trender.RenderOptions(rolling_shutter=0.7, streaming=True,
                                             stabilise="smooth"), device="cpu")
    from video_annotator_tpu_torch.pipeline import compare as tcompare

    with pytest.raises(ValueError, match="not supported with --compare"):
        tcompare.render_compare(src, None, ["none", "smooth"],
                                trender.RenderOptions(rolling_shutter=0.7), device="cpu")
    assert not os.listdir(tmp_path)
