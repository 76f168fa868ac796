"""Card-only tests: each CUDA kernel of the torch port against its plain
PyTorch version on the same CUDA inputs, at small sizes, and the render
path on the card against the same path on the CPU.

These skip without a CUDA device. On a machine with a card and without
JAX run them with ``pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository's ``tests/conftest.py`` configures JAX). This file imports
neither JAX nor the JAX package.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import (
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu_torch.models.similarity import (
    SimilarityWarper,
    warp_frame_similarity,
)
from video_annotator_tpu_torch.ops import lk_kernel, roofline_kernel, stage, warp_kernel
from video_annotator_tpu_torch.ops.warp_plain import scaled_camera
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory
from video_annotator_tpu_torch.tools import roofline

pytestmark = pytest.mark.cuda

MIN_EQUAL = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_u8_close(got, want):
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(d.max()) <= 1
    assert float((d == 0).float().mean()) >= MIN_EQUAL


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("pad_value,slack", [(0, 0), (128, 0), (0, 32)])
def test_stage_kernel_matches_plain(cuda, dtype, pad_value, slack):
    g = torch.Generator().manual_seed(0)
    src = torch.randint(-40, 600, (3, 45, 200), generator=g).to(torch.float32) * 0.5
    if dtype == torch.uint8:
        src = src.clamp(0, 255).to(torch.uint8)
    src = src.to(cuda)
    got = stage.stage_u8(src, pad_value=pad_value, slack=slack)
    want = stage.stage_u8_plain(src, pad_value=pad_value, slack=slack)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_warp_kernel_matches_plain(cuda):
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    oh, ow = out_cam.height // 2 * 2, out_cam.width // 2 * 2
    g = torch.Generator().manual_seed(1)
    ys = torch.randint(0, 256, (3, 240, 320), generator=g, dtype=torch.uint8).to(cuda)
    uv = torch.randint(0, 256, (3, 2, 120, 160), generator=g, dtype=torch.uint8).to(cuda)
    rots = so3.exp(torch.randn((3, 3), generator=g) * 0.03).to(cuda)
    for src, oc, ic, size, border in (
            (ys[:, None], out_cam, in_cam, (oh, ow), 0.0),
            (uv, scaled_camera(out_cam, 0.5), scaled_camera(in_cam, 0.5),
             (oh // 2, ow // 2), 128.0)):
        got = warp_kernel.warp_planes_u8(src, rots, oc, ic, size, border)
        want = warp_kernel.warp_planes_u8_plain(src, rots, oc, ic, size, border)
        torch.cuda.synchronize()
        assert_u8_close(got, want)


@pytest.mark.parametrize("planes,border", [(1, 0.0), (2, 128.0), (4, 128.0)])
@pytest.mark.parametrize("out_size", [None, (243, 321)])
def test_float_warp_kernel_matches_plain(cuda, planes, border, out_size):
    """K1's float mode (one plane, and P planes through one map) at even
    and odd output sizes: bit for bit, the same roundings in the same
    order as its plain version."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    size = out_size or (out_cam.height, out_cam.width)
    g = torch.Generator().manual_seed(5)
    src = torch.randint(0, 256, (planes, 240, 320), generator=g).to(torch.float32).to(cuda)
    rot = so3.exp(torch.randn(3, generator=g) * 0.03).to(cuda)
    kernel = warp_kernel.WARP_FRAME_F32 if planes == 1 else warp_kernel.WARP_PLANES_F32
    before = kernel.launches
    if planes == 1:
        got = warp_kernel.warp_frame_f32(src[0], rot, out_cam, in_cam, size, border)[None]
    else:
        got = warp_kernel.warp_planes_f32(src, rot, out_cam, in_cam, size, border)
    assert kernel.launches == before + 1
    want = warp_kernel.warp_planes_f32_plain(src, rot, out_cam, in_cam, size, border)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (planes, *size)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_size", [None, (242, 322), (360, 480)])
def test_one_frame_warp_kernel_matches_the_similarity_warp(cuda, out_size):
    """K1's uint8 mode with T = 1 over identity pinhole cameras and a
    similarity matrix, against ``warp_similarity`` rounded (odd chroma
    sizes and the upsample fold included): within one count."""
    # A smooth texture: on white noise a coordinate difference of 1e-5 px
    # between the two formulas flips the rounding of 0.2% of the pixels.
    y = shifted_chunk(cuda, [(0.0, 0.0)], 240, 320)[0].to(torch.uint8)
    u, v = shifted_chunk(cuda, [(3.0, 1.0), (-2.0, 5.0)], 120, 160).to(torch.uint8)
    params = np.array([[7.5, -4.25, 0.02, 0.03 - (math.log(1.5) if out_size else 0.0)]],
                      np.float32)
    warper = SimilarityWarper(320, 240, out_size=out_size)
    mat = torch.from_numpy(SimilarityWarper.matrices(params)[0]).to(cuda)
    before = (warp_kernel.WARP_YUV_LUMA.launches, warp_kernel.WARP_YUV_CHROMA.launches)
    got = warper.warp_yuv(y, u, v, mat)
    assert (warp_kernel.WARP_YUV_LUMA.launches,
            warp_kernel.WARP_YUV_CHROMA.launches) == (before[0] + 1, before[1] + 1)
    want = warp_frame_similarity(y.float(), u.float(), v.float(),
                                 torch.from_numpy(params[0]).to(cuda),
                                 out_size=out_size and (warper.out_h, warper.out_w))
    plain = warper.warp_yuv(y.cpu(), u.cpu(), v.cpu(), mat.cpu())
    torch.cuda.synchronize()
    for gp, wp, pp in zip(got, want, plain):
        assert gp.dtype == torch.uint8 and gp.shape == wp.shape
        assert_u8_close(gp, warp_kernel.to_u8(wp))
        assert_u8_close(gp.cpu(), pp)


def row_stack(generator, lead, ny, device):
    """``lead + (ny, 3, 3)`` rotations that drift down the frame."""
    base = torch.randn(lead + (1, 3), generator=generator) * 0.03
    drift = torch.randn(lead + (1, 3), generator=generator) * 0.03
    frac = (torch.arange(ny, dtype=torch.float32) / max(ny, 1))[:, None]
    return so3.exp(base + drift * frac).to(device)


@pytest.mark.parametrize("w,h,frames", [(320, 240, 3), (3840, 2880, 2)])
@pytest.mark.parametrize("short_by", [0, 5])
def test_rs_warp_entries_match_plain(cuda, w, h, frames, short_by):
    """K1's per-tile-row rotation mode through every entry, at a small
    shape and at the 4K shape, each against its plain version on the same
    card tensors: uint8 within one count and 99.9% equal, float within
    1e-3. ``short_by``: a stack shorter than ceil(out_h / 8), so the
    kernel's clip of the row index is exercised. Each launch is counted
    under the entry's ``rs`` kernel object and under no other."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    warper = trender.FrameWarper(in_cam, out_cam)
    oh, ow = warper.out_h, warper.out_w
    ny = -(-oh // 8) - short_by
    g = torch.Generator().manual_seed(7)
    ys = torch.randint(0, 256, (frames, h, w), generator=g, dtype=torch.uint8).to(cuda)
    us, vs = (torch.randint(0, 256, (frames, h // 2, w // 2), generator=g,
                            dtype=torch.uint8).to(cuda) for _ in range(2))
    rots = row_stack(g, (frames,), ny, cuda)
    rots_c = warp_kernel.chroma_row_rotations(rots, -(-(oh // 2) // 8))
    counts = lambda: {n: k.launches for n, k in warp_kernel.cuda_lib.KERNELS.items()}

    def launched(before):
        return {n: c - before[n] for n, c in counts().items() if c != before[n]}

    before = counts()
    got = warper.warp_yuv_batch(ys, us, vs, rots)
    assert launched(before) == {"warp_luma_rs": 1, "warp_chroma_rs": 1}
    want_y = warp_kernel.warp_planes_u8_plain(ys[:, None], rots, out_cam, in_cam, (oh, ow))
    want_c = warp_kernel.warp_planes_u8_plain(
        torch.stack([us, vs], dim=1), rots_c, warper.out_half, warper.in_half,
        (oh // 2, ow // 2), 128.0)
    torch.cuda.synchronize()
    for t, (gy, gu, gv) in enumerate(got):
        assert_u8_close(gy, want_y[t, 0])
        assert_u8_close(gu, want_c[t, 0])
        assert_u8_close(gv, want_c[t, 1])

    before = counts()
    one = warper.warp_yuv(ys[0], us[0], vs[0], rots[0])
    assert launched(before) == {"warp_yuv_luma_rs": 1, "warp_yuv_chroma_rs": 1}
    for gp, bp in zip(one, got[0]):
        assert torch.equal(gp, bp)

    before = counts()
    planes = (ys[0].float(), us[0].float(), vs[0].float())
    fy, fu, fv = warper(*planes, rots[0])
    assert launched(before) == {"warp_frame_f32_rs": 1, "warp_planes_f32_rs": 1}
    want_fy = warp_kernel.warp_planes_f32_plain(planes[0][None], rots[0], out_cam, in_cam,
                                                (oh, ow))[0]
    want_fc = warp_kernel.warp_planes_f32_plain(
        torch.stack(planes[1:]), rots_c[0], warper.out_half, warper.in_half,
        (oh // 2, ow // 2), 128.0)
    torch.cuda.synchronize()
    assert float((fy - want_fy).abs().max()) <= 1e-3
    assert float((torch.stack([fu, fv]) - want_fc).abs().max()) <= 1e-3
    # Tile row 0 is the whole-frame warp under the first rotation; a tile
    # row in the middle of the frame (the last ones show only border) is not.
    whole = warper.warp_yuv_batch(ys, us, vs, rots[:, 0])
    mid = oh // 16 * 8
    assert torch.equal(whole[0][0][:8], got[0][0][:8])
    assert not torch.equal(whole[0][0][mid:mid + 8], got[0][0][mid:mid + 8])


def test_integrate_gyro_on_card_matches_cpu(cuda):
    """The prefix product on the card against the same on the CPU: the
    same float32 products in the same order, up to the devices' exp."""
    from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro

    g = torch.Generator().manual_seed(9)
    n = 4000
    ts = torch.arange(n, dtype=torch.float32) / 400.0
    omega = torch.randn((n, 3), generator=g) * 0.5
    frame_ts = torch.arange(300, dtype=torch.float32) / 30.0 + 0.004
    host = integrate_gyro(omega, ts, frame_ts)
    card = integrate_gyro(omega.to(cuda), ts.to(cuda), frame_ts.to(cuda)).cpu()
    rel = so3.log(so3.matmul(card, so3.transpose(host))).norm(dim=-1)
    assert math.degrees(float(rel.max())) <= 0.01


def test_rolling_shutter_render_on_card_matches_cpu(cuda, tmp_path):
    """``--rolling-shutter --horizon-lock`` from one trajectory on both
    devices: the card's frames (through K1's per-tile-row mode) within one
    count of the CPU's (its plain version)."""
    from video_annotator_tpu_torch.io.video import open_reader

    src = "synthetic://shaky?w=640&h=480&n=8&seed=3"
    opts = dict(stabilise="smooth", stabilise_radius=3, rolling_shutter=0.75,
                horizon_lock=True, warp_batch=4,
                preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    dest = {d: str(tmp_path / f"{d}.y4m") for d in ("cpu", "cuda")}
    before = (warp_kernel.WARP_LUMA_RS.launches, warp_kernel.WARP_LUMA.launches)
    trender.render(src, dest["cuda"], trender.RenderOptions(**opts), device="cuda")
    assert warp_kernel.WARP_LUMA_RS.launches == before[0] + 2
    assert warp_kernel.WARP_LUMA.launches == before[1]
    traj = Trajectory.load(dest["cuda"] + ".traj.npz")
    trender.encode(src, dest["cpu"], traj, trender.RenderOptions(**opts), device="cpu")
    frames = [list(open_reader(dest[d])) for d in ("cpu", "cuda")]
    assert len(frames[0]) == len(frames[1]) == 8
    for a, b in zip(*frames):
        for pa, pb in zip(a, b):
            assert_u8_close(torch.from_numpy(np.array(pa)), torch.from_numpy(np.array(pb)))


def shifted_chunk(device, shifts, h=480, w=640):
    """Frames of a smooth analytic texture shifted by sub-pixel offsets."""
    y = torch.arange(h, dtype=torch.float64)[:, None]
    x = torch.arange(w, dtype=torch.float64)[None, :]
    frames = []
    for dx, dy in shifts:
        u, v = x - dx, y - dy
        img = (128 + 40 * torch.sin(u / 7.3) * torch.cos(v / 5.1)
               + 30 * torch.sin((u + v) / 11.7) + 20 * torch.cos(u / 3.9 - v / 6.2))
        frames.append(img)
    return torch.stack(frames).to(torch.float32).to(device)


def test_lk_kernel_matches_plain(cuda):
    shifts = [(0.0, 0.0), (2.25, -1.5), (4.5, 1.0), (3.0, 4.75)]
    frames = shifted_chunk(cuda, shifts)
    g = torch.Generator().manual_seed(2)
    pts = torch.stack([torch.rand(300, generator=g) * 600 + 20,
                       torch.rand(300, generator=g) * 440 + 20], dim=-1)
    pts = torch.cat([pts, torch.tensor([[320.0, 9.0], [5.0, 240.0], [630.0, 470.0]])])
    m = pts.shape[0]
    band = torch.arange(3).repeat_interleave(m).to(cuda)
    p = pts.repeat(3, 1).to(cuda)
    guess = (torch.randn((3 * m, 2), generator=g) * 0.5).to(cuda)
    staged = lk_kernel.stage_pyramid_pairs(frames)
    for level in (0, 1):
        got = lk_kernel.lk_level_pairs(staged[level], p / 2 ** level, band, guess, 8)
        want = lk_kernel.lk_level_pairs(staged[level].cpu(), p.cpu() / 2 ** level,
                                        band.cpu(), guess.cpu(), 8)
        torch.cuda.synchronize()
        ok = got[2].cpu() & want[2]
        assert float((got[2].cpu() == want[2]).float().mean()) >= 0.99
        assert int(ok.sum()) > 600
        for a, b in zip(got[:2], want[:2]):
            assert float((a.cpu() - b)[ok].abs().max()) <= 0.01


def test_lk_level_frame_kernel_matches_plain(cuda):
    """K2's per-frame form: prev and next windows from two separately
    staged frames."""
    frames = shifted_chunk(cuda, [(0.0, 0.0), (2.25, -1.5)])
    g = torch.Generator().manual_seed(4)
    pts = torch.stack([torch.rand(200, generator=g) * 600 + 20,
                       torch.rand(200, generator=g) * 440 + 20], dim=-1)
    pts = torch.cat([pts, torch.tensor([[320.0, 9.0], [5.0, 240.0], [630.0, 470.0]])])
    pts = pts.to(cuda)
    guess = (torch.randn(pts.shape, generator=g) * 0.5).to(cuda)
    prev, nxt = (lk_kernel.stage_pyramid(f) for f in frames)
    for level in (0, 1):
        pf, pi, ok = lk_kernel.level_args(prev[level], pts / 2 ** level, None, guess)
        got = lk_kernel.lk_level_frame(prev[level], nxt[level], pf, pi, 8)
        want = lk_kernel.lk_level_frame(prev[level].cpu(), nxt[level].cpu(), pf.cpu(),
                                        pi.cpu(), 8)
        torch.cuda.synchronize()
        got, want, ok = got.cpu(), want, ok.cpu()
        gst, wst = (got[:, 2] > 0.5) & ok, (want[:, 2] > 0.5) & ok
        assert float((gst == wst).float().mean()) >= 0.99
        both = gst & wst
        assert int(both.sum()) > 150
        assert float((got[:, :2] - want[:, :2])[both].abs().max()) <= 0.01
    before = lk_kernel.LK_LEVEL_FRAME.launches
    new_pts, status = lk_kernel.pyramidal_lk_packed(prev, nxt, (480, 640), pts,
                                                    torch.ones(len(pts), dtype=torch.bool,
                                                               device=cuda))
    assert lk_kernel.LK_LEVEL_FRAME.launches - before == sum(p is not None for p in prev)
    flow = (new_pts - pts)[status].median(dim=0).values.cpu()
    assert torch.allclose(flow, torch.tensor([2.25, -1.5]), atol=0.1)


def test_tracked_streaming_render_on_card_matches_cpu(cuda, tmp_path):
    src = "synthetic://shaky?w=320&h=240&n=12&seed=3"
    opts = dict(stabilise="smooth", analysis_mode="tracked", streaming=True,
                smoother="kalman", stabilise_radius=10, warp_batch=4,
                preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    trajs = {}
    for dev in ("cpu", "cuda"):
        dest = tmp_path / f"{dev}.y4m"
        trender.render(src, str(dest), trender.RenderOptions(**opts), device=dev)
        trajs[dev] = Trajectory.load(str(dest) + ".traj.npz")
    rel = so3.matmul(torch.from_numpy(trajs["cuda"].rotations()),
                     so3.transpose(torch.from_numpy(trajs["cpu"].rotations())))
    assert trajs["cuda"].num_frames == 12
    assert math.degrees(float(so3.log(rel).norm(dim=-1).max())) <= 0.05


def test_render_on_card_matches_cpu(cuda, tmp_path):
    src = "synthetic://shaky?w=640&h=480&n=12&seed=3"
    opts = dict(stabilise="smooth", analysis_mode="paired",
                preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    outs = {}
    for dev in ("cpu", "cuda"):
        dest = tmp_path / f"{dev}.y4m"
        trender.render(src, str(dest), trender.RenderOptions(**opts), device=dev)
        outs[dev] = (Trajectory.load(str(dest) + ".traj.npz"), dest)
    rel = so3.matmul(torch.from_numpy(outs["cuda"][0].rotations()),
                     so3.transpose(torch.from_numpy(outs["cpu"][0].rotations())))
    assert math.degrees(float(so3.log(rel).norm(dim=-1).max())) <= 0.05
    from video_annotator_tpu_torch.io.video import open_reader

    frames = [list(open_reader(str(outs[d][1]))) for d in ("cpu", "cuda")]
    assert len(frames[0]) == len(frames[1]) == 12
    # Same trajectory on both sides: encode the CPU one on the card too.
    trender.encode(src, str(tmp_path / "enc.y4m"), outs["cpu"][0],
                   trender.RenderOptions(**opts), device="cuda")
    for a, b in zip(frames[0], open_reader(str(tmp_path / "enc.y4m"))):
        for pa, pb in zip(a, b):
            assert_u8_close(torch.from_numpy(np.array(pa)), torch.from_numpy(np.array(pb)))


@pytest.mark.parametrize("flt", ["vidstab", "deshake"])
def test_2d_family_render_on_card_matches_cpu(cuda, tmp_path, flt):
    """One trajectory (the card's) encoded on both devices: frames within
    one count; the two analysers agree to a fraction of a pixel."""
    src = "synthetic://shaky?w=640&h=480&n=8&seed=3"
    opts = trender.RenderOptions(filter=flt, stabilise="smooth", stabilise_radius=3)
    dest = {d: str(tmp_path / f"{d}.y4m") for d in ("cpu", "cuda")}
    trender.render(src, dest["cuda"], opts, device="cuda")
    card = Trajectory.load(dest["cuda"] + ".traj.npz")
    trender.encode_2d(src, dest["cpu"], card, opts, device="cpu")
    from video_annotator_tpu_torch.io.video import open_reader

    for a, b in zip(open_reader(dest["cpu"]), open_reader(dest["cuda"])):
        for pa, pb in zip(a, b):
            assert_u8_close(torch.from_numpy(np.array(pa)), torch.from_numpy(np.array(pb)))
    trender.render(src, dest["cpu"], dataclasses.replace(opts, analyse_only=True),
                   device="cpu")
    host = Trajectory.load(dest["cpu"] + ".traj.npz")
    assert host.kind == card.kind and host.num_frames == card.num_frames == 8
    np.testing.assert_allclose(card.params[:, :2], host.params[:, :2], atol=0.05)
    np.testing.assert_allclose(card.params[:, 2:], host.params[:, 2:], atol=2e-4)


def test_compare_grid_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The four-way grid on both devices from the card's trajectories:
    rotation cells through K1's float mode, the similarity cell through
    its one-frame uint8 mode; within one count of the CPU's plain warps."""
    from video_annotator_tpu_torch.io.video import open_reader
    from video_annotator_tpu_torch.pipeline import compare

    src = "synthetic://shaky?w=640&h=480&n=6&seed=3"
    modes = ["none", "smooth", "vidstab", "deshake"]
    opts = trender.RenderOptions(stabilise_radius=2, cell_labels=False,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    seen = {}

    def once(name, fn):
        def wrapper(*args, **kwargs):
            if name not in seen:
                seen[name] = fn(*args, **kwargs)
            return seen[name]
        return wrapper

    for name in ("analyse", "analyse_similarity", "analyse_deshake"):
        monkeypatch.setattr(compare, name, once(name, getattr(compare, name)))
    names = ("warp_frame_f32", "warp_planes_f32", "warp_yuv_luma", "warp_yuv_chroma")
    before = {n: warp_kernel.cuda_lib.KERNELS[n].launches for n in names}
    compare.render_compare(src, str(tmp_path / "cuda.y4m"), modes, opts, device="cuda")
    after = {n: warp_kernel.cuda_lib.KERNELS[n].launches - before[n] for n in names}
    assert after == {"warp_frame_f32": 12, "warp_planes_f32": 12,
                     "warp_yuv_luma": 6, "warp_yuv_chroma": 6}
    assert len(seen) == 3  # the CPU run below reuses the card's trajectories
    compare.render_compare(src, str(tmp_path / "cpu.y4m"), modes, opts, device="cpu")
    frames = [list(open_reader(str(tmp_path / f"{d}.y4m"))) for d in ("cpu", "cuda")]
    assert len(frames[0]) == len(frames[1]) == 6
    for a, b in zip(*frames):
        for pa, pb in zip(a, b):
            assert_u8_close(torch.from_numpy(np.array(pa)), torch.from_numpy(np.array(pb)))


def mode_geometry(kind):
    """(out camera, in camera, interp, levels) of a small warp in K1's
    modes: 4 taps, an equirect output (ray grid), ``--scale 0.3`` of a
    cropped fit (mip levels 0 and 1), or all three at once (a fisheye
    output that minifies everywhere, with lanczos)."""
    from video_annotator_tpu_torch.camera import CameraModel, camera_from_dfov
    from video_annotator_tpu_torch.ops.mip import tile_levels

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    if kind in ("bicubic", "lanczos"):
        return get_output_camera(in_cam, zoom=1 / 1.2), in_cam, kind, None
    if kind == "rays":
        return camera_from_dfov(145.8, (160, 120), CameraModel.EQUIRECT), in_cam, "bilinear", None
    out_cam = (get_output_camera(in_cam, scale=0.3, crop_borders=True) if kind == "mip"
               else camera_from_dfov(100.0, (80, 60), CameraModel.FISHEYE))
    return out_cam, in_cam, "bilinear" if kind == "mip" else "lanczos", kind


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("entry", ["batch", "one_frame", "float"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("kind", ["bicubic", "lanczos", "rays", "mip", "all"])
def test_warp_modes_match_plain(cuda, kind, plane, entry, rs):
    """Each of K1's modes (and all three at once) through each entry, with
    one rotation per frame and one per tile row, against its plain version
    on the same card inputs; each launch counted once, under its variant's
    kernel object alone. Bit for bit in uint8 and in float (measured: 0
    differing values at 4K, ``chip_smoke.py``)."""
    from video_annotator_tpu_torch.ops.mip import tile_levels

    out_cam, in_cam, interp, mip = mode_geometry(kind)
    oh, ow = out_cam.height - out_cam.height % 2, out_cam.width - out_cam.width % 2
    border = 0.0
    if plane == "chroma":
        out_cam, in_cam = scaled_camera(out_cam, 0.5), scaled_camera(in_cam, 0.5)
        oh, ow, border = oh // 2, ow // 2, 128.0
    levels = tile_levels(out_cam, in_cam, 8.0, (oh, ow), interp, device=cuda) if mip else None
    if mip:
        assert levels.max_level >= 1
    planes = 1 if plane == "luma" else 2
    t = 3 if entry == "batch" else 1
    g = torch.Generator().manual_seed(7)
    src = torch.randint(0, 256, (t, planes, in_cam.height, in_cam.width), generator=g,
                        dtype=torch.uint8).to(cuda)
    ny = -(-oh // 8)
    rot = so3.exp(torch.randn((t, ny if rs else 1, 3), generator=g) * 0.02)
    rot = (rot if rs else rot[:, 0]).to(cuda)
    kw = dict(interp=interp, levels=levels)
    whole = {"batch": warp_kernel.BATCH_KERNELS[rs],
             "one_frame": warp_kernel.ONE_FRAME_KERNELS[rs],
             "float": (warp_kernel.FRAME_F32_KERNELS[rs],
                       warp_kernel.PLANES_F32_KERNELS[rs])}[entry][planes - 1]
    obj = warp_kernel.mode_kernel(whole, warp_kernel.variant(out_cam, interp, levels))
    before = {n: k.launches for n, k in warp_kernel.cuda_lib.KERNELS.items()}
    if entry == "float":
        src, rot = src[0].to(torch.float32), rot[0]
        got = (warp_kernel.warp_frame_f32(src[0], rot, out_cam, in_cam, (oh, ow), border,
                                          **kw)[None]
               if planes == 1 else
               warp_kernel.warp_planes_f32(src, rot, out_cam, in_cam, (oh, ow), border, **kw))
        want = warp_kernel.warp_planes_f32_plain(src, rot, out_cam, in_cam, (oh, ow), border,
                                                 interp, levels)
        assert torch.equal(got, want)
    else:
        kernels = warp_kernel.BATCH_KERNELS if entry == "batch" else warp_kernel.ONE_FRAME_KERNELS
        got = warp_kernel.warp_planes_u8(src, rot, out_cam, in_cam, (oh, ow), border,
                                         kernels=kernels, **kw)
        want = warp_kernel.warp_planes_u8_plain(src, rot, out_cam, in_cam, (oh, ow), border,
                                                interp, levels)
        assert torch.equal(got, want)
    moved = {n for n, k in warp_kernel.cuda_lib.KERNELS.items() if k.launches != before[n]}
    # A uint8 mip launch stages its levels through K3 first.
    assert moved == {obj.name} | ({"stage"} if mip and entry != "float" else set())
    assert obj.launches == before[obj.name] + 1


def test_whole_frame_launches_stay_bit_exact(cuda):
    """The bilinear, rectilinear-output, no-mip launches of every entry
    (``csrc/warp.cu``, untouched by the modes) equal their plain versions
    bit for bit."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, zoom=1 / 1.2)
    oh, ow = out_cam.height - out_cam.height % 2, out_cam.width - out_cam.width % 2
    g = torch.Generator().manual_seed(8)
    ys = torch.randint(0, 256, (3, 1, 240, 320), generator=g, dtype=torch.uint8).to(cuda)
    rot = so3.exp(torch.randn((3, 3), generator=g) * 0.02).to(cuda)
    for kernels in (warp_kernel.BATCH_KERNELS, warp_kernel.ONE_FRAME_KERNELS):
        before = kernels[False][0].launches
        got = warp_kernel.warp_planes_u8(ys, rot, out_cam, in_cam, (oh, ow), kernels=kernels)
        assert kernels[False][0].launches == before + 1
        assert torch.equal(got, warp_kernel.warp_planes_u8_plain(ys, rot, out_cam, in_cam,
                                                                 (oh, ow)))
    plane = ys[0].to(torch.float32)
    got = warp_kernel.warp_planes_f32(plane, rot[0], out_cam, in_cam, (oh, ow))
    assert torch.equal(got, warp_kernel.warp_planes_f32_plain(plane, rot[0], out_cam, in_cam,
                                                              (oh, ow)))


@pytest.mark.parametrize("interp,projection", [("bilinear", "rect"), ("bicubic", "rect"),
                                               ("lanczos", "rect"), ("bilinear", "stereographic"),
                                               ("bicubic", "equirect")])
def test_frame_batch_and_band_kernels_match_plain(cuda, interp, projection):
    """K1's float frame batch (row 6) and band (row 9) against their plain
    versions bit for bit, each launch counted under its own object, and
    the bands of 2, 3 and 4 ranks, concatenated and cropped, equal to the
    one-frame float launch (row 5) bit for bit."""
    from video_annotator_tpu_torch.camera import CameraModel, camera_from_dfov

    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, zoom=1 / 1.2)
    if projection != "rect":
        out_cam = camera_from_dfov(120.0, (out_cam.width, out_cam.height),
                                   CameraModel(projection))
    size = (out_cam.height, out_cam.width)
    g = torch.Generator().manual_seed(9)
    frames = torch.randint(0, 256, (5, 240, 320), generator=g).to(torch.float32).to(cuda)
    rots = so3.exp(torch.randn((5, 3), generator=g) * 0.03).to(cuda)
    suffix = warp_kernel.variant(out_cam, interp, None)
    batch = warp_kernel.mode_kernel(warp_kernel.WARP_FRAMES_F32, suffix) if suffix \
        else warp_kernel.WARP_FRAMES_F32
    band = warp_kernel.mode_kernel(warp_kernel.WARP_BAND_F32, suffix) if suffix \
        else warp_kernel.WARP_BAND_F32
    before = batch.launches
    got = warp_kernel.warp_frames_f32(frames, rots, out_cam, in_cam, size, interp=interp)
    assert batch.launches == before + 1
    want = warp_kernel.warp_frames_f32_plain(frames, rots, out_cam, in_cam, size, interp=interp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    whole = warp_kernel.warp_frame_f32(frames[0], rots[0], out_cam, in_cam, size, interp=interp)
    assert torch.equal(got[0], whole)
    for n in (2, 3, 4):
        rows = warp_kernel.band_tile_rows(size[0], n)
        bands = []
        for rank in range(n):
            before = band.launches
            b = warp_kernel.warp_frame_band_f32(frames[0], rots[0], out_cam, in_cam, size, n,
                                                rank * rows, interp=interp)
            assert band.launches == before + 1
            assert torch.equal(b, warp_kernel.warp_frame_band_f32_plain(
                frames[0], rots[0], out_cam, in_cam, size, n, rank * rows, interp=interp))
            bands.append(b)
        assert torch.equal(torch.cat(bands)[:size[0]], whole)


@pytest.mark.parametrize("tiles", [1, 3])
def test_roofline_probes_match_plain(cuda, tiles):
    """Rows 11 and 12 against their plain versions over 3 outer steps, bit
    for bit: the fused chain's plain version rounds each step once, as a
    fused multiply-add does."""
    x = roofline.fma_inputs(tiles, tiles, cuda)
    for u, fused in roofline_kernel.FMA_CHAIN:
        got = roofline_kernel.fma_chain(x, u, 3, fused)
        torch.cuda.synchronize()
        assert torch.equal(got, roofline_kernel.fma_chain_plain(x, u, 3, fused))
    seg, idx = roofline.gather_inputs(tiles, tiles, cuda)
    for u in roofline_kernel.GATHER_VISIT:
        got = roofline_kernel.gather_visits(seg, idx, u, 3)
        torch.cuda.synchronize()
        assert torch.equal(got, roofline_kernel.gather_visits_plain(seg, idx, u, 3))


@pytest.mark.parametrize("diag", [0, 1, 2, 3])
def test_luma_diag_builds_match_their_plain_twins(cuda, diag):
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    size = (out_cam.height, out_cam.width)
    g = torch.Generator().manual_seed(diag)
    ys = torch.randint(0, 256, (3, 240, 320), generator=g, dtype=torch.uint8).to(cuda)
    rots = so3.exp(torch.randn((3, 3), generator=g) * 0.03).to(cuda)
    got = warp_kernel.warp_luma_batch_diag(ys, rots, out_cam, in_cam, size, diag)
    torch.cuda.synchronize()
    assert torch.equal(got, warp_kernel.warp_luma_batch_diag_plain(ys, rots, out_cam, in_cam,
                                                                   size, diag))


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("frames", [1, 32])
@pytest.mark.parametrize("out_w,out_h", [(4679, 3517), (321, 243), (4680, 3520)])
def test_grouped_u8_kernel_is_bit_exact(cuda, out_w, out_h, frames, planes, rs):
    """K1's uint8 kernel, several columns a thread, at output widths that
    are not a multiple of its group (4679, 321) or are (4680), heights
    that are not a multiple of 8, one frame and the render's 32, one and
    two planes, one rotation per frame and one per tile row: 0 differing
    values from its plain version. A 4K source (its half for two planes)."""
    in_w, in_h = (3840, 2880) if planes == 1 else (1920, 1440)
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (3840, 2880))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    if planes == 2:
        in_cam, out_cam = scaled_camera(in_cam, 0.5), scaled_camera(out_cam, 0.5)
    g = torch.Generator().manual_seed(out_w + frames + planes)
    src = torch.randint(0, 256, (frames, planes, in_h, in_w), generator=g,
                        dtype=torch.uint8).to(cuda)
    ny = -(-out_h // 8)
    rots = row_stack(g, (frames,), ny, cuda) if rs else \
        so3.exp(torch.randn((frames, 3), generator=g) * 0.05).to(cuda)
    border = 0.0 if planes == 1 else 128.0
    kernel = warp_kernel.BATCH_KERNELS[rs][planes - 1]
    before = kernel.launches
    got = warp_kernel.warp_planes_u8(src, rots, out_cam, in_cam, (out_h, out_w), border)
    assert kernel.launches == before + 1
    for t in range(frames):  # the plain version a frame at a time: 4K floats are large
        want = warp_kernel.warp_planes_u8_plain(src[t:t + 1], rots[t:t + 1], out_cam, in_cam,
                                                (out_h, out_w), border)
        torch.cuda.synchronize()
        assert torch.equal(got[t:t + 1], want), f"frame {t}"


@pytest.mark.parametrize("out_w,out_h", [(321, 243), (4679, 3517)])
@pytest.mark.parametrize("diag", [1, 2, 3])
def test_luma_diag_builds_at_ragged_widths(cuda, diag, out_w, out_h):
    """Each diagnostic build of the grouped uint8 kernel against its plain
    twin at widths that are not a multiple of the group."""
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (3840, 2880))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    g = torch.Generator().manual_seed(diag + out_w)
    ys = torch.randint(0, 256, (3, 2880, 3840), generator=g, dtype=torch.uint8).to(cuda)
    rots = so3.exp(torch.randn((3, 3), generator=g) * 0.03).to(cuda)
    got = warp_kernel.warp_luma_batch_diag(ys, rots, out_cam, in_cam, (out_h, out_w), diag)
    torch.cuda.synchronize()
    assert torch.equal(got, warp_kernel.warp_luma_batch_diag_plain(
        ys, rots, out_cam, in_cam, (out_h, out_w), diag))


@pytest.mark.parametrize("form", ["pairs", "frame"])
@pytest.mark.parametrize("m", [1, 3, 200, 3200])
def test_lk_kernel_point_counts(cuda, form, m):
    """K2 at 1, 3, 200 and 3200 points, the counts that choose its threads
    per point, in both forms: status agreement >= 0.99 and flow within
    0.01 px of the plain version where both track, chip_smoke.py's bars."""
    frames = shifted_chunk(cuda, [(0.0, 0.0), (2.25, -1.5), (4.5, 1.0)])
    g = torch.Generator().manual_seed(m)
    pts = torch.stack([torch.rand(m, generator=g) * 600 + 20,
                       torch.rand(m, generator=g) * 440 + 20], dim=-1).to(cuda)
    guess = (torch.randn((m, 2), generator=g) * 0.5).to(cuda)
    if form == "pairs":
        staged = lk_kernel.stage_pyramid_pairs(frames)[0]
        band = torch.randint(0, 2, (m,), generator=g).to(cuda)
        pf, pi, ok = lk_kernel.level_args(staged, pts, band, guess)
        before = lk_kernel.LK_LEVEL.launches
        got = lk_kernel.lk_level(staged, pf, pi, 8)
        assert lk_kernel.LK_LEVEL.launches == before + 1
        want = lk_kernel.lk_level_plain(staged, staged, pf, pi, 8)
    else:
        prev, nxt = (lk_kernel.stage_pyramid(f)[0] for f in frames[:2])
        pf, pi, ok = lk_kernel.level_args(prev, pts, None, guess)
        before = lk_kernel.LK_LEVEL_FRAME.launches
        got = lk_kernel.lk_level_frame(prev, nxt, pf, pi, 8)
        assert lk_kernel.LK_LEVEL_FRAME.launches == before + 1
        want = lk_kernel.lk_level_plain(prev, nxt, pf, pi, 8)
    torch.cuda.synchronize()
    gst, wst = (got[:, 2] > 0.5) & ok, (want[:, 2] > 0.5) & ok
    assert float((gst == wst).float().mean()) >= 0.99
    both = gst & wst
    assert int(both.sum()) >= m // 2
    assert float((got[:, :2] - want[:, :2])[both].abs().max()) <= 0.01


RAGGED = [(4679, 3517), (321, 243), (4680, 3520)]  # (out_w, out_h): groups cut short, and not


def stock_geometry(out_w, planes):
    """(in camera, out camera, source (h, w)) of the grouped kernels' tests:
    a 4K fisheye to the stock canvas's camera for the 4K widths, a 320x240
    one for 321, each halved for chroma (more than one plane)."""
    in_w, in_h = (3840, 2880) if out_w > 1000 else (320, 240)
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (in_w, in_h))
    out_cam = get_output_camera(in_cam, zoom=1.0 / 1.2)
    if planes > 1:
        in_cam, out_cam = scaled_camera(in_cam, 0.5), scaled_camera(out_cam, 0.5)
        in_w, in_h = in_w // 2, in_h // 2
    return in_cam, out_cam, (in_h, in_w)


@pytest.mark.parametrize("rs", [False, True])
@pytest.mark.parametrize("planes", [1, 2, 3, 4])
@pytest.mark.parametrize("out_w,out_h", RAGGED)
def test_grouped_f32_kernel_is_bit_exact(cuda, out_w, out_h, planes, rs):
    """K1's float kernel (rows 5, 7), several columns a thread, at output
    widths that are not a multiple of its group (4679, 321) or are (4680),
    one to four planes, one rotation per frame and one per tile row: equal
    to its plain version bit for bit, on non-integer sources."""
    in_cam, out_cam, (in_h, in_w) = stock_geometry(out_w, planes)
    g = torch.Generator().manual_seed(out_w + 10 * planes + rs)
    src = (torch.rand((planes, in_h, in_w), generator=g) * 255).to(cuda)
    ny = -(-out_h // 8)
    rot = row_stack(g, (), ny, cuda) if rs else \
        so3.exp(torch.randn(3, generator=g) * 0.05).to(cuda)
    border = 0.0 if planes == 1 else 128.0
    kernel = (warp_kernel.FRAME_F32_KERNELS if planes == 1 else warp_kernel.PLANES_F32_KERNELS)[rs]
    before = kernel.launches
    got = (warp_kernel.warp_frame_f32(src[0], rot, out_cam, in_cam, (out_h, out_w), border)[None]
           if planes == 1 else
           warp_kernel.warp_planes_f32(src, rot, out_cam, in_cam, (out_h, out_w), border))
    assert kernel.launches == before + 1
    want = warp_kernel.warp_planes_f32_plain(src, rot, out_cam, in_cam, (out_h, out_w), border)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("frames", [1, 3, 8])
@pytest.mark.parametrize("out_w,out_h", RAGGED)
def test_grouped_f32_frame_batch_is_bit_exact(cuda, out_w, out_h, frames):
    """K1's float frame batch (row 6) at the ragged widths, 1, 3 and 8
    frames: bit for bit its plain version, frame 0 the one-frame launch."""
    in_cam, out_cam, (in_h, in_w) = stock_geometry(out_w, 1)
    g = torch.Generator().manual_seed(out_w + frames)
    src = (torch.rand((frames, in_h, in_w), generator=g) * 255).to(cuda)
    rots = so3.exp(torch.randn((frames, 3), generator=g) * 0.05).to(cuda)
    size = (out_h, out_w)
    got = warp_kernel.warp_frames_f32(src, rots, out_cam, in_cam, size)
    for t in range(frames):  # the plain version a frame at a time: 4K floats are large
        want = warp_kernel.warp_planes_f32_plain(src[t:t + 1], rots[t], out_cam, in_cam, size)
        torch.cuda.synchronize()
        assert torch.equal(got[t:t + 1], want), f"frame {t}"
    assert torch.equal(got[0], warp_kernel.warp_frame_f32(src[0], rots[0], out_cam, in_cam, size))


@pytest.mark.parametrize("nshards", [2, 3, 4])
@pytest.mark.parametrize("out_w,out_h", RAGGED)
def test_grouped_f32_bands_are_bit_exact(cuda, out_w, out_h, nshards):
    """K1's float band (row 9) at the ragged widths for 2, 3 and 4 ranks:
    each band bit for bit its plain version, counted under its object,
    and the bands, concatenated and cropped, the one-frame launch (row 5)."""
    in_cam, out_cam, (in_h, in_w) = stock_geometry(out_w, 1)
    g = torch.Generator().manual_seed(out_w + nshards)
    frame = (torch.rand((in_h, in_w), generator=g) * 255).to(cuda)
    rot = so3.exp(torch.randn(3, generator=g) * 0.05).to(cuda)
    size = (out_h, out_w)
    rows = warp_kernel.band_tile_rows(out_h, nshards)
    bands = []
    for rank in range(nshards):
        before = warp_kernel.WARP_BAND_F32.launches
        band = warp_kernel.warp_frame_band_f32(frame, rot, out_cam, in_cam, size, nshards,
                                               rank * rows)
        assert warp_kernel.WARP_BAND_F32.launches == before + 1
        assert torch.equal(band, warp_kernel.warp_frame_band_f32_plain(
            frame, rot, out_cam, in_cam, size, nshards, rank * rows))
        bands.append(band)
    whole = warp_kernel.warp_frame_f32(frame, rot, out_cam, in_cam, size)
    assert torch.equal(torch.cat(bands)[:out_h], whole)


def fit_camera(in_cam, size, zoom, model):
    """An output camera of ``size`` (h, w), centred, with the focal of the
    fitted rectilinear camera scaled to that size and divided by
    ``zoom``'s inverse: 0.8 sees past every edge of the source, 0.25
    minifies it enough for the mip levels."""
    from video_annotator_tpu_torch.camera import Camera

    h, w = size
    oc = get_output_camera(in_cam)
    s = min(w / oc.width, h / oc.height) * zoom
    return Camera.make(oc.fx * s, oc.fy * s, (w - 1) / 2, (h - 1) / 2, w, h, model)


MODE_ENTRIES = ["batch_luma", "batch_chroma", "one_frame", "frame", "planes", "frames", "band"]
# Every variant of csrc/warp_modes.cu through every entry that takes it:
# the frame batch and the band take no mip, as in the JAX package.
MODE_VARIANTS = [(interp, rays, mip, entry)
                 for interp in ("bilinear", "bicubic", "lanczos")
                 for rays in (False, True) for mip in (False, True)
                 if (interp, rays, mip) != ("bilinear", False, False)
                 for entry in MODE_ENTRIES if not (mip and entry in ("frames", "band"))]


@pytest.mark.parametrize("interp,rays,mip,entry", MODE_VARIANTS)
@pytest.mark.parametrize("out_w,out_h", RAGGED)
def test_grouped_mode_kernel_is_bit_exact(cuda, out_w, out_h, interp, rays, mip, entry):
    """K1's mode kernel (``csrc/warp_modes.cu``), several columns a thread,
    in every interp x ray grid x mip variant through every entry (the
    uint8 batch, luma and chroma, at 3 frames; the one-frame uint8 warp;
    the float frame, three float planes, the float frame batch at 3 frames
    and a band of 3 ranks, the last two without mip, as in the JAX package) at
    the ragged widths: bit for bit its plain version, counted under its
    variant's object. The maps reach past all four edges of the source
    (mip: a quarter of the fitted focal, so the levels engage); the
    chroma, one-frame and planes launches take one rotation per tile row.
    A ray-grid batch runs the frame-inner loop."""
    from video_annotator_tpu_torch.camera import CameraModel
    from video_annotator_tpu_torch.ops.mip import tile_levels

    chroma = entry in ("batch_chroma", "planes")
    in_cam, _, (in_h, in_w) = stock_geometry(out_w, 2 if chroma else 1)
    size = (out_h, out_w)
    model = CameraModel.STEREOGRAPHIC if rays else CameraModel.RECTILINEAR
    out_cam = fit_camera(in_cam, size, 0.25 if mip else 0.8, model)
    levels = tile_levels(out_cam, in_cam, 8.0, size, interp, device=cuda) if mip else None
    if mip:
        assert levels.max_level >= 1
    border = 128.0 if chroma else 0.0
    planes = {"batch_chroma": 2, "planes": 3}.get(entry, 1)
    t = {"batch_luma": 3, "batch_chroma": 3, "frames": 3}.get(entry, 1)
    rs = entry in ("batch_chroma", "one_frame", "planes")
    ny = -(-out_h // 8)
    g = torch.Generator().manual_seed(out_w + MODE_ENTRIES.index(entry))
    f32 = entry in ("frame", "planes", "frames", "band")
    if f32:
        src = (torch.rand((t * planes, in_h, in_w), generator=g) * 255).to(cuda)
    else:
        src = torch.randint(0, 256, (t, planes, in_h, in_w), generator=g,
                            dtype=torch.uint8).to(cuda)
    rot = (row_stack(g, (t,), ny, cuda) if rs else
           so3.exp(torch.randn((t, 3), generator=g) * 0.05).to(cuda))
    kw = dict(interp=interp)
    suffix = warp_kernel.variant(out_cam, interp, levels)
    counts = lambda: {n: k.launches for n, k in warp_kernel.cuda_lib.KERNELS.items()}
    before = counts()
    if entry == "frames":
        whole = warp_kernel.WARP_FRAMES_F32
        got = warp_kernel.warp_frames_f32(src, rot, out_cam, in_cam, size, border, **kw)
        want = torch.cat([warp_kernel.warp_planes_f32_plain(src[i:i + 1], rot[i], out_cam, in_cam,
                                                            size, border, interp)
                          for i in range(t)])
    elif entry == "band":
        whole = warp_kernel.WARP_BAND_F32
        rows = warp_kernel.band_tile_rows(out_h, 3)
        bands = [(warp_kernel.warp_frame_band_f32(src[0], rot[0], out_cam, in_cam, size, 3,
                                                  r * rows, border, **kw),
                  warp_kernel.warp_frame_band_f32_plain(src[0], rot[0], out_cam, in_cam, size, 3,
                                                        r * rows, border, interp))
                 for r in range(3)]
        assert all(torch.equal(b, plain_band) for b, plain_band in bands)
        got = torch.cat([b for b, _ in bands])[:out_h]
        want = warp_kernel.warp_planes_f32_plain(src, rot[0], out_cam, in_cam, size, border,
                                                 interp)[0]
    elif f32:
        kernels = warp_kernel.FRAME_F32_KERNELS if planes == 1 else warp_kernel.PLANES_F32_KERNELS
        whole = kernels[rs]
        got = (warp_kernel.warp_frame_f32(src[0], rot[0], out_cam, in_cam, size, border,
                                          levels=levels, **kw)[None]
               if planes == 1 else
               warp_kernel.warp_planes_f32(src, rot[0], out_cam, in_cam, size, border,
                                           levels=levels, **kw))
        want = warp_kernel.warp_planes_f32_plain(src, rot[0], out_cam, in_cam, size, border,
                                                 interp, levels)
    else:
        kernels = warp_kernel.ONE_FRAME_KERNELS if entry == "one_frame" else \
            warp_kernel.BATCH_KERNELS
        whole = kernels[rs][planes - 1]
        got = warp_kernel.warp_planes_u8(src, rot, out_cam, in_cam, size, border, kernels,
                                         levels=levels, **kw)
        want = torch.cat([warp_kernel.warp_planes_u8_plain(src[i:i + 1], rot[i:i + 1], out_cam,
                                                           in_cam, size, border, interp, levels)
                          for i in range(t)])
    torch.cuda.synchronize()
    launched = {n: c - before.get(n, 0) for n, c in counts().items() if c != before.get(n, 0)}
    obj = warp_kernel.mode_kernel(whole, suffix).name
    # a uint8 mip launch stages each of its levels through K3 first
    staged = {"stage": levels.max_level} if mip and not f32 else {}
    assert launched == {obj: 3 if entry == "band" else 1, **staged}
    assert got.shape == want.shape
    assert torch.equal(got, want)
    if not mip and entry in ("frame", "one_frame"):
        coords = warp_kernel.compute_warp_map(out_cam, in_cam, rot[0], size)
        x, y = coords[..., 0], coords[..., 1]
        assert bool((x < 0).any() and (x > in_w - 1).any() and (y < 0).any()
                    and (y > in_h - 1).any()), "the map does not reach every edge"


def test_device_reduce_sink_sums_on_the_card(cuda):
    """The checksum accumulates on the planes' device, wraps as int32 like
    the JAX package's, and is read once, in close()."""
    from video_annotator_tpu_torch.io.prefetch import DeviceReduceSink

    y = torch.full((2880, 3840), 255, dtype=torch.uint8, device=cuda)
    c = torch.full((1440, 1920), 255, dtype=torch.uint8, device=cuda)
    sink = DeviceReduceSink()
    for _ in range(3):
        sink.write((y, c, c))
    assert sink._acc.device.type == "cuda"
    sink.close()
    total = 3 * 255 * (2880 * 3840 + 2 * 1440 * 1920)
    assert sink.checksum == (total + 2**31) % 2**32 - 2**31


def test_crop_sink_slices_card_planes_before_the_readback(cuda):
    """CropSink in front of AsyncFrameWriter: the sink behind the readback
    receives the window of the card's planes, byte for byte."""
    from video_annotator_tpu_torch.io.prefetch import AsyncFrameWriter

    class Recorder:
        frames = []

        def write(self, planes):
            self.frames.append(planes)

        def close(self):
            pass

    g = torch.Generator().manual_seed(3)
    planes = (torch.randint(0, 256, (96, 128), generator=g, dtype=torch.uint8),
              torch.randint(0, 256, (48, 64), generator=g, dtype=torch.uint8),
              torch.randint(0, 256, (48, 64), generator=g, dtype=torch.uint8))
    rec = Recorder()
    sink = trender.CropSink(AsyncFrameWriter(rec), (40, 60, 8, 10))
    sink.write(tuple(p.to(cuda) for p in planes))
    sink.close()
    want = (planes[0][8:48, 10:70], planes[1][4:24, 5:35], planes[2][4:24, 5:35])
    for got, w in zip(rec.frames[0], want):
        assert np.array_equal(got, w.numpy())


def lk_texture(seed, w, h):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, size=(h // 4 + 2, w // 4 + 2)))
    img = torch.nn.functional.interpolate(img[None, None], scale_factor=4, mode="bilinear",
                                          align_corners=False)[0, 0, :h, :w]
    return img.to(torch.float32).contiguous()


def test_plain_level_replay_is_the_eager_level(cuda):
    """``lk_kernel.plain_level`` replays ``_lk_level`` as a CUDA graph on a
    card: the eager call's values bit for bit, call after call, for the
    pairs form's leading axis too."""
    from video_annotator_tpu_torch.ops.corners import detect_corners
    from video_annotator_tpu_torch.ops.lk import _lk_level

    for lead in ((), (3,)):
        frames = [lk_texture(s, 160, 120).to(cuda) for s in range(4)]
        pts, _ = detect_corners(frames[0].cpu(), max_corners=64, min_distance=8, border=12)
        pts = pts.to(cuda).expand(*lead, *pts.shape).contiguous()
        for a, b in zip(frames[:-1], frames[1:]):
            a, b = (x.expand(*lead, *x.shape).contiguous() for x in (a, b))
            guess = torch.full_like(pts, 0.75)
            want = _lk_level(a, b, pts, guess, 8)
            got = lk_kernel.plain_level(a, b, pts, guess, 8)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_lk_on_the_card_matches_the_cpu(cuda):
    """The plain ``pyramidal_lk`` (the quality tool's tracker on every
    device) on CUDA tensors against the same call on the CPU."""
    from video_annotator_tpu_torch.ops.corners import detect_corners
    from video_annotator_tpu_torch.ops.lk import pyramidal_lk

    a = lk_texture(1, 320, 240)
    b = torch.roll(a, shifts=(2, -3), dims=(0, 1))
    pts, valid = detect_corners(a, max_corners=200, min_distance=8, border=16)
    want_p, want_s = pyramidal_lk(a, b, pts, valid)
    got_p, got_s = (x.cpu() for x in pyramidal_lk(a.to(cuda), b.to(cuda), pts.to(cuda),
                                                    valid.to(cuda)))
    assert float((got_s == want_s).float().mean()) >= 0.995
    both = got_s & want_s
    assert int(both.sum()) > 50
    assert float((got_p[both] - want_p[both]).abs().max()) <= 1e-3


def test_quality_tracker_graph_replays_the_eager_calls(cuda):
    """``tools/quality.py`` replays its corner detection and LK as one
    CUDA graph: the same values as the eager calls, frame after frame."""
    from video_annotator_tpu_torch.ops import cuda_lib
    from video_annotator_tpu_torch.tools import quality

    frames = [lk_texture(s, 240, 180).to(cuda) for s in range(4)]
    replay = cuda_lib.graphed(quality.track, frames[0], frames[1])
    for a, b in zip(frames[:-1], frames[1:]):
        want = quality.track(a, b)
        got = replay(a, b)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["tracked", "paired"])
def test_card_tracker_keeps_the_quality_clips_large_step(cuda, tmp_path, mode):
    """ROADMAP.md section 3's closed fault 1. Over the quality tool's
    default clip (640x480, 150 frames; frames 97 to 98 move 13.4 px) the
    card's analysers track the three levels the plain LK tracks (K2 on the
    two it stages, the plain level on the 160x120 one) and read under the
    tool's 0.1 deg guard."""
    from video_annotator_tpu_torch.pipeline.trajectory import trajectory_path
    from video_annotator_tpu_torch.tools import quality

    src = "synthetic://shaky?w=640&h=480&n=150&seed=11&shake=0.008&pan=0.002"
    opts = trender.RenderOptions(stabilise="smooth", analysis_mode=mode,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    dest = str(tmp_path / f"{mode}.y4m")
    before = (lk_kernel.PLAIN_LEVEL.launches, lk_kernel.LK_LEVEL.launches,
              lk_kernel.LK_LEVEL_FRAME.launches)
    trender.analyse(src, opts, device=cuda).save(trajectory_path(dest))
    assert lk_kernel.PLAIN_LEVEL.launches > before[0]
    assert (lk_kernel.LK_LEVEL.launches if mode == "paired"
            else lk_kernel.LK_LEVEL_FRAME.launches) > before[1 if mode == "paired" else 2]
    rms = quality.traj_rms_deg(dest, src)
    assert rms < 0.1, rms


@pytest.mark.parametrize("mode", ["tracked", "paired"])
def test_card_4k_analyse_runs_no_plain_level(cuda, mode):
    """The stock 4K analyse tracks at 1920x1440, where K2 stages all three
    levels: K2 launches, the plain level does not."""
    src = "synthetic://shaky?w=3840&h=2880&n=6"
    opts = trender.RenderOptions(stabilise="smooth", analysis_mode=mode,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    plain, pairs, frame = (lk_kernel.PLAIN_LEVEL.launches, lk_kernel.LK_LEVEL.launches,
                           lk_kernel.LK_LEVEL_FRAME.launches)
    trender.analyse(src, opts, device=cuda)
    assert lk_kernel.PLAIN_LEVEL.launches == plain
    assert (lk_kernel.LK_LEVEL.launches - pairs if mode == "paired"
            else lk_kernel.LK_LEVEL_FRAME.launches - frame) >= 3


def test_calibrate_on_the_card_matches_the_cpu(cuda):
    """The Adam loop replayed as a CUDA graph and the LM polish on the
    card against the same fit on the CPU."""
    from video_annotator_tpu_torch import calibrate
    from video_annotator_tpu_torch.camera import Camera, CameraModel

    true = Camera.make(300.0, 302.0, 321.0, 238.0, 640, 480, CameraModel.FISHEYE,
                       dist=(0.03, -0.01, 0.0, 0.0))
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() - 4, ys.ravel() - 2.5, np.zeros(54)], axis=1)
    rng = np.random.default_rng(0)
    rot = so3.exp(torch.from_numpy(rng.normal(size=(8, 3)) * 0.25).to(torch.float32))
    t = torch.from_numpy(np.stack([rng.normal(size=8) * 0.3, rng.normal(size=8) * 0.3,
                                   3.0 + rng.uniform(size=8)], 1)).to(torch.float32)
    pts = torch.einsum("vij,nj->vni", rot, torch.from_numpy(obj).to(torch.float32)) + t[:, None]
    img = true.project(pts).numpy() + rng.normal(size=(8, 54, 2)) * 0.05
    want, want_rms = calibrate.calibrate(obj, img, (640, 480), steps=1500, device="cpu")
    got, got_rms = calibrate.calibrate(obj, img, (640, 480), steps=1500, device=cuda)
    np.testing.assert_allclose([got.fx, got.fy, got.cx, got.cy],
                               [want.fx, want.fy, want.cx, want.cy], rtol=1e-3)
    assert abs(got_rms - want_rms) <= 0.01 and got_rms < 0.5


def test_undistort_on_the_card_matches_the_plain_warp(cuda):
    from video_annotator_tpu_torch import calibrate
    from video_annotator_tpu_torch.camera import Camera, CameraModel

    cam = Camera.make(300.0, 302.0, 321.0, 238.0, 640, 480, CameraModel.FISHEYE,
                      dist=(0.02, -0.005, 0.0, 0.0))
    gray = lk_texture(3, 640, 480).round().clamp(0, 255).to(torch.uint8).numpy()
    got = torch.from_numpy(calibrate.undistort(gray, cam, cuda))
    want = torch.from_numpy(calibrate.undistort(gray, cam, "cpu"))
    assert_u8_close(got, want)


def test_fidelity_on_the_card_passes_the_gate(cuda, tmp_path):
    import json

    from video_annotator_tpu_torch.tools import fidelity

    out = tmp_path / "fidelity.json"
    assert fidelity.main(["--size", "640x480", "--batch", "4", "--dispatches", "2",
                          "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["route"] == "the CUDA kernels" and r["psnr_ok"] and r["families_psnr_ok"]
