"""The torch port's measurement path against the JAX package: the plain
versions of the roofline probes (rows 11 and 12) against the Pallas
microkernels of ``benchmarks/roofline.py`` in interpret mode, K1's
diagnostic twins, the roofline tool's floor arithmetic, the ported
Savitzky-Golay ``smooth_rotations`` and the ``benchtool`` CLI, on the CPU."""

import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from video_annotator_tpu import so3 as jso3
from video_annotator_tpu.ops.warp_xla import bilinear_sample as jax_bilinear_sample
from video_annotator_tpu.smoothing.savgol import smooth_rotations as jax_smooth_rotations
from video_annotator_tpu_torch import benchtool, so3
from video_annotator_tpu_torch.camera import (
    CameraModel,
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu_torch.ops import lk_kernel, roofline_kernel, warp_kernel, warp_plain
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.smoothing.savgol import smooth_rotations
from video_annotator_tpu_torch.tools import roofline

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5  # XLA's CPU backend contracts the chain's product and sum into one FMA
MIN_EQUAL = 0.999  # uint8 outputs: within 1 count, at least 99.9% equal
NO_MAP = warp_kernel.DIAG_NO_MAP
NO_TAPS = warp_kernel.DIAG_NO_TAPS


@pytest.fixture(scope="module")
def jax_roofline():
    """``benchmarks/roofline.py`` loaded from its path, as it is."""
    spec = importlib.util.spec_from_file_location("_jax_roofline", ROOT / "benchmarks" / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpreted(jax_roofline, monkeypatch):
    """The JAX tool with its ``pl`` replaced by a namespace whose
    ``pallas_call`` runs in interpret mode."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jax_roofline, "pl", ns)
    return jax_roofline


def gather_arrays(seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 2 ** 31, (8, 128), dtype=np.int32)
    idx = rng.integers(0, 128, (8, 128), dtype=np.int32)
    idx[0, :4] = 127  # the second gather's mask
    return seg, idx


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("unroll", [8, 64])
@pytest.mark.parametrize("outer", [1, 5])
def test_fma_chain_plain_matches_jax(interpreted, monkeypatch, outer, unroll, fused):
    monkeypatch.setattr(interpreted, "OUTER", outer)
    x = np.random.default_rng(outer * 100 + unroll).uniform(0.25, 1.0, (8, 128)).astype(np.float32)
    want = np.asarray(interpreted._fma_kernel(unroll)(jnp.asarray(x)))
    got = roofline_kernel.fma_chain(torch.from_numpy(x)[None], unroll, outer, fused)
    assert got.shape == (1, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("unroll", [2, 8])
@pytest.mark.parametrize("outer", [1, 5])
def test_gather_visits_plain_matches_jax(interpreted, monkeypatch, outer, unroll):
    monkeypatch.setattr(interpreted, "OUTER", outer)
    seg, idx = gather_arrays(outer * 10 + unroll)
    want = np.asarray(interpreted._gather_kernel(unroll)(jnp.asarray(seg), jnp.asarray(idx)))
    got = roofline_kernel.gather_visits(torch.from_numpy(seg)[None], torch.from_numpy(idx)[None],
                                        unroll, outer)
    assert got.shape == (1, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=0)


def test_probes_take_tiles_independently():
    """n tiles in one call give what each tile gives alone (one block each
    in the kernels)."""
    x = roofline.fma_inputs(3, 0, "cpu")
    seg, idx = roofline.gather_inputs(3, 1, "cpu")
    for fused in (False, True):
        whole = roofline_kernel.fma_chain(x, 8, 2, fused)
        for i in range(3):
            assert torch.equal(whole[i:i + 1], roofline_kernel.fma_chain(x[i:i + 1], 8, 2, fused))
    whole = roofline_kernel.gather_visits(seg, idx, 8, 2)
    for i in range(3):
        assert torch.equal(whole[i:i + 1],
                           roofline_kernel.gather_visits(seg[i:i + 1], idx[i:i + 1], 8, 2))
    assert bool((idx[:, -1, -1] == 127).all())


def test_fused_plain_rounds_each_step_once():
    """The fused plain version is a float64 step rounded once: one step
    differs from the unfused product-then-sum on some inputs."""
    x = roofline.fma_inputs(4, 3, "cpu")
    once = roofline_kernel.fma_chain_plain(x, 1, 1, fused=True)
    want = torch.from_numpy((x.double().numpy() * np.float64(np.float32(0.999999))
                             + x.double().numpy()).astype(np.float32))
    assert torch.equal(once, want)
    assert not torch.equal(roofline_kernel.fma_chain_plain(x, 64, 2, fused=True),
                           roofline_kernel.fma_chain_plain(x, 64, 2, fused=False))


def test_probe_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="must be"):
        roofline_kernel.fma_chain(torch.zeros((8, 128)), 8, 1)
    with pytest.raises(ValueError, match="must be"):
        roofline_kernel.fma_chain(torch.zeros((1, 8, 128), dtype=torch.float64), 8, 1)
    with pytest.raises(ValueError, match="must be"):
        roofline_kernel.gather_visits(torch.zeros((1, 8, 128), dtype=torch.int32),
                                      torch.zeros((1, 8, 128), dtype=torch.int64), 2, 1)
    with pytest.raises(ValueError, match="differ"):
        roofline_kernel.gather_visits(torch.zeros((2, 8, 128), dtype=torch.int32),
                                      torch.zeros((1, 8, 128), dtype=torch.int32), 2, 1)
    with pytest.raises(ValueError, match="outer"):
        roofline_kernel.fma_chain(torch.zeros((1, 8, 128)), 8, -1)


def test_kernel_objects_are_named_by_unroll_and_arithmetic():
    names = [k.name for k in roofline_kernel.FMA_CHAIN.values()]
    assert names == ["fma_chain_u8", "fma_chain_u64", "fma_chain_fused_u8", "fma_chain_fused_u64"]
    assert [k.name for k in roofline_kernel.GATHER_VISIT.values()] == [
        "gather_visit_u2", "gather_visit_u8"]
    assert [k.name for k in warp_kernel.LUMA_DIAG_KERNELS.values()] == [
        "warp_luma_diag_no_taps", "warp_luma_diag_no_map", "warp_luma_diag_no_map_no_taps"]
    for k in list(roofline_kernel.FMA_CHAIN.values()) + list(roofline_kernel.GATHER_VISIT.values()):
        assert k.source == "video_annotator_tpu_torch/csrc/roofline.cu"
        assert k.replaces in ("benchmarks/roofline.py:97", "benchmarks/roofline.py:148")


def luma_case(seed=0, frames=2, size=(96, 72)):
    w, h = size
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    g = torch.Generator().manual_seed(seed)
    ys = torch.randint(0, 256, (frames, h, w), generator=g, dtype=torch.uint8)
    rots = so3.exp(torch.randn((frames, 3), generator=g) * 0.03)
    return ys, rots, out_cam, in_cam, (out_cam.height, out_cam.width)


def test_diag_zero_is_the_luma_warp():
    ys, rots, oc, ic, size = luma_case()
    got = warp_kernel.warp_luma_batch_diag(ys, rots, oc, ic, size, 0)
    assert torch.equal(got, warp_kernel.warp_planes_u8_plain(ys[:, None], rots, oc, ic, size)[:, 0])
    assert torch.equal(got, warp_kernel.warp_yuv_batch(
        ys, ys[:, ::2, ::2], ys[:, ::2, ::2], rots, oc, ic, oc, ic, size)[0])


def scaled_coords_np(in_size, out_size):
    (in_h, in_w), (out_h, out_w) = in_size, out_size
    sx = np.float32(in_w) / np.float32(out_w)
    sy = np.float32(in_h) / np.float32(out_h)
    xs = np.arange(out_w, dtype=np.float32) * sx
    ys = np.arange(out_h, dtype=np.float32) * sy
    return np.stack(np.broadcast_arrays(xs[None, :], ys[:, None]), axis=-1)


def test_diag_no_map_is_the_taps_at_scaled_identity_coordinates():
    ys, rots, oc, ic, size = luma_case(1)
    got = warp_kernel.warp_luma_batch_diag(ys, rots, oc, ic, size, NO_MAP)
    coords = scaled_coords_np(tuple(ys.shape[-2:]), size)
    assert coords[..., 0].max() < ys.shape[-1] and coords[..., 1].max() < ys.shape[-2]
    for t in range(ys.shape[0]):
        want = warp_kernel.to_u8(warp_plain.bilinear_sample(ys[t], torch.from_numpy(coords)))
        assert torch.equal(got[t], want)
        jax_want = np.asarray(jax_bilinear_sample(jnp.asarray(ys[t].numpy()), jnp.asarray(coords)))
        d = np.abs(got[t].numpy().astype(np.int16) - np.clip(np.rint(jax_want), 0, 255))
        assert d.max() <= 1 and (d == 0).mean() >= MIN_EQUAL


def test_diag_no_taps_is_the_warp_of_a_flat_plane():
    ys, rots, oc, ic, size = luma_case(2)
    got = warp_kernel.warp_luma_batch_diag(ys, rots, oc, ic, size, NO_TAPS)
    flat = torch.full_like(ys, warp_kernel.DIAG_TAP)
    assert torch.equal(got, warp_kernel.warp_planes_u8_plain(flat[:, None], rots, oc, ic, size)[:, 0])
    # The source's values do not reach it; the map does (the border where it leaves the image).
    assert torch.equal(got, warp_kernel.warp_luma_batch_diag(255 - ys, rots, oc, ic, size, NO_TAPS))
    assert not torch.equal(got, warp_kernel.warp_luma_batch_diag(ys, rots.flip(0), oc, ic, size,
                                                                 NO_TAPS))
    assert int((got == warp_kernel.DIAG_TAP).sum()) > got.numel() // 2


def test_diag_no_map_no_taps_depends_on_the_shapes_alone():
    ys, rots, oc, ic, size = luma_case(3)
    got = warp_kernel.warp_luma_batch_diag(ys, rots, oc, ic, size, NO_MAP | NO_TAPS)
    again = warp_kernel.warp_luma_batch_diag(255 - ys, rots.flip(0), oc, ic, size, NO_MAP | NO_TAPS)
    assert torch.equal(got, again) and torch.equal(got[0], got[1])
    assert bool((got[:, :-1, :-1] == warp_kernel.DIAG_TAP).all())


def test_diag_rejects_what_its_kernels_do_not_take():
    ys, rots, oc, ic, size = luma_case()
    with pytest.raises(ValueError, match="diag must be"):
        warp_kernel.warp_luma_batch_diag(ys, rots, oc, ic, size, 4)
    with pytest.raises(ValueError, match="one 3x3 per frame"):
        warp_kernel.warp_luma_batch_diag(ys, rots[:, None].expand(-1, 3, 3, 3), oc, ic, size,
                                         NO_MAP)
    with pytest.raises(ValueError, match="uint8"):
        warp_kernel.warp_luma_batch_diag(ys.float(), rots, oc, ic, size, NO_TAPS)
    equirect = dataclasses.replace(oc, model=CameraModel.EQUIRECT)
    with pytest.raises(ValueError, match="rectilinear"):
        warp_kernel.warp_luma_batch_diag(ys, rots, equirect, ic, size, NO_MAP)


def test_k1_roofline_arithmetic():
    ns = {"full": 0.1, "no_taps": 0.06, "no_map": 0.07, "no_map_no_taps": 0.02}
    r = roofline.k1_roofline(20e12, 4e12, ns, 48, 30e12)
    terms = r["floor_terms_ns_per_pixel"]
    assert terms["operations"] == pytest.approx(68 / 20e12 * 1e9)
    assert terms["gathers"] == pytest.approx(4 / 4e12 * 1e9)
    assert terms["bytes"] == pytest.approx(2 / 3.35e12 * 1e9)
    assert r["binds"] == "operations"
    assert r["floor_ns_per_pixel"] == pytest.approx(0.0034)
    assert r["headroom"] == pytest.approx(1 - 0.0034 / 0.1)
    assert r["parts_ns_per_pixel"] == pytest.approx(
        {"map": 0.03, "taps": 0.04, "scaffolding": 0.02, "overlap": 0.01})
    floors = r["part_floors_ns_per_pixel"]
    assert floors["map"] == pytest.approx((48 - roofline.NO_MAP_OPS) / 20e12 * 1e9)
    assert floors["taps"] == pytest.approx(terms["gathers"])
    assert floors["scaffolding"] == pytest.approx((20 + roofline.NO_MAP_OPS) / 20e12 * 1e9)
    assert r["issue_slots_per_pixel"] == pytest.approx(
        {"full": 3000, "no_taps": 1800, "no_map": 2100, "no_map_no_taps": 600})
    # Slow gathers bind instead; fast arithmetic and gathers leave the bytes.
    assert roofline.k1_roofline(20e12, 0.5e12, ns, 48, 30e12)["binds"] == "gathers"
    fast = roofline.k1_roofline(1e15, 1e15, ns, 48, 30e12)
    assert fast["binds"] == "bytes" and fast["floor_ns_per_pixel"] == pytest.approx(
        2 / 3.35e12 * 1e9)


def test_bound_is_the_larger_of_bytes_and_operations():
    """``chip_smoke.py``'s bound of a timed call: 3.35 GB take 1 ms, 67
    GFLOP take 1 ms; the slower of the two binds."""
    assert roofline.bound(3.35e9, 1e9) == pytest.approx(
        {"bound_ms": 1.0, "bound_by": "bytes"})
    b = roofline.bound(1e9, 2 * 67e9)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(2.0)


def test_k1_map_ops_follow_the_input_camera():
    ys, rots, oc, ic, size = luma_case()
    assert roofline.map_ops(ic) == roofline.MAP_OPS_RECT + roofline.FISHEYE_OPS
    assert roofline.map_ops(oc) == roofline.MAP_OPS_RECT


@pytest.mark.parametrize("tool,argv", [(roofline.main, []), (roofline.main, ["--out", "x.json"]),
                                       (benchtool.main, ["--size", "64x48"])])
def test_tools_refuse_to_measure_without_a_card(monkeypatch, tmp_path, capsys, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert tool(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("radius,frames", [(5, 40), (90, 600)])
def test_smooth_rotations_matches_jax(radius, frames):
    rng = np.random.default_rng(radius)
    vecs = np.cumsum(rng.normal(size=(frames, 3)) * 0.01, axis=0).astype(np.float32)
    want = np.asarray(jax_smooth_rotations(jso3.exp(jnp.asarray(vecs)), radius))
    got = smooth_rotations(so3.exp(torch.from_numpy(vecs)), radius)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


PLAIN_ROWS = ("warp (plain)", "detect_corners", "pyramidal_lk (256 pts, plain)",
              "sg smooth (600 frames, r=90)")


@pytest.mark.parametrize("size", ["64x48", "320x240"])
def test_benchtool_runs_the_plain_rows_on_the_cpu(capsys, size):
    assert benchtool.main(["--size", size, "--reps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and size in out
    rows = [line for line in out.splitlines() if line.startswith(PLAIN_ROWS)]
    assert [r[:len(n)] for r, n in zip(rows, PLAIN_ROWS)] == list(PLAIN_ROWS)
    assert all(" ms " in r and "±" in r for r in rows)
    assert "K1" not in out and "K2" not in out and "FAILED" not in out


def test_benchtool_reports_a_failed_row_and_exits_nonzero(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("smoother broke\nsecond line")

    monkeypatch.setattr(benchtool, "smooth_rotations", broken)
    assert benchtool.main(["--size", "64x48", "--reps", "2", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "sg smooth (600 frames, r=90)" in out and "FAILED: smoother broke" in out
    assert "second line" not in out
    assert "pyramidal_lk (256 pts, plain)" in out  # the rows before it still ran


def test_pyramidal_lk_plain_is_the_packed_tracker():
    """benchtool's plain LK row computes what the K3 + K2 row does: on the
    CPU, where both take the plain versions, bit for bit; and it tracks a
    known shift."""
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.uniform(0, 255, (260, 340)).astype(np.float32))
    base = torch.nn.functional.avg_pool2d(base[None, None], 5, 1, 2)[0, 0]
    img, img2 = base[10:250, 10:330], base[9:249, 8:328]  # content moves by (+2, +1)
    pts, valid = detect_corners(img)
    got = lk_kernel.pyramidal_lk_plain(img, img2, pts, valid)
    want = lk_kernel.pyramidal_lk_packed(lk_kernel.stage_pyramid(img),
                                         lk_kernel.stage_pyramid(img2), (240, 320), pts, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ok = got[1]
    assert int(ok.sum()) >= valid.sum() // 2
    assert torch.allclose(got[0][ok] - pts[ok], torch.tensor([2.0, 1.0]), atol=0.1)
