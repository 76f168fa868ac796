"""Warp fidelity against cv2 and per-frame warp latency on the card.

Port of ``benchmarks/fidelity.py``, BASELINE's two numeric gates: warp
fidelity **PSNR >= 45 dB against the reference warp** (``cv2.remap``
INTER_LINEAR, the reference's ``createMap`` + ``cv::remap``,
``opencv/FrameSourceWarp.cpp:272-312``) and the **per-frame warp
latency** of the encode's batched window (the JAX tool's target, 4 ms,
is kept as the gate's number).

- :func:`run`: the stock 3840x2880 fisheye (preset
  ``gopro_h4b_wide43_measured``) to its cropped rectilinear canvas at a
  3-degree correction about a skew axis, one frame through
  ``FrameWarper.warp_yuv`` (kernel K1's uint8 one-frame form) held to
  ``cv2.remap`` on float input with the same map and border (0 luma,
  128 chroma), rounded to the same uint8 grid, luma and chroma apart;
  then ``FrameWarper.warp_yuv_batch`` over ``--batch`` textured frames
  (K1's uint8 batch, luma and chroma), each of ``--dispatches`` timed
  dispatches synchronised, per-frame latency = dispatch wall / batch,
  p50 and p99 over the dispatches.
- :func:`run_families`: the other warp families against their own
  oracles: bicubic (``cv2.remap`` INTER_CUBIC) and lanczos (the port's
  own plain 4x4 lanczos, not an independent oracle) through K1's mode
  kernel at the same geometry; the similarity family through K1's
  one-frame form over identity cameras at half the geometry against
  ``cv2.warpAffine``; deshake's plain-torch translation at half the
  geometry, the interior against ``cv2.warpAffine``.

Usage::

    python -m video_annotator_tpu_torch.tools.fidelity [--batch 32] [--dispatches 24]
        [--size 3840x2880] [--device cuda|cpu] [--out PATH]

Prints the stamped result as JSON and writes it to ``--out`` (default
``chiprun_out/fidelity.json`` in the checkout). Without a card it exits 1
unless ``--device cpu`` is given; on the CPU it runs and times the plain
versions, and the JSON says so under ``route``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset, get_output_camera, get_preset_camera
from video_annotator_tpu_torch.models.deshake import warp_frame_deshake
from video_annotator_tpu_torch.models.similarity import SimilarityWarper
from video_annotator_tpu_torch.ops.warp_plain import compute_warp_map, sample, scaled_camera
from video_annotator_tpu_torch.pipeline.render import FrameWarper
from video_annotator_tpu_torch.tools.provenance import stamp

REPO = Path(__file__).resolve().parents[2]
PSNR_GATE_DB = 45.0
LATENCY_TARGET_MS = 4.0
AXIS = (0.45, 0.65, 0.61)  # the skew axis of the correction


def psnr(a, b, peak=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / mse)) if mse > 0 else float("inf")


def _textured(h, w, seed=0):
    """Textured uint8 plane (sinusoids + noise): interpolation error is
    content-dependent, so fidelity is scored on busy content. The JAX
    tool's values, its 2D sinusoids evaluated once per row and column."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    img = 128 + 80 * np.sin(xx / 17.0) + 40 * np.cos(yy / 11.0) + rng.normal(size=(h, w)) * 10
    return np.clip(img, 0, 255).astype(np.uint8)


def _textured_many(h, w, seeds):
    """:func:`_textured` of each seed, made on a few host threads."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(lambda s: _textured(h, w, s), seeds))


def _stock(size):
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, size)
    return in_cam, get_output_camera(in_cam, crop_borders=True)


def _rotation(correction_deg: float, dev) -> torch.Tensor:
    axis = np.asarray(AXIS)
    w = axis / np.linalg.norm(axis) * np.radians(correction_deg)
    return so3.exp(torch.tensor(w, dtype=torch.float32)).to(dev)


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def _oracle(plane, coords, border, interp=None):
    """``cv2.remap`` of a uint8 plane, float input and weights."""
    coords = coords.cpu().numpy()
    ref = cv2.remap(plane.astype(np.float32), coords[..., 0], coords[..., 1],
                    interp if interp is not None else cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=border)
    return _u8(ref)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(batch: int, dispatches: int, correction_deg: float, size=(3840, 2880),
        device="cuda") -> dict:
    """PSNR of one frame against ``cv2.remap`` and the per-frame latency
    of the batched warp (module docstring)."""
    dev = torch.device(device)
    w, h = size
    in_cam, out_cam = _stock(size)
    warper = FrameWarper(in_cam, out_cam, max_correction_deg=6.0, device=dev)
    oh, ow = warper.out_h, warper.out_w
    rot = _rotation(correction_deg, dev)

    y, u, v = _textured_many(h, w, [1]) + _textured_many(h // 2, w // 2, [2, 3])
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    wy, wu, wv = (p.cpu().numpy() for p in warper.warp_yuv(*planes, rot))

    coords = compute_warp_map(out_cam, in_cam, rot, (oh, ow))
    psnr_y = psnr(wy, _oracle(y, coords, 0.0))
    coords_c = compute_warp_map(scaled_camera(out_cam, 0.5), scaled_camera(in_cam, 0.5), rot,
                                (oh // 2, ow // 2))
    psnr_u = psnr(wu, _oracle(u, coords_c, 128.0))
    psnr_v = psnr(wv, _oracle(v, coords_c, 128.0))

    # The encode's batched window, each dispatch synchronised.
    rng = np.random.default_rng(0)
    ys = [torch.from_numpy(p).to(dev)
          for p in _textured_many(h, w, [10 + i for i in range(batch)])]
    us = [torch.from_numpy(p).to(dev)
          for p in _textured_many(h // 2, w // 2, [50 + i for i in range(batch)])]
    vs = [torch.from_numpy(p).to(dev)
          for p in _textured_many(h // 2, w // 2, [90 + i for i in range(batch)])]
    rots = so3.exp(torch.from_numpy(
        (rng.normal(size=(batch, 3)) * np.radians(correction_deg / 2)).astype(np.float32))).to(dev)
    warper.warp_yuv_batch(ys, us, vs, rots)  # warm-up
    _sync(dev)
    per_frame_ms = []
    for _ in range(dispatches):
        t0 = time.perf_counter()
        warper.warp_yuv_batch(ys, us, vs, rots)
        _sync(dev)
        per_frame_ms.append((time.perf_counter() - t0) * 1e3 / batch)
    per_frame_ms.sort()

    def pct(p):
        return round(per_frame_ms[min(len(per_frame_ms) - 1, int(p / 100 * len(per_frame_ms)))],
                     3)

    return {
        "geometry": f"{w}x{h}",
        "correction_deg": correction_deg,
        "psnr_luma_db": round(psnr_y, 2),
        "psnr_chroma_u_db": round(psnr_u, 2),
        "psnr_chroma_v_db": round(psnr_v, 2),
        "psnr_gate_db": PSNR_GATE_DB,
        "psnr_ok": bool(min(psnr_y, psnr_u, psnr_v) >= PSNR_GATE_DB),
        "latency_batch": batch,
        "dispatches_timed": dispatches,
        "p50_warp_ms_per_frame": pct(50),
        "p99_warp_ms_per_frame": pct(99),
        "latency_target_ms": LATENCY_TARGET_MS,
        "latency_ok": bool(pct(50) < LATENCY_TARGET_MS),
        "oracle_cv2": cv2.__version__,
        "route": ("the CUDA kernels" if dev.type == "cuda"
                  else "the plain PyTorch versions on the CPU"),
    }


def run_families(correction_deg: float, size=(3840, 2880), device="cuda") -> dict:
    """Per-family PSNR rows against each family's own oracle (module
    docstring); ``oracle_independent`` is false where the oracle is the
    port's own formulation."""
    dev = torch.device(device)
    rows = {}
    w, h = size
    in_cam, out_cam = _stock(size)
    rot = _rotation(correction_deg, dev)
    y_np, u_np = _textured_many(h, w, [1]) + _textured_many(h // 2, w // 2, [2])
    y, u = torch.from_numpy(y_np).to(dev), torch.from_numpy(u_np).to(dev)
    coords = None
    for interp, oracle_name in (("bicubic", "cv2.remap INTER_CUBIC"),
                                ("lanczos", "plain lanczos 4x4 (ops/warp_plain.py)")):
        warper = FrameWarper(in_cam, out_cam, max_correction_deg=6.0, interp=interp,
                             device=dev)
        if coords is None:
            coords = compute_warp_map(out_cam, in_cam, rot, (warper.out_h, warper.out_w))
        ours = warper.warp_yuv(y, u, u, rot)[0].cpu().numpy()
        if interp == "bicubic":
            ref = _oracle(y_np, coords, 0.0, cv2.INTER_CUBIC)
        else:
            ref = _u8(sample(y.to(torch.float32), coords, "lanczos").cpu().numpy())
        rows[f"rotation_{interp}"] = {
            "geometry": f"{w}x{h}",
            "psnr_luma_db": round(psnr(ours, ref), 2),
            "oracle": oracle_name,
            "oracle_independent": interp != "lanczos",
        }

    w2, h2 = w // 2, h // 2
    y2_np, u2_np = _textured_many(h2, w2, [5]) + _textured_many(h2 // 2, w2 // 2, [6])
    y2, u2 = torch.from_numpy(y2_np).to(dev), torch.from_numpy(u2_np).to(dev)
    params = np.asarray([20.0, -15.0, 0.01, 0.01], np.float32)  # dx dy angle log-scale
    sim = SimilarityWarper(w2, h2)
    mat = SimilarityWarper.matrices(params[None])[0]
    sy = sim.warp_yuv(y2, u2, u2, torch.from_numpy(mat).to(dev))[0].cpu().numpy()
    ref = _u8(cv2.warpAffine(y2_np.astype(np.float32), mat[:2], (sim.out_w, sim.out_h),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                             borderMode=cv2.BORDER_CONSTANT))
    crop = np.s_[64:-64, 64:-64]
    rows["similarity"] = {
        "geometry": f"{w2}x{h2}",
        "psnr_luma_db": round(psnr(sy[crop], ref[crop]), 2),
        "oracle": "cv2.warpAffine INTER_LINEAR WARP_INVERSE_MAP (interior)",
        "oracle_independent": True,
    }

    off = torch.tensor([7.3, -4.6], dtype=torch.float32)
    f2 = y2.to(torch.float32)
    uf = u2.to(torch.float32)
    dy = _u8(warp_frame_deshake(f2, uf, uf, off, blur_edges=True)[0].cpu().numpy())
    m = np.float32([[1, 0, 7.3], [0, 1, -4.6]])
    ref = _u8(cv2.warpAffine(y2_np.astype(np.float32), m, (w2, h2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                             borderMode=cv2.BORDER_CONSTANT))
    rows["deshake"] = {
        "geometry": f"{w2}x{h2}",
        "psnr_luma_db": round(psnr(dy[crop], ref[crop]), 2),
        "oracle": "cv2.warpAffine translation (interior; edge blur excluded by the crop)",
        "oracle_independent": True,
    }
    return rows


def _size(value: str):
    w, h = (int(x) for x in value.lower().split("x"))
    return w, h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="warp fidelity against cv2 and warp latency")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dispatches", type=int, default=24)
    ap.add_argument("--correction-deg", type=float, default=3.0)
    ap.add_argument("--size", type=_size, default=(3840, 2880),
                    help="source WxH of the rotation rows (the 2D families take half)")
    ap.add_argument("--no-families", dest="families", action="store_false",
                    help="skip the per-family PSNR rows (bicubic, lanczos, similarity, deshake)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a card) or cpu (the plain versions)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "fidelity.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fidelity: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    result = run(args.batch, args.dispatches, args.correction_deg, args.size, args.device)
    if args.families:
        result["families"] = run_families(args.correction_deg, args.size, args.device)
        result["families_psnr_ok"] = bool(all(
            r["psnr_luma_db"] >= PSNR_GATE_DB for r in result["families"].values()))
    stamp(result, args.device)
    print(json.dumps(result))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
