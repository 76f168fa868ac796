"""Pyramidal LK over frame pairs (kernel K2), in two forms.

Port of ``video_annotator_tpu/ops/lk_pallas.py``, with the per-point math
of ``_make_lk_kernel`` (:73-263) in ``csrc/lk.cu``:

- pairs form, all adjacent pairs of a chunk in one launch per level:
  ``lk_pack_pyramid_pairs`` (:511), ``_lk_level_pallas_pairs`` (:557)
  and ``pyramidal_lk_pallas_pairs`` (:633);
- per-frame form, one pair of separately staged pyramids, for the
  sequential tracker that stages each frame once and carries it:
  ``lk_pack_pyramid`` (:381), ``_lk_level_pallas`` (:309) and
  ``pyramidal_lk_pallas_packed`` (:419).

The TPU kernel's window stages no level under 256 columns or 112 rows
(:func:`_stageable`); the JAX package's Pallas loops keep the coarse guess
there, and so do :func:`pyramidal_lk_pairs` and :func:`pyramidal_lk_packed`
over the default staging, which gives ``None`` for such a level. The
analysers stage with ``plain_levels=True`` instead: every level cv2's rule
keeps (``ops/lk.py::tracked_levels``, the JAX package's XLA LK), staged
for K2 where it can be and kept as its float level where it cannot, which
the same loops track with the plain level (``ops/lk.py::_lk_level``),
counted in :data:`PLAIN_LEVEL`.

Levels are staged by K3 into (T, H', W') uint8 stacks (rounded half to
even, padded to 32 rows / 128 columns, 32 slack rows of the last 4-row
group) -- the bytes the TPU kernel read from its packed words. The
window geometry of the TPU kernel is kept on the host in :func:`origins`:
each point's 48 x 256 window in the prev frame (around p) and the next
frame (around p + guess), whose bounds clamp the Newton drift and clear
the status exactly where the TPU kernel's once-fetched window ended.

On CPU tensors :func:`lk_level` and :func:`lk_level_frame` run
:func:`lk_level_plain`; on CUDA tensors they launch ``csrc/lk.cu`` (entry
``vat_lk_level`` or ``vat_lk_level_frame``) or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from video_annotator_tpu_torch.ops import cuda_lib
from video_annotator_tpu_torch.ops.lk import (
    DEF_ITERS,
    DEF_LEVELS,
    MIN_EIG_THRESHOLD,
    WIN,
    _lk_level,
    build_pyramid,
    tracked_levels,
)
from video_annotator_tpu_torch.ops.stage import stage_u8, stage_u8_plain

HALF = WIN // 2
PAD = 6  # Newton drift allowance (pixels) inside the window
NSTRIP = 2  # 128-column strips per window
WCOLS = NSTRIP * 128
DMA_WORDS = 20  # word rows (4 pixel rows each) the TPU kernel fetched
AW = 12  # aligned window word rows: 48 pixel rows
RY0 = PAD
SLACK_ROWS = 32  # 8 replicated word rows below each band
Y_HI = float(4 * AW - WIN - 3)
X_HI = float(WCOLS - WIN - 2)

LK_LEVEL = cuda_lib.CudaKernel(
    "lk_level", "vat_lk_level",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    source="video_annotator_tpu_torch/csrc/lk.cu",
    replaces="video_annotator_tpu/ops/lk_pallas.py:624",  # _lk_level_pallas_pairs
)

LK_LEVEL_FRAME = cuda_lib.CudaKernel(
    "lk_level_frame", "vat_lk_level_frame",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    source="video_annotator_tpu_torch/csrc/lk.cu",
    replaces="video_annotator_tpu/ops/lk_pallas.py:366",  # _lk_level_pallas
)


def origins(p: torch.Tensor, wstrips: int, hwords: int):
    """Window origin and in-window offsets for level positions ``p`` (N, 2).

    Returns ``(oy, sx, bw, ry, ixw, ok)`` exactly as the TPU kernel's
    ``_origins`` (lk_pallas.py:266-303): ``oy`` an 8-word-aligned word row,
    ``sx`` a 128-column strip, ``bw`` the word residue, ``ry``/``ixw`` the
    template's halo corner inside the window, ``ok`` whether the span fits
    the (clamped) window. ``hwords`` counts 4-row words of one band."""
    p = p.clamp(-1e6, 1e6)  # garbage flows of failed points stay finite
    ix = torch.floor(p[:, 0]).to(torch.int32)
    iy = torch.floor(p[:, 1]).to(torch.int32)
    sx0 = (ix - (HALF + PAD + 1)) // 128
    sx = sx0.clamp(0, max(wstrips - NSTRIP, 0))
    wy = (iy - (HALF + 1 + PAD)) // 4
    oy0 = (wy // 8) * 8
    oy = oy0.clamp(0, max(((hwords - DMA_WORDS) // 8) * 8, 0))
    bw = (wy - oy).clamp(0, 7)
    ry = p[:, 1] - float(HALF + 1) - ((oy + bw) * 4).to(torch.float32)
    ixw = p[:, 0] - (sx * 128).to(torch.float32) - float(HALF)
    fry = torch.floor(ry)
    ok = ((fry >= float(RY0)) & (fry <= float(RY0 + 3))
          & (ixw >= 1.0) & (ixw <= float(WCOLS - WIN - 3)))
    return oy, sx, bw, ry, ixw, ok


def _sampler(stack: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor):
    """Window reads for the plain version: rows clamp into the window,
    columns past its 256 read 0 (the kernel's ``Window::at``)."""
    flat = stack.reshape(-1)
    pitch = stack.shape[-1]
    row0 = row0.to(torch.int64)[:, None, None]
    col0 = col0.to(torch.int64)[:, None, None]

    def at(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        yc = y.clamp(0, 4 * AW - 1)
        inside = (x >= 0) & (x < WCOLS)
        v = flat[(row0 + yc) * pitch + col0 + x.clamp(0, WCOLS - 1)]
        return torch.where(inside, v.to(torch.float32), 0.0)

    return at


def _floor_index(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v.clamp(-1024.0, 1024.0)).to(torch.int64)


def lk_level_plain(prev_stack: torch.Tensor, next_stack: torch.Tensor,
                   pf: torch.Tensor, pi: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain torch version of ``csrc/lk.cu`` over (M, 6) float / (M, 4) int
    per-point arguments, prev windows read from ``prev_stack`` and next
    windows from ``next_stack`` (one stack twice for the pairs form);
    returns (M, 3) = (flow x, flow y, ok)."""
    gx0, gy0, ryp, ixp, ryn, ixn = pf.unbind(1)
    prev = _sampler(prev_stack, pi[:, 0], pi[:, 1])
    nxt = _sampler(next_stack, pi[:, 2], pi[:, 3])
    dev = prev_stack.device

    def bilinear_rows(at, ry, ix, nrows, ncols):
        iy = _floor_index(ry)[:, None, None]
        ixi = _floor_index(ix)[:, None, None]
        fy = (ry - torch.floor(ry))[:, None, None]
        fx = (ix - torch.floor(ix))[:, None, None]
        y = iy + torch.arange(nrows + 1, device=dev)[None, :, None]
        x = ixi + torch.arange(ncols, device=dev)[None, None, :]
        s = at(y, x) * (1.0 - fx) + at(y, x + 1) * fx
        return s[:, :-1] * (1.0 - fy) + s[:, 1:] * fy

    rows = bilinear_rows(prev, ryp, ixp - 1.0, WIN + 3, WIN + 2)
    t, m, b = rows[:, 0:WIN], rows[:, 1:WIN + 1], rows[:, 2:WIN + 2]
    gx = (3.0 * (t[..., 2:] - t[..., :WIN]) + 10.0 * (m[..., 2:] - m[..., :WIN])
          + 3.0 * (b[..., 2:] - b[..., :WIN])) / 32.0
    gy = (3.0 * (b[..., :WIN] - t[..., :WIN])
          + 10.0 * (b[..., 1:WIN + 1] - t[..., 1:WIN + 1])
          + 3.0 * (b[..., 2:] - t[..., 2:])) / 32.0
    tpl = m[..., 1:WIN + 1]
    gxx = (gx * gx).sum((1, 2))
    gxy = (gx * gy).sum((1, 2))
    gyy = (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4.0 * det,
                                              min=0.0))) * 0.5
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)

    vx, vy = gx0, gy0
    for _ in range(iters):
        oy = torch.clamp((ryn + 1.0) + (vy - gy0), 1.0, Y_HI)
        ox = torch.clamp(ixn + (vx - gx0), 1.0, X_HI)
        r = bilinear_rows(nxt, oy, ox, WIN, WIN) - tpl
        bx = (r * gx).sum((1, 2))
        by = (r * gy).sum((1, 2))
        vx = vx - (gyy * bx - gxy * by) * inv_det
        vy = vy - (gxx * by - gxy * bx) * inv_det

    oy_want = (ryn + 1.0) + (vy - gy0)
    ox_want = ixn + (vx - gx0)
    unsat = ((oy_want >= 1.0) & (oy_want <= Y_HI)
             & (ox_want >= 1.0) & (ox_want <= X_HI))
    ok = (min_eig / float(WIN * WIN) > MIN_EIG_THRESHOLD) & unsat
    return torch.stack([vx, vy, ok.to(torch.float32)], dim=1)


def level_args(stack: torch.Tensor, pts: torch.Tensor,
               band: Optional[torch.Tensor], guess: torch.Tensor):
    """Per-point kernel arguments of one level: ``pf`` (M, 6) float32 =
    (guess x, guess y, ry prev, ix prev, ry next, ix next), ``pi`` (M, 4)
    int32 = row and column of the prev and next windows, and the
    host-side window gate ``ok`` (M,).

    Pairs form: ``stack`` is a (T, H', W') level stack, point i tracks
    from band ``band[i]`` to ``band[i] + 1`` and the rows are absolute
    rows of the stack. Per-frame form: ``band`` is None, ``stack`` one
    (H', W') staged level (the shape of both frames' levels) and the rows
    are rows within each level."""
    if stack.dtype != torch.uint8 or stack.dim() != (2 if band is None else 3):
        raise ValueError("lk stack must be (T, H', W') uint8, or (H', W') per frame")
    rows, pitch = stack.shape[-2:]
    if rows % 32 or pitch % 128 or pitch < WCOLS or rows < 4 * DMA_WORDS:
        raise ValueError(f"lk stack {tuple(stack.shape)} is not a staged level")
    oyp, sxp, bwp, ryp, ixp, okp = origins(pts, pitch // 128, rows // 4)
    oyn, sxn, bwn, ryn, ixn, okn = origins(pts + guess, pitch // 128, rows // 4)
    prev_row0 = next_row0 = 0
    if band is not None:
        prev_row0 = band.to(torch.int64) * rows
        next_row0 = prev_row0 + rows
    pf = torch.stack([guess[:, 0], guess[:, 1], ryp, ixp, ryn, ixn], dim=1)
    pi = torch.stack([
        prev_row0 + 4 * (oyp + bwp).to(torch.int64),
        (sxp * 128).to(torch.int64),
        next_row0 + 4 * (oyn + bwn).to(torch.int64),
        (sxn * 128).to(torch.int64),
    ], dim=1).to(torch.int32)
    return pf.to(torch.float32).contiguous(), pi.contiguous(), okp & okn


def lk_level(stack: torch.Tensor, pf: torch.Tensor, pi: torch.Tensor,
             iters: int = DEF_ITERS) -> torch.Tensor:
    """One LK level over :func:`level_args` arguments; (M, 3) = (flow x,
    flow y, ok). The plain version on CPU tensors, ``csrc/lk.cu`` on CUDA
    tensors."""
    if stack.device.type == "cpu":
        return lk_level_plain(stack, stack, pf, pi, iters)
    cuda_lib.check_cuda(stack)
    stack = stack.contiguous()
    m = pf.shape[0]
    out = torch.empty((m, 3), dtype=torch.float32, device=stack.device)
    cuda_lib.check_operands(stack, pf, pi, out)
    LK_LEVEL.launch(cuda_lib.ptr(stack), stack.shape[-1], cuda_lib.ptr(pf),
                    cuda_lib.ptr(pi), cuda_lib.ptr(out), m, int(iters))
    return out


def lk_level_frame(prev: torch.Tensor, nxt: torch.Tensor, pf: torch.Tensor,
                   pi: torch.Tensor, iters: int = DEF_ITERS) -> torch.Tensor:
    """One LK level of one frame pair over :func:`level_args` arguments of
    the per-frame form: prev windows from the (H', W') staged level
    ``prev``, next windows from ``nxt``. (M, 3) = (flow x, flow y, ok).
    The plain version on CPU tensors, ``csrc/lk.cu`` on CUDA tensors."""
    if prev.shape != nxt.shape or prev.dim() != 2:
        raise ValueError(f"lk levels {tuple(prev.shape)} / {tuple(nxt.shape)} differ")
    if prev.device.type == "cpu":
        return lk_level_plain(prev, nxt, pf, pi, iters)
    cuda_lib.check_cuda(prev)
    prev, nxt = prev.contiguous(), nxt.contiguous()
    m = pf.shape[0]
    out = torch.empty((m, 3), dtype=torch.float32, device=prev.device)
    cuda_lib.check_operands(prev, nxt, pf, pi, out)
    LK_LEVEL_FRAME.launch(cuda_lib.ptr(prev), cuda_lib.ptr(nxt), prev.shape[-1],
                          cuda_lib.ptr(pf), cuda_lib.ptr(pi), cuda_lib.ptr(out),
                          m, int(iters))
    return out


def lk_level_pairs(stack: torch.Tensor, pts: torch.Tensor, band: torch.Tensor,
                   guess: torch.Tensor, iters: int = DEF_ITERS):
    """One LK level for M points: point i tracks from frame ``band[i]`` to
    ``band[i] + 1`` of the (T, H', W') uint8 ``stack``, starting at level
    flow ``guess``. Returns ``(vx, vy, ok)``."""
    pf, pi, ok_windows = level_args(stack, pts, band, guess)
    out = lk_level(stack, pf, pi, iters)
    return out[:, 0], out[:, 1], (out[:, 2] > 0.5) & ok_windows


class LevelCount:
    """Calls of a level routine that is not a kernel, counted as a
    :class:`~video_annotator_tpu_torch.ops.cuda_lib.CudaKernel` counts its
    launches: a caller resets ``launches``, runs a path and reads it."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


PLAIN_LEVEL = LevelCount("lk_plain_level")
PLAIN_GRAPHS = 8  # captured plain levels kept, one a set of shapes
_plain_graphs: dict = {}


def plain_level(prev: torch.Tensor, nxt: torch.Tensor, pts: torch.Tensor,
                guess: torch.Tensor, iters: int):
    """One level of the plain LK (``ops/lk.py::_lk_level``) on (..., h, w)
    float levels for (..., N, 2) level positions, counted in
    :data:`PLAIN_LEVEL`; returns ``(flow, ok)``.

    On a card the level's few hundred small launches would bind it on the
    host: it is captured once a set of shapes as a CUDA graph
    (``cuda_lib.graphed``) and replayed, the same operations on the same
    values. The returned tensors are the graph's outputs, which its next
    replay overwrites: a caller uses them before it calls again."""
    PLAIN_LEVEL.launches += 1
    if prev.device.type != "cuda":
        return _lk_level(prev, nxt, pts, guess, iters)
    key = (prev.device, tuple(prev.shape), tuple(pts.shape), iters)
    replay = _plain_graphs.get(key)
    if replay is None:
        if len(_plain_graphs) >= PLAIN_GRAPHS:
            _plain_graphs.pop(next(iter(_plain_graphs)))
        replay = _plain_graphs[key] = cuda_lib.graphed(
            lambda a, b, p, g: _lk_level(a, b, p, g, iters), prev, nxt, pts, guess)
    return replay(prev, nxt, pts, guess)


def stage_pyramid_pairs(frames: torch.Tensor, levels: int = DEF_LEVELS,
                        plain_levels: bool = False) -> Sequence[Optional[torch.Tensor]]:
    """Staged uint8 pyramid of a (T, H, W) chunk, one stack per level.

    A level too small for the window (:func:`_stageable`) is ``None``, and
    the loops keep their coarse guess there, as the TPU path does. With
    ``plain_levels`` the pyramid holds the levels the plain LK tracks
    (``tracked_levels``, cv2's rule) and such a level is its (T, h, w)
    float32 level, which the loops track with :func:`plain_level`."""
    if plain_levels:
        levels = tracked_levels(*frames.shape[-2:], levels)
    return [stage_u8(level, pad_value=0, slack=SLACK_ROWS) if _stageable(level)
            else level if plain_levels else None
            for level in build_pyramid(frames, levels)]


def _stageable(level: torch.Tensor) -> bool:
    """Whether a pyramid level is large enough for the window."""
    ph, pw = level.shape[-2:]
    return ph >= 4 * DMA_WORDS + 32 and pw >= WCOLS


def stage_pyramid(frame: torch.Tensor, levels: int = DEF_LEVELS,
                  plain_levels: bool = False) -> Sequence[Optional[torch.Tensor]]:
    """Staged pyramid of one (H, W) frame: (H', W') uint8 levels with the
    same padding, slack rows, ``None`` rule and ``plain_levels`` as
    :func:`stage_pyramid_pairs`."""
    return [None if s is None else s[0]
            for s in stage_pyramid_pairs(frame[None], levels, plain_levels)]


def _in_bounds(pts: torch.Tensor, new_pts: torch.Tensor, h: int, w: int):
    """Both ends at least half a window inside the image."""
    half = float(HALF)
    return ((pts[:, 0] >= half) & (pts[:, 0] < w - half)
            & (pts[:, 1] >= half) & (pts[:, 1] < h - half)
            & (new_pts[:, 0] >= half) & (new_pts[:, 0] < w - half)
            & (new_pts[:, 1] >= half) & (new_pts[:, 1] < h - half))


def pyramidal_lk_pairs(staged: Sequence[Optional[torch.Tensor]],
                       img_shape: Tuple[int, int], points: torch.Tensor,
                       valid: torch.Tensor, iters: int = DEF_ITERS):
    """Track N points through each of P adjacent pairs, coarse to fine.

    ``staged`` is :func:`stage_pyramid_pairs` of the chunk's P + 1 frames:
    a uint8 level goes through K2's pairs form, a float level through
    :func:`plain_level` over the pair axis, a ``None`` level keeps the
    coarse guess. ``points`` (P, N, 2) and ``valid`` (P, N) are in level-0
    coordinates of frame p. Returns ``(new_points (P, N, 2), status (P,
    N))``. Points are independent (one warp each), so unlike the TPU path
    they are not padded to a multiple of 8."""
    h, w = img_shape
    p_, n_ = points.shape[0], points.shape[1]
    pts = points.reshape(p_ * n_, 2).to(torch.float32)
    band = torch.arange(p_, device=pts.device).repeat_interleave(n_)
    flow = torch.zeros_like(pts)
    status = valid.reshape(-1)
    for lvl in range(len(staged) - 1, -1, -1):
        level = staged[lvl]
        if level is None:
            continue  # tiny level: keep the coarse guess
        scale = 2.0 ** lvl
        if level.dtype == torch.uint8:
            vx, vy, ok = lk_level_pairs(level, pts / scale, band, flow / scale, iters)
            flow = torch.stack([vx, vy], dim=-1) * scale
        else:
            f, ok = plain_level(level[:-1], level[1:], (pts / scale).reshape(p_, n_, 2),
                                (flow / scale).reshape(p_, n_, 2), iters)
            flow, ok = f.reshape(-1, 2) * scale, ok.reshape(-1)
        status = status & ok
    new_pts = pts + flow
    status = status & _in_bounds(pts, new_pts, h, w)
    return new_pts.reshape(p_, n_, 2), status.reshape(p_, n_)


def pyramidal_lk_packed(staged_prev: Sequence[Optional[torch.Tensor]],
                        staged_next: Sequence[Optional[torch.Tensor]],
                        img_shape: Tuple[int, int], points: torch.Tensor,
                        valid: torch.Tensor, iters: int = DEF_ITERS):
    """Track (N, 2) level-0 ``points`` from one frame to the next, coarse
    to fine, over their :func:`stage_pyramid` pyramids: one
    ``lk_level_frame`` launch a uint8 level, one :func:`plain_level` a
    float level, none a ``None`` level. Returns ``(new_points (N, 2),
    status (N,))``."""
    h, w = img_shape
    pts = points.to(torch.float32)
    flow = torch.zeros_like(pts)
    status = valid
    for lvl in range(len(staged_prev) - 1, -1, -1):
        prev, nxt = staged_prev[lvl], staged_next[lvl]
        if prev is None or nxt is None:
            continue  # tiny level: keep the coarse guess
        scale = 2.0 ** lvl
        if prev.dtype == torch.uint8:
            pf, pi, ok_windows = level_args(prev, pts / scale, None, flow / scale)
            out = lk_level_frame(prev, nxt, pf, pi, iters)
            flow = out[:, :2] * scale
            ok = (out[:, 2] > 0.5) & ok_windows
        else:
            f, ok = plain_level(prev, nxt, pts / scale, flow / scale, iters)
            flow = f * scale
        status = status & ok
    new_pts = pts + flow
    return new_pts, status & _in_bounds(pts, new_pts, h, w)


def pyramidal_lk_plain(frame: torch.Tensor, next_frame: torch.Tensor, points: torch.Tensor,
                       valid: torch.Tensor, iters: int = DEF_ITERS):
    """:func:`pyramidal_lk_packed` over the :func:`stage_pyramid` pyramids
    of two (H, W) frames, staged and tracked by K3's and K2's plain
    versions on any device (the plain row of ``benchtool``). Returns
    ``(new_points (N, 2), status (N,))``."""
    h, w = frame.shape
    pts = points.to(torch.float32)
    flow = torch.zeros_like(pts)
    status = valid
    levels = list(zip(build_pyramid(frame[None]), build_pyramid(next_frame[None])))
    for lvl in range(len(levels) - 1, -1, -1):
        if not _stageable(levels[lvl][0]):
            continue  # tiny level: keep the coarse guess
        prev, nxt = (stage_u8_plain(level, pad_value=0, slack=SLACK_ROWS)[0]
                     for level in levels[lvl])
        scale = 2.0 ** lvl
        pf, pi, ok_windows = level_args(prev, pts / scale, None, flow / scale)
        out = lk_level_plain(prev, nxt, pf, pi, iters)
        flow = out[:, :2] * scale
        status = status & (out[:, 2] > 0.5) & ok_windows
    new_pts = pts + flow
    return new_pts, status & _in_bounds(pts, new_pts, h, w)
