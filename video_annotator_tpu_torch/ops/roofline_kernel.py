"""The roofline tool's two probes (rows 11 and 12, ``csrc/roofline.cu``).

Port of the Pallas microkernels of ``benchmarks/roofline.py``:

- :func:`fma_chain`: ``_fma_kernel`` (:86), a chain of
  ``acc = acc * 0.999999 + x`` from ``acc = x``, ``outer x unroll`` steps,
  unfused (K1's arithmetic) or as one fused multiply-add a step;
- :func:`gather_visits`: ``_gather_kernel`` (:113), ``outer x unroll``
  "row visits" of the TPU warp's schedule walk: two masked gathers from
  one word row of the tile, four bytes, two weighted sums.

Both take (n, 8, 128) tensors, n tiles of the TPU kernel's one. ``outer``
is an argument (the JAX kernels read the module constant ``OUTER``,
100 000), so that the plain versions can run a short chain.

On CPU tensors each wrapper runs its plain PyTorch version
(:func:`fma_chain_plain`, :func:`gather_visits_plain`); on CUDA tensors it
launches the kernel or raises. Each (unroll, fused) instantiation is a
kernel object of its own that counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from video_annotator_tpu_torch.ops import cuda_lib

SHAPE = (8, 128)
OUTER = 100_000
DECAY = 0.999999  # rounded to float32, as the kernels' 0.999999f
FMA_UNROLLS = (8, 64)
GATHER_UNROLLS = (2, 8)
_SOURCE = "video_annotator_tpu_torch/csrc/roofline.cu"
_ROOFLINE = "benchmarks/roofline.py"


def _fma_object(unroll: int, fused: bool) -> cuda_lib.CudaKernel:
    name = f"fma_chain{'_fused' if fused else ''}_u{unroll}"
    return cuda_lib.CudaKernel(
        name, "vat_fma_chain", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4,
        source=_SOURCE, replaces=f"{_ROOFLINE}:97")  # _fma_kernel's pallas_call


def _gather_object(unroll: int) -> cuda_lib.CudaKernel:
    return cuda_lib.CudaKernel(
        f"gather_visit_u{unroll}", "vat_gather_visits", [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 3, source=_SOURCE,
        replaces=f"{_ROOFLINE}:148")  # _gather_kernel's pallas_call


FMA_CHAIN = {(u, fused): _fma_object(u, fused)
             for fused in (False, True) for u in FMA_UNROLLS}
GATHER_VISIT = {u: _gather_object(u) for u in GATHER_UNROLLS}


def _check_tiles(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dim() != 3 or tuple(t.shape[1:]) != SHAPE or t.dtype != dtype or t.shape[0] < 1:
        raise ValueError(f"{what} must be (n, 8, 128) {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def fma_chain_plain(x: torch.Tensor, unroll: int, outer: int = OUTER,
                    fused: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma_chain`: the same steps as
    float32 tensor operations, the product and the sum each rounded; with
    ``fused``, each step taken in float64 and rounded once to float32. A
    float32 product is exact in float64 and the sum with ``x`` needs at
    most 50 bits while acc / x stays below 2^24 (it tends to 1e6), so
    that one rounding is the fused multiply-add's."""
    decay = torch.tensor(DECAY, dtype=torch.float32, device=x.device)
    acc = x
    if fused:
        x64 = x.to(torch.float64)
        for _ in range(outer * unroll):
            acc = (acc.to(torch.float64) * decay.to(torch.float64) + x64).to(torch.float32)
        return acc
    for _ in range(outer * unroll):
        acc = acc * decay + x
    return acc


def fma_chain(x: torch.Tensor, unroll: int, outer: int = OUTER,
              fused: bool = False) -> torch.Tensor:
    """(n, 8, 128) float32 -> (n, 8, 128) float32: ``outer x unroll``
    steps of ``acc = acc * 0.999999 + x`` from ``acc = x`` (row 11);
    ``fused``: one fused multiply-add a step. The kernel takes unroll 8
    or 64."""
    _check_tiles(x, torch.float32, "x")
    if outer < 0:
        raise ValueError(f"outer must be >= 0, got {outer}")
    if x.device.type == "cpu":
        return fma_chain_plain(x, unroll, outer, fused)
    cuda_lib.check_cuda(x)
    kernel = FMA_CHAIN.get((unroll, bool(fused)))
    if kernel is None:
        raise ValueError(f"the fma kernel takes unroll {FMA_UNROLLS}, got {unroll}")
    x = x.contiguous()
    out = torch.empty_like(x)
    cuda_lib.check_operands(x, out)
    kernel.launch(cuda_lib.ptr(x), cuda_lib.ptr(out), x.shape[0], unroll, int(fused), outer)
    return out


def gather_visits_plain(seg: torch.Tensor, idx: torch.Tensor, unroll: int,
                        outer: int = OUTER) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_visits`: each step's row of
    every tile broadcast over the tile's 8 rows and gathered with
    ``torch.gather``, in the kernel's float32 roundings."""
    idx1 = (idx + 1) & 127
    m0 = (idx >= 0) & (idx < 128)
    m1 = (idx + 1 >= 0) & (idx + 1 < 128)
    safe0 = idx.clamp(0, 127).to(torch.int64)
    safe1 = idx1.to(torch.int64)
    wy0 = idx.to(torch.float32) * torch.tensor(0.001, dtype=torch.float32, device=idx.device)
    fy = 1.0 - wy0
    a0 = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    a1 = torch.zeros_like(a0)
    for step in range(outer * unroll):
        row = seg[:, step % 8: step % 8 + 1, :].expand(-1, SHAPE[0], -1)
        g0 = torch.where(m0, torch.gather(row, 2, safe0), 0)
        g1 = torch.where(m1, torch.gather(row, 2, safe1), 0)
        v00 = (g0 & 0xFF).to(torch.float32)
        v01 = ((g0 >> 8) & 0xFF).to(torch.float32)
        v10 = (g1 & 0xFF).to(torch.float32)
        v11 = ((g1 >> 8) & 0xFF).to(torch.float32)
        a0 = a0 + (wy0 * v00 + fy * v01)
        a1 = a1 + (wy0 * v10 + fy * v11)
    return a0 + a1


def gather_visits(seg: torch.Tensor, idx: torch.Tensor, unroll: int,
                  outer: int = OUTER) -> torch.Tensor:
    """(n, 8, 128) int32 words ``seg`` and lane indices ``idx`` ->
    (n, 8, 128) float32: ``outer x unroll`` row visits (row 12). The
    kernel takes unroll 2 or 8."""
    _check_tiles(seg, torch.int32, "seg")
    _check_tiles(idx, torch.int32, "idx")
    if seg.shape != idx.shape:
        raise ValueError(f"seg {tuple(seg.shape)} and idx {tuple(idx.shape)} differ")
    if outer < 0:
        raise ValueError(f"outer must be >= 0, got {outer}")
    if seg.device.type == "cpu":
        return gather_visits_plain(seg, idx, unroll, outer)
    cuda_lib.check_cuda(seg)
    kernel = GATHER_VISIT.get(unroll)
    if kernel is None:
        raise ValueError(f"the gather kernel takes unroll {GATHER_UNROLLS}, got {unroll}")
    seg, idx = seg.contiguous(), idx.contiguous()
    out = torch.empty(seg.shape, dtype=torch.float32, device=seg.device)
    cuda_lib.check_operands(seg, idx, out)
    kernel.launch(cuda_lib.ptr(seg), cuda_lib.ptr(idx), cuda_lib.ptr(out), seg.shape[0],
                  unroll, outer)
    return out
