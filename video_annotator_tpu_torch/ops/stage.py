"""Staging of planes and pyramid levels as padded uint8 stacks (kernel K3).

Port of the value semantics of the TPU pack path: ``pack_frame_words``
(``video_annotator_tpu/ops/warp_pallas.py:1658``, kernel ``_pack_call``
:1634) and the bottom slack ``lk_pack_pyramid_pairs`` appends
(``ops/lk_pallas.py:538-544``). The quad-row int32 word layout existed
only for the TPU's lane gather; here a stack is plain rows of bytes,
``(T, round_up(H, 32) + slack, round_up(W, 128))``, which the LK kernel
reads directly. The padded geometry is kept because the LK window rules
(``ops/lk_kernel.py::origins``) clamp against it.

On a CPU tensor :func:`stage_u8` runs :func:`stage_u8_plain`; on a CUDA
tensor it launches ``csrc/stage.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from video_annotator_tpu_torch.ops import cuda_lib

ROW_ALIGN = 32
COL_ALIGN = 128

STAGE = cuda_lib.CudaKernel(
    "stage", "vat_stage_u8",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7,
    source="video_annotator_tpu_torch/csrc/stage.cu",
    replaces="video_annotator_tpu/ops/warp_pallas.py:1640",  # _pack_call
)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def staged_shape(t: int, h: int, w: int, slack: int = 0):
    return (t, round_up(h, ROW_ALIGN) + slack, round_up(w, COL_ALIGN))


def stage_u8_plain(src: torch.Tensor, pad_value: int = 0,
                   slack: int = 0) -> torch.Tensor:
    """Plain torch version of the K3 kernel (same contract as
    :func:`stage_u8`)."""
    t, h, w = src.shape
    _, hs, wp = staged_shape(t, h, w, slack)
    hp = hs - slack
    if src.dtype == torch.uint8:
        body = src
    else:
        body = torch.clamp(torch.round(src.to(torch.float32)), 0.0, 255.0)
        body = body.to(torch.uint8)
    out = torch.full((t, hp, wp), pad_value, dtype=torch.uint8,
                     device=src.device)
    out[:, :h, :w] = body
    if slack:
        tail = out[:, hp - 4:hp].repeat(1, slack // 4, 1)
        out = torch.cat([out, tail], dim=1)
    return out


def stage_u8(src: torch.Tensor, pad_value: int = 0,
             slack: int = 0) -> torch.Tensor:
    """(T, H, W) float32 or uint8 -> padded (T, H', W') uint8 stack.

    Float input rounds half to even and clamps to [0, 255]; the alignment
    padding holds ``pad_value``; ``slack`` extra rows (a multiple of 4)
    repeat the last 4-row group of the padded plane."""
    if src.dim() != 3:
        raise ValueError(f"stage_u8 takes (T, H, W), got {tuple(src.shape)}")
    if src.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"stage_u8 takes uint8 or float32, got {src.dtype}")
    if slack % 4 or not 0 <= pad_value <= 255:
        raise ValueError(f"bad slack {slack} / pad_value {pad_value}")
    if src.device.type == "cpu":
        return stage_u8_plain(src, pad_value, slack)
    cuda_lib.check_cuda(src)
    src = src.contiguous()
    t, h, w = src.shape
    out = torch.empty(staged_shape(t, h, w, slack), dtype=torch.uint8,
                      device=src.device)
    cuda_lib.check_operands(src, out)
    STAGE.launch(cuda_lib.ptr(src), int(src.dtype == torch.float32),
                 cuda_lib.ptr(out), t, h, w, out.shape[1] - slack,
                 out.shape[2], slack, pad_value)
    return out
