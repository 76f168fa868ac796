"""The least time of a launch of K1's uint8 warp, at the published peaks.

A frozen copy of the arithmetic of ``chip_smoke.py::bound`` and
``video_annotator_tpu_torch/tools/roofline.py`` (``HBM_BYTES_PER_S``,
``FP32_OPS_PER_S``, ``MAP_OPS_RECT``, ``FISHEYE_OPS``, ``TAP_OPS``,
``map_ops``) at commit be9ce58. Operations per output pixel are counted
from ``csrc/warp.cu`` (a product and a sum one each; a division,
``sqrtf`` and ``atanf`` one each): the rectilinear map 28, a fisheye
input 20 more, then per plane the bilinear taps and the rounding 20.
Bytes: each source byte read once, each rotation once, each output byte
written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
MAP_OPS_RECT = 28
FISHEYE_OPS = 20
TAP_OPS = 20


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over bandwidth and operations over rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def launch_bound_s(frames: int, planes: int, in_hw, out_hw, fisheye: bool) -> float:
    """One launch over ``frames`` frames of ``planes`` uint8 planes of
    ``in_hw`` warped to ``out_hw``, one 3x3 rotation a frame."""
    ih, iw = in_hw
    oh, ow = out_hw
    map_ops = MAP_OPS_RECT + (FISHEYE_OPS if fisheye else 0)
    nbytes = frames * planes * (ih * iw + oh * ow) + frames * 9 * 4
    ops = frames * oh * ow * (map_ops + planes * TAP_OPS)
    return bound_s(nbytes, ops)
