"""Time-axis (sequence) parallelism for trajectory processing.

Port of ``video_annotator_tpu/parallel/temporal.py`` on
``torch.distributed``. Each rank of the ``time`` group holds a block of
consecutive frames; two collective patterns make the block-local work
equal to the global one:

- :func:`distributed_accumulate_rotations`: the accumulated product
  ``R_t = dR_t ... dR_0`` as a distributed prefix product on SO(3): a
  local prefix product, an all-gather of the block totals, then each
  block pre-multiplied by the product of the blocks before it;
- :func:`smooth_rotations_sharded`: the Savitzky-Golay filter with
  ``radius`` halo frames exchanged with the time neighbours
  (``batch_isend_irecv``), the global ends replicating the terminal
  frame as the unsharded filter pads them.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.parallel.mesh import all_gather, neighbour_exchange
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv


def halo_pad(flat: torch.Tensor, radius: int, mesh: DeviceMesh, axis: str = "time"):
    """(..., T, K) local block -> (..., T + 2 radius, K): ``radius`` rows of
    each time neighbour on either side, the terminal row replicated at the
    global ends."""
    if flat.shape[-2] < radius:
        raise ValueError(f"a time block of {flat.shape[-2]} frames is shorter than the "
                         f"radius {radius}: halos come from one neighbour only")
    from_left, from_right = neighbour_exchange(flat[..., -radius:, :], flat[..., :radius, :],
                                               mesh, axis)
    if from_left is None:
        from_left = flat[..., :1, :].expand(*flat.shape[:-2], radius, flat.shape[-1])
    if from_right is None:
        from_right = flat[..., -1:, :].expand(*flat.shape[:-2], radius, flat.shape[-1])
    return torch.cat([from_left, flat, from_right], dim=-2)


def smooth_rotations_sharded(rotations: torch.Tensor, radius: int, mesh: DeviceMesh,
                             axis: str = "time", order: int = 2) -> torch.Tensor:
    """SG-smooth this rank's (T_local, 3, 3) block of a time-sharded
    trajectory; equal to the unsharded filter (``smooth_rotations``) as
    long as every block holds at least ``radius`` frames."""
    w = torch.from_numpy(savgol_weights(radius, order)).to(rotations.device)
    flat = rotations.reshape(-1, 9).to(torch.float32)
    smooth = sg_conv(halo_pad(flat, radius, mesh, axis), w)
    return so3.project(smooth.reshape(-1, 3, 3))


def prefix_product(deltas: torch.Tensor) -> torch.Tensor:
    """(..., T, 3, 3) -> out[..., t] = d_t ... d_0, along the time dim."""
    out = [deltas[..., 0, :, :]]
    for t in range(1, deltas.shape[-3]):
        out.append(so3.matmul(deltas[..., t, :, :], out[-1]))
    return torch.stack(out, dim=-3)


def distributed_accumulate_rotations(deltas: torch.Tensor, mesh: DeviceMesh,
                                     axis: str = "time") -> torch.Tensor:
    """Distributed prefix product of this rank's (..., T_local, 3, 3) block
    of per-frame rotations: out[t] = dR_t ... dR_0 over the global time
    axis (the leading dims, streams for instance, ride along)."""
    local = prefix_product(deltas.to(torch.float32))
    totals = all_gather(local[..., -1, :, :], mesh, axis)  # (n, ..., 3, 3)
    prefix = torch.eye(3, dtype=local.dtype, device=local.device).expand(totals.shape[1:])
    for i in range(mesh.get_local_rank(axis)):
        prefix = so3.matmul(totals[i], prefix)
    return so3.matmul(local, prefix[..., None, :, :])
