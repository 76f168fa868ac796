"""Device meshes over a ``torch.distributed`` process group, and the
collective helpers the sharded stages share.

Port of ``video_annotator_tpu/parallel/mesh.py``. One process drives one
device; the mesh's axes are subgroups of the default process group.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "time", "space")


def _factor(n: int, k: int) -> Tuple[int, ...]:
    """Split n devices into k axes, largest axis first."""
    dims = [1] * k
    i = 0
    rem = n
    # greedy: peel factors of 2, then the rest
    f = 2
    while rem > 1:
        while rem % f == 0:
            dims[i % k] *= f
            rem //= f
            i += 1
        f += 1
    return tuple(sorted(dims, reverse=True))


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = AXES,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the default process group's ranks, one device each.

    Axis sizes are factored automatically, as the JAX package does: 8
    ranks give (2, 2, 2), 4 give (2, 2, 1), 1 gives (1, 1, 1).
    ``n_devices`` must be the world size (a rank outside the
    mesh has no role in an SPMD program). ``device_type`` is ``"cuda"``
    on the card, ``"cpu"`` over a gloo group."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, _factor(world, len(axis_names)),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): ``x`` of every rank of the ``axis`` group, in the
    group's rank order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.stack(parts)


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The global tensor of local shards split along ``dim`` over ``axis``."""
    return torch.cat(list(all_gather(x, mesh, axis).unbind(0)), dim=dim)


def neighbour_exchange(to_right: torch.Tensor, to_left: Optional[torch.Tensor],
                       mesh: DeviceMesh, axis: str):
    """Send ``to_right`` to the next rank of ``axis`` and ``to_left`` to the
    previous one (``None``: nothing goes left, on every rank); returns
    ``(from_left, from_right)``, ``None`` at the group's ends (no ring:
    the ends have no such neighbour)."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    from_left = from_right = None
    if n == 1:
        return from_left, from_right
    group = mesh.get_group(axis)
    ops = []
    if r > 0:
        left = dist.get_global_rank(group, r - 1)
        from_left = torch.empty_like(to_right)
        ops.append(dist.P2POp(dist.irecv, from_left, left, group))
        if to_left is not None:
            ops.append(dist.P2POp(dist.isend, to_left.contiguous(), left, group))
    if r < n - 1:
        right = dist.get_global_rank(group, r + 1)
        ops.append(dist.P2POp(dist.isend, to_right.contiguous(), right, group))
        if to_left is not None:
            from_right = torch.empty_like(to_left)
            ops.append(dist.P2POp(dist.irecv, from_right, right, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None, rank: Optional[int] = None,
                         backend: str = "nccl") -> bool:
    """Join a multi-process group, one process per device, from the
    arguments or torch's ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns True when a group
    was initialised, False when nothing is configured (the one-process
    case), as the JAX package's ``initialize_multihost`` does."""
    if init_method is None and "MASTER_ADDR" not in os.environ and world_size is None:
        return False
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = rank if rank is not None else int(os.environ.get("RANK", 0))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return True
