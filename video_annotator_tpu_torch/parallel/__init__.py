"""Scaling over several devices: device meshes and sharded pipeline stages.

Port of ``video_annotator_tpu/parallel/`` on ``torch.distributed``, in
torch's SPMD idiom: one process per device, each function taking and
returning the calling rank's local shard (``gather`` rebuilds a global
tensor where a test or a check needs one). The axes:

- ``data``: independent streams (``parallel/streams.py``);
- ``time``: the frame axis, with halos exchanged between time neighbours
  and a distributed prefix product (``parallel/temporal.py``);
- ``space``: the warp's output rows, one band of tile rows per rank.
"""

from video_annotator_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from video_annotator_tpu_torch.parallel.temporal import (  # noqa: F401
    distributed_accumulate_rotations,
    smooth_rotations_sharded,
)
