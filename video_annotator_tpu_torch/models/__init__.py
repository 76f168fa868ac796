"""Stabiliser model families behind ``--filter``.

Own copy of ``video_annotator_tpu/models/__init__.py``'s alias table:
``dewobble`` (camera rotations on SO(3), the default; it lives in
``pipeline/render.py``), ``vidstab`` (2D similarity trajectory,
:mod:`similarity <video_annotator_tpu_torch.models.similarity>`) and
``deshake`` / ``deshake_opencl`` (global translation by phase correlation
with a blurred-edge fill,
:mod:`deshake <video_annotator_tpu_torch.models.deshake>`). The families
share the analyse/encode pipeline.
"""

FILTER_ALIASES = {
    "dewobble": "rotation",
    "rotation": "rotation",
    "vidstab": "similarity",
    "similarity": "similarity",
    "deshake": "deshake",
    "deshake_opencl": "deshake",
}
