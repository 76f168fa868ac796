"""The ``.traj.npz`` trajectory file: written for ``--encode-only`` jobs,
read back from the jobs that analyse.

A frozen copy of the format of
``video_annotator_tpu_torch/pipeline/trajectory.py::Trajectory.save`` at
commit be9ce58 (``FORMAT_VERSION`` 2: version, kind, params, fps_num,
fps_den, width, height, source), plain numpy.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

FORMAT_VERSION = 2


def path_for(dest: str) -> str:
    """Where a render to ``dest`` keeps its trajectory."""
    return dest + ".traj.npz"


def write(path: str, params: np.ndarray, fps: Fraction, width: int, height: int,
          source: str) -> None:
    """An ``so3`` trajectory of (T, 3) float64 rotation vectors."""
    np.savez(path, version=FORMAT_VERSION, kind="so3",
             params=np.asarray(params, np.float64), fps_num=fps.numerator,
             fps_den=fps.denominator, width=width, height=height, source=source)


def read_params(path: str) -> np.ndarray:
    """The (T, 3) float64 rotation vectors of an ``so3`` trajectory file."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION or str(z["kind"]) != "so3":
            raise ValueError(f"{path}: not a version {FORMAT_VERSION} so3 trajectory")
        return np.asarray(z["params"], np.float64)
