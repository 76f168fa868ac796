"""Persisted motion trajectories: the two-phase checkpoint.

Port of ``video_annotator_tpu/pipeline/trajectory.py``. The ``.traj.npz``
schema (``FORMAT_VERSION`` 2: version, kind, params, fps_num, fps_den,
width, height, source, optional up0) is byte-compatible, so a trajectory
analysed by either package drives the other's ``--encode-only``.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from video_annotator_tpu_torch import so3

FORMAT_VERSION = 2

KIND_DIMS = {"so3": 3, "similarity": 4, "translation": 2}


@dataclasses.dataclass
class Trajectory:
    """Per-frame accumulated motion parameters + probe metadata."""

    params: np.ndarray  # (T, K) float64
    kind: str = "so3"
    fps: Fraction = Fraction(30, 1)
    width: int = 0
    height: int = 0
    source: str = ""
    up0: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind not in KIND_DIMS:
            raise ValueError(f"unknown trajectory kind {self.kind!r}")

    @property
    def num_frames(self) -> int:
        return int(self.params.shape[0])

    def rotations(self) -> np.ndarray:
        """(T, 3, 3) float32 rotation matrices of an ``so3`` trajectory."""
        if self.kind != "so3":
            raise ValueError(f"rotations() needs an so3 trajectory, got {self.kind}")
        w = torch.as_tensor(np.asarray(self.params, np.float32))
        return so3.exp(w).numpy()

    def save(self, path: str):
        extra = {}
        if self.up0 is not None:
            extra["up0"] = np.asarray(self.up0, np.float64)
        np.savez(
            path, version=FORMAT_VERSION, kind=self.kind, params=self.params,
            fps_num=self.fps.numerator, fps_den=self.fps.denominator,
            width=self.width, height=self.height, source=self.source, **extra,
        )

    @staticmethod
    def load(path: str) -> "Trajectory":
        with np.load(path, allow_pickle=False) as z:
            version = int(z["version"])
            if version == 1:
                params, kind = z["rotvecs"], "so3"
            elif version == FORMAT_VERSION:
                params, kind = z["params"], str(z["kind"])
            else:
                raise ValueError(f"unsupported trajectory version {version}")
            return Trajectory(
                params=params, kind=kind,
                fps=Fraction(int(z["fps_num"]), int(z["fps_den"])),
                width=int(z["width"]), height=int(z["height"]),
                source=str(z["source"]),
                up0=z["up0"] if "up0" in z.files else None,
            )


def trajectory_path(dest: str) -> str:
    """``<dest>.traj.npz``."""
    return dest + ".traj.npz"
