"""Core data types (the port's own copy of `linemod_tpu/types.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ObjectPose:
    """6-DOF pose in the CV camera frame, mm."""

    translation: np.ndarray  # [3] float
    quaternion: np.ndarray  # [4] float (w, x, y, z)
    bounding_box: tuple = (0, 0, 0, 0)  # (x, y, w, h) pixels

    def rotation_matrix(self) -> np.ndarray:
        from .utils.geometry import quat_to_mat

        return quat_to_mat(self.quaternion)
