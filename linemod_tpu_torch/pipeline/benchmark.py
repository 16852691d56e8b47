"""Accuracy scoring against ground truth (counterpart of
`linemod_tpu/pipeline/benchmark.py`). ADD only so far: VSD needs the
renderer, which is not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import add_error
from ..types import ObjectPose
from ..utils.cvyaml import read_cvyaml
from ..utils.geometry import mat_to_quat, quat_to_mat
from ..utils.ply import load_ply


def read_ground_truth_pose(path: str) -> ObjectPose:
    """Pose YAML with `rotMat` (3x3) and `position` (mm)."""
    d = read_cvyaml(path)
    rot = np.asarray(d["rotMat"], np.float64)
    pos = np.asarray(d["position"], np.float64).ravel()
    return ObjectPose(translation=pos, quaternion=mat_to_quat(rot))


def model_vertices(path: str, device) -> torch.Tensor:
    """A PLY model's vertices as float32 [V, 3] on `device`."""
    return torch.from_numpy(load_ply(path).vertices.astype(np.float32)).to(device)


def score_add(vertices: torch.Tensor, gt: ObjectPose, est: ObjectPose) -> float:
    """ADD in mm of `est` against `gt` over the model's vertices."""

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=vertices.device)

    return float(
        add_error(
            vertices,
            f32(quat_to_mat(gt.quaternion)), f32(gt.translation),
            f32(quat_to_mat(est.quaternion)), f32(est.translation),
        )
    )
