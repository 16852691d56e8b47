"""Accuracy scoring against ground truth (counterpart of
`linemod_tpu/pipeline/benchmark.py`, which replaces the reference's
Benchmark loop and counters, src/Benchmark.cpp).

Poses are scored with VSD (Hodan), ADD and ADD-S (ops/metrics.py), with
running counters like the reference's. Ground truth comes from the
reference's `pose{i}.yml` files or the public LINEMOD dataset's .tra/.rot
pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import (
    ADDS_SUBSAMPLE,
    OBJECT_DIAMETER,
    VSD_CORRECT,
    add_error,
    adds_error,
    render_pose_depth,
    vsd_error,
)
from ..ops.rasterizer import mesh_to_arrays
from ..types import ObjectPose
from ..utils.yamlcv import read_yamlcv
from ..utils.geometry import mat_to_quat, quat_to_mat, rotation_about_axis
from ..utils.ply import load_ply


def read_ground_truth_pose(path: str) -> ObjectPose:
    """Pose YAML with `rotMat` (3x3) and `position` (mm)."""
    d = read_yamlcv(path)
    rot = np.asarray(d["rotMat"], np.float64)
    pos = np.asarray(d["position"], np.float64).ravel()
    return ObjectPose(translation=pos, quaternion=mat_to_quat(rot))


def read_ground_truth_linemod(tra_path: str, rot_path: str) -> ObjectPose:
    """The public LINEMOD dataset's ground truth: .tra in cm (to mm, x10)
    and .rot with the reference's frame fix, -pi/2 about x
    (src/Benchmark.cpp:196-245)."""
    tra = np.loadtxt(tra_path, skiprows=1).ravel()
    rot = np.loadtxt(rot_path, skiprows=1).reshape(3, 3)
    adj = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0)
    return ObjectPose(translation=tra[-3:] * 10.0, quaternion=mat_to_quat(adj @ rot))


def model_vertices(path: str, device) -> torch.Tensor:
    """A PLY model's vertices as float32 [V, 3] on `device`."""
    return torch.from_numpy(load_ply(path).vertices.astype(np.float32)).to(device)


def _pose_tensors(pose: ObjectPose, device) -> tuple:
    """(rotation [3, 3], translation [3]) float32 on `device`."""
    return (
        torch.as_tensor(quat_to_mat(pose.quaternion).astype(np.float32), device=device),
        torch.as_tensor(np.asarray(pose.translation, np.float32), device=device),
    )


def score_add(vertices: torch.Tensor, gt: ObjectPose, est: ObjectPose) -> float:
    """ADD in mm of `est` against `gt` over the model's vertices."""
    dev = vertices.device
    return float(add_error(vertices, *_pose_tensors(gt, dev), *_pose_tensors(est, dev)))


class Benchmark:
    """One model's scorer on `device`, with the reference's counters: a VSD
    below 0.3 counts toward the Hodan score, an ADD or ADD-S at or below the
    diameter toward the ADD count."""

    def __init__(self, mesh, cam, device):
        self.cam = cam
        self.device = torch.device(device)
        self.marr = mesh_to_arrays(mesh, self.device)
        self.vertices = self.marr.vertices
        self.sub_vertices = torch.as_tensor(
            np.asarray(mesh.subsampled_vertices(ADDS_SUBSAMPLE), np.float32), device=self.device
        )
        self.image_counter = 0
        self.hodan_correct = 0
        self.add_correct = 0

    def render(self, pose: ObjectPose) -> torch.Tensor:
        """The depth render of `pose`, principal point at the image centre."""
        return render_pose_depth(
            self.marr, *_pose_tensors(pose, self.device), self.cam.fx, self.cam.fy,
            width=self.cam.width, height=self.cam.height,
        )

    def score_vsd(self, scene_depth: np.ndarray, gt: ObjectPose, est: ObjectPose) -> float:
        """VSD of `est` against `gt` over the recentred scene depth (mm)."""
        scene = torch.as_tensor(np.asarray(scene_depth, np.float32), device=self.device)
        err = float(vsd_error(self.render(gt), self.render(est), scene))
        if err < VSD_CORRECT:
            self.hodan_correct += 1
        return err

    def score_add(self, gt: ObjectPose, est: ObjectPose, diameter: float = OBJECT_DIAMETER) -> float:
        err = score_add(self.vertices, gt, est)
        if err <= diameter:
            self.add_correct += 1
        return err

    def score_adds(self, gt: ObjectPose, est: ObjectPose, diameter: float = OBJECT_DIAMETER) -> float:
        err = float(adds_error(
            self.sub_vertices, *_pose_tensors(gt, self.device), *_pose_tensors(est, self.device)
        ))
        if err <= diameter:
            self.add_correct += 1
        return err

    def next_image(self) -> None:
        self.image_counter += 1

    @property
    def hodan_score(self) -> float:
        return 100.0 * self.hodan_correct / max(self.image_counter, 1)

    def print_scores(self) -> None:
        print(f"Hodan Score: {self.hodan_score:.1f} Counter: {self.image_counter}")
