"""Synthetic multi-frame accuracy evaluation (counterpart of
`linemod_tpu/pipeline/synth_eval.py`).

The reference's accuracy protocol is a running score over a frame sequence
(src/Benchmark.cpp:11-16,247-251; detector.cpp:17-45). Without the public
LINEMOD dataset, this module builds an evaluation sequence with exact ground
truth: random in-bank and between-template poses of the model over
cluttered backgrounds, with the fixture sensor's measured +40 mm
shiny-object depth corruption, speckle holes and cube distractors.

The renders run on `device` through `ops/rasterizer.render` in its default
form (dividing by the focal lengths, as the reference's traced camera does);
the compositing is the reference's numpy on the same
`np.random.default_rng((seed, index))` stream. A frame is therefore the
reference's byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CameraParameters
from ..ops.rasterizer import mesh_to_arrays, render
from ..types import ObjectPose
from ..utils.geometry import (
    mat_to_quat,
    quat_to_mat,
    rotation_about_axis,
    view_ray_rotation,
)
from ..utils.ply import Mesh

SHINY_OFFSET_MM = 40.0  # the fixture capture reads ~+40 mm on the object
# Background = a support surface this far behind the object (a bin-picking
# part rests on/near a table, as in the captured fixture). A far wall
# instead would defeat the reference ICP's |z - mean| <= 300 mm outlier-cut
# semantics (prepareDepthForIcp assumes the bbox window is object+support).
BG_BEHIND_MM = 150.0
MODES = ("clean", "shiny", "holes", "clutter")


def _cube_mesh(half=40.0):
    v = np.array(
        [
            [sx, sy, sz]
            for sx in (-half, half)
            for sy in (-half, half)
            for sz in (-half, half)
        ],
        np.float32,
    )
    faces = []
    for axis in range(3):
        for side in (0, 1):
            idx = [i for i in range(8) if (i >> (2 - axis)) & 1 == side]
            faces += [[idx[0], idx[1], idx[2]], [idx[1], idx[3], idx[2]]]
    colors = 0.2 + 0.6 * (v - v.min()) / (v.max() - v.min())
    return Mesh(
        vertices=v,
        colors=colors.astype(np.float32),
        indices=np.asarray(faces, np.uint32),
    )


def eval_camera(cam: CameraParameters) -> CameraParameters:
    """The eval camera: same intrinsics scale, principal point centred (the
    generator renders with a centred pp, so recentring is the identity and
    GT poses live directly in the detector's working frame)."""
    return dataclasses.replace(cam, cx=cam.width / 2.0, cy=cam.height / 2.0)


def sample_gt_pose(rng, bank, cam: CameraParameters, radius_jitter=20.0,
                   inplane_jitter_deg=5.0, view_jitter_deg=4.0,
                   px_range=(120, 90)):
    """A between-template GT pose near the bank's coverage manifold."""
    t = int(rng.integers(bank.num_templates))
    z = float(bank.z[t]) + float(rng.uniform(-radius_jitter, radius_jitter))
    u = float(rng.uniform(-px_range[0], px_range[0]))
    v = float(rng.uniform(-px_range[1], px_range[1]))
    tx = u * z / cam.fx
    ty = v * z / cam.fy
    trans = np.array([tx, ty, z], np.float64)
    r_base = quat_to_mat(bank.quat[t])
    r_inplane = rotation_about_axis(
        [0.0, 0.0, 1.0], np.deg2rad(rng.uniform(-inplane_jitter_deg,
                                                inplane_jitter_deg))
    )
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    r_view = rotation_about_axis(
        axis, np.deg2rad(rng.uniform(0.0, view_jitter_deg))
    )
    rot = view_ray_rotation(trans) @ r_view @ r_inplane @ r_base
    return ObjectPose(translation=trans, quaternion=mat_to_quat(rot)), t


class SyntheticEvalSet:
    """Deterministic generator of (color, depth, gt, meta) eval frames; the
    renders run on `device`."""

    def __init__(self, mesh, bank, cam: CameraParameters, seed: int = 0, device="cuda"):
        self.cam = eval_camera(cam)
        self.bank = bank
        self.device = torch.device(device)
        self.marr = mesh_to_arrays(mesh, self.device)
        self.cube = mesh_to_arrays(_cube_mesh(), self.device)
        self.seed = seed

    def _render(self, marr, rot, trans):
        d, c = render(
            marr,
            np.asarray(rot, np.float32),
            np.asarray(trans, np.float32),
            self.cam.fx,
            self.cam.fy,
            self.cam.width / 2.0,
            self.cam.height / 2.0,
            width=self.cam.width,
            height=self.cam.height,
            with_color=True,
        )
        return d.cpu().numpy(), c.cpu().numpy()

    def make_frame(self, index: int, mode: str = "shiny", **pose_kwargs):
        """mode: 'clean' | 'shiny' | 'holes' | 'clutter' (the last three all
        include the shiny +40 mm object-depth corruption). pose_kwargs
        forward to sample_gt_pose (jitter ablations use them: the rng
        stream is shared, so zeroing one jitter keeps every other draw of
        the frame identical)."""
        rng = np.random.default_rng((self.seed, index))
        cam = self.cam
        h, w = cam.height, cam.width

        gt, t_base = sample_gt_pose(rng, self.bank, cam, **pose_kwargs)
        d_obj, c_obj = self._render(
            self.marr, quat_to_mat(gt.quaternion), gt.translation
        )

        # blocky noise background (patch borders feed the gradient
        # quantizer the way real clutter does); palette darker than the
        # white object render so its silhouette keeps contrast: the bank's
        # features are boundary gradients of a flat white render, and a
        # near-white patch under the boundary erases them (a real capture
        # of a light part in a dark bin has the same property)
        bh, bw = h // 16, w // 16
        patches = rng.uniform(0, 130, (bh, bw, 3)).astype(np.float32)
        color = np.repeat(np.repeat(patches, 16, axis=0), 16, axis=1)
        bg_depth = float(gt.translation[2]) + BG_BEHIND_MM
        depth = (
            bg_depth
            + 40.0 * np.repeat(
                np.repeat(rng.standard_normal((bh, bw)).astype(np.float32),
                          16, axis=0),
                16, axis=1,
            )
        )

        layers = [(d_obj, c_obj * 255.0, True)]
        if mode == "clutter":
            for _ in range(int(rng.integers(1, 3))):
                # distractors sit between the camera and the support surface
                zc = float(rng.uniform(0.55, 0.92)) * bg_depth
                uc = float(rng.uniform(-250, 250))
                vc = float(rng.uniform(-170, 170))
                tc = np.array([uc * zc / cam.fx, vc * zc / cam.fy, zc])
                ax = rng.normal(size=3)
                ax /= np.linalg.norm(ax)
                rc = rotation_about_axis(ax, rng.uniform(0, np.pi))
                dd, cc = self._render(self.cube, rc, tc)
                layers.append((dd, cc * 255.0, False))

        for dd, cc, is_obj in layers:
            dd = dd.copy()
            if is_obj and mode != "clean":
                dd = np.where(dd > 0, dd + SHINY_OFFSET_MM, 0.0)
            vis = (dd > 0) & (dd < depth)
            depth = np.where(vis, dd, depth)
            color = np.where(vis[..., None], cc, color)

        if mode == "holes":
            holes = (rng.uniform(size=depth.shape) < 0.03) & (
                depth < bg_depth - 60.0
            )
            depth = np.where(holes, 0.0, depth)

        meta = {"mode": mode, "base_template": t_base}
        return (
            color.astype(np.uint8),
            np.clip(depth, 0, 65535).astype(np.uint16),
            gt,
            meta,
        )
