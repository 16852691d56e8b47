"""Pose accuracy metrics (counterpart of `linemod_tpu/ops/metrics.py`), with
the reference Benchmark's thresholds (src/Benchmark.cpp):

- VSD (Hodan): render the ground truth and the estimate, take each one's
  visibility against the measured scene with a 15 mm occlusion tolerance;
  error = 1 - |pixels within 20 mm of each other, visible in both| /
  |visible in either|; correct below 0.3;
- ADD (LINEMOD): the mean distance of the model's vertices under the two
  poses; correct at or below the object diameter;
- ADD-S: the symmetric variant, each vertex of one cloud to its nearest in
  the other, over a subsampled cloud (every 40th vertex).

The sums are float32 products and adds, never a TF32 matmul. ADD-S's
|a|^2 + |b|^2 - 2 a.b cancels ~0.06 mm^2 of rounding at 600 mm; its three-
term dot products are the rasterizer's `dot3`, fused as XLA's CPU backend
contracts the reference's, so the port's ADD-S keeps the reference's
roundings (within 4e-5 mm on seeded poses, where the two orders differ by
up to 7e-4 mm).
"""

from __future__ import annotations

import torch

from .rasterizer import MeshArrays, dot3, render, transform

VISIBILITY_TOLERANCE_MM = 15.0
ERROR_THRESHOLD_MM = 20.0
VSD_CORRECT = 0.3
OBJECT_DIAMETER = 21.0  # mm; a pose is ADD-correct at or below this
ADDS_SUBSAMPLE = 40


def visibility_masks(gt_render, est_render, scene_depth):
    """(visible ground truth, visible estimate) masks. A rendered surface is
    visible where it exists and lies at most 15 mm behind the measured
    scene; the estimate is also visible wherever the ground truth is and
    the estimate rendered (so its own misalignment is not excused as
    occlusion)."""
    vis_gt = (gt_render > 0) & ~((gt_render - scene_depth) > VISIBILITY_TOLERANCE_MM)
    vis_est = (est_render > 0) & ~((est_render - scene_depth) > VISIBILITY_TOLERANCE_MM)
    return vis_gt, vis_est | (vis_gt & (est_render > 0))


def vsd_error(gt_render, est_render, scene_depth) -> torch.Tensor:
    """error = 1 - |closer than 20 mm, in both visible| / |in either visible|."""
    vis_gt, vis_est = visibility_masks(gt_render, est_render, scene_depth)
    close = (gt_render - est_render).abs() < ERROR_THRESHOLD_MM
    num = (close & vis_gt & vis_est).sum()
    den = (vis_gt | vis_est).sum().clamp(min=1)
    return 1.0 - num.float() / den.float()


def render_pose_depth(mesh: MeshArrays, rot, trans, fx, fy, *, width: int, height: int):
    """Depth render with the principal point at the image centre."""
    return render(mesh, rot, trans, fx, fy, width / 2.0, height / 2.0, width=width, height=height)


def add_error(vertices, rot_gt, t_gt, rot_est, t_est) -> torch.Tensor:
    """Mean distance between the model's vertices [V, 3] under the ground
    truth pose and under the estimate (LINEMOD ADD), in the input's units."""
    a = transform(vertices, rot_gt, t_gt)
    b = transform(vertices, rot_est, t_est)
    return torch.linalg.norm(a - b, dim=1).mean()


def adds_error(sub_vertices, rot_gt, t_gt, rot_est, t_est) -> torch.Tensor:
    """Mean over the ground-truth cloud of the distance to the nearest
    estimate vertex: ||a_i - b_j||^2 = |a|^2 + |b|^2 - 2 a.b."""
    a = transform(sub_vertices, rot_gt, t_gt)
    b = transform(sub_vertices, rot_est, t_est)
    ab = dot3(a[:, None, :], b[None, :, :])
    d2 = (dot3(a, a)[:, None] + dot3(b, b)[None, :] - 2.0 * ab).clamp(min=0.0)
    return d2.amin(dim=1).sqrt().mean()
