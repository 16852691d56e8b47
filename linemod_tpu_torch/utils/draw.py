"""Visualization overlays (the port's own copy of `linemod_tpu/utils/draw.py`,
which replaces drawCoordinateSystem / drawResponse,
src/PoseDetection.cpp:162-190, src/HighLevelLinemod.cpp:545-566)."""

from __future__ import annotations

import numpy as np

from .geometry import quat_to_mat


def _project(points, rot, trans, cam):
    p = points @ np.asarray(rot).T + np.asarray(trans)
    u = cam.fx * p[:, 0] / p[:, 2] + cam.cx
    v = cam.fy * p[:, 1] / p[:, 2] + cam.cy
    return np.stack([u, v], axis=1)


def _line(img, p0, p1, color, thickness=2):
    """Minimal Bresenham-ish line draw (no OpenCV)."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    for t in range(-(thickness // 2), thickness // 2 + 1):
        xi = np.clip(xs.astype(int) + t, 0, w - 1)
        yi = np.clip(ys.astype(int), 0, h - 1)
        img[yi, xi] = color
        xi = np.clip(xs.astype(int), 0, w - 1)
        yi = np.clip(ys.astype(int) + t, 0, h - 1)
        img[yi, xi] = color


def draw_coordinate_system(img, cam, length, pose):
    """Draw the pose's coordinate axes: x red, y green, z blue (BGR image)."""
    rot = quat_to_mat(pose.quaternion)
    pts = np.array(
        [[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]], np.float64
    )
    uv = _project(pts, rot, pose.translation, cam)
    _line(img, uv[0], uv[1], (0, 0, 255))
    _line(img, uv[0], uv[2], (0, 255, 0))
    _line(img, uv[0], uv[3], (255, 0, 0))
    return img


def draw_features(img, feats, valid, offset_xy, color=(0, 255, 0), radius=2):
    """Dot the template features at a match position (drawResponse analogue)."""
    h, w = img.shape[:2]
    for k in range(len(feats)):
        if not valid[k]:
            continue
        x = int(feats[k, 0] + offset_xy[0])
        y = int(feats[k, 1] + offset_xy[1])
        if 0 <= x < w and 0 <= y < h:
            img[
                max(y - radius, 0) : y + radius + 1, max(x - radius, 0) : x + radius + 1
            ] = color
    return img
