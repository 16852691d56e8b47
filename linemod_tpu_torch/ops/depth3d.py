"""Depth image -> scene point cloud for ICP (counterpart of
`linemod_tpu/ops/depth3d.py`, which replaces the reference's
prepareDepthForIcp, src/HighLevelLinemodIcp.cpp:38-65).

An edge-aware 3x3 blur, a WINDOW x WINDOW crop at the bbox, pinhole
back-projection, the 300 mm outlier cut around the mean depth, a stable
valid-first subsample to SCENE_POINTS points, and per-pixel normals from the
organized window (oriented toward the camera). `knn_plane_normals` is the
reference's unorganized k-NN plane fit (k = 12), kept for callers that have
no organized image.

Rounding follows the reference's: the pixel rays multiply by the float32
reciprocals of the focal lengths (XLA's rewrite of a division by a
constant), the blur and the window sums are fixed-order float32 adds,
and the three-term dot and cross products fuse as XLA's CPU backend does
(`rasterizer.dot3`, `_cross`). The mean depth of the outlier cut is summed
in float64, so it does not depend on the device's reduction order. Nothing
here is a matmul, so no TF32 setting reaches it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .rasterizer import _cross, dot3

SCENE_POINTS = 4096  # the scene cloud's fixed size
KNN = 12  # computeNormalsPC3d's neighbourhood (src/HighLevelLinemodIcp.cpp:64)
OUTLIER_MM = 300.0
WINDOW = 384  # the bbox window
BLUR_EDGE_MM = 20.0


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device (the CPU
    build's vectorized float32 sqrt can be an ulp off; rounding the float64
    root to float32 is exact)."""
    return x.double().sqrt().float()


def _box_blur3(depth: torch.Tensor) -> torch.Tensor:
    """Edge-aware 3x3 box blur: a neighbour counts only if it is valid and
    within BLUR_EDGE_MM of the centre, so neither background zeros nor depth
    steps bleed into the surface. depth: [H, W] float32 mm."""
    h, w = depth.shape
    pad = F.pad(depth[None], (1, 1, 1, 1), mode="replicate")[0]
    s = torch.zeros_like(depth)
    c = torch.zeros_like(depth)
    for dy in range(3):
        for dx in range(3):
            nb = pad[dy : dy + h, dx : dx + w]
            ok = (nb > 0) & ((nb - depth).abs() < BLUR_EDGE_MM)
            s = s + torch.where(ok, nb, 0.0)
            c = c + ok.float()
    return torch.where(depth > 0, s / c.clamp(min=1.0), 0.0)


def scene_cloud_from_depth(depth: torch.Tensor, bbox, *, fx: float, fy: float, cx: float, cy: float):
    """Back-project the bbox region of a depth image into a fixed-size cloud.

    depth: [H, W] float32 mm on the cloud's device; bbox: (x, y, w, h) ints
    on the host. Returns (points [SCENE_POINTS, 3], normals [SCENE_POINTS,
    3], valid [SCENE_POINTS] bool), with no host sync."""
    dev = depth.device
    h, w = depth.shape
    x0, y0, bw, bh = (int(v) for v in bbox)
    blurred = F.pad(_box_blur3(depth), (0, WINDOW, 0, WINDOW))
    # the window's start is clamped into the padded image, its coordinates not
    sy, sx = min(max(y0, 0), h), min(max(x0, 0), w)
    win = blurred[sy : sy + WINDOW, sx : sx + WINDOW]
    ar = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    yy = (ar + float(y0))[:, None].expand(WINDOW, WINDOW)
    xx = (ar + float(x0))[None, :].expand(WINDOW, WINDOW)
    ai = torch.arange(WINDOW, device=dev)
    valid = (ai[:, None] < bh) & (ai[None, :] < bw) & (win > 0)

    # the reference's focal lengths are compile-time constants here, and XLA
    # turns a division by a constant into a product with its float32
    # reciprocal: so do the same
    xs = (xx - cx) * float(np.float32(1.0) / np.float32(fx))
    ys = (yy - cy) * float(np.float32(1.0) / np.float32(fy))
    pts = torch.stack([xs * win, ys * win, win], dim=-1).reshape(-1, 3)
    # organized (image-space) normals at the window's full resolution, before
    # the subsample (see organized_normals)
    nrm_img = organized_normals(win, xs, ys, valid).reshape(-1, 3)
    valid = valid.reshape(-1)

    # outlier cut: |z - mean z| > 300 mm over the valid points
    zf = pts[:, 2]
    n_valid = valid.sum()
    mean_z = (torch.where(valid, zf, 0.0).double().sum() / n_valid.clamp(min=1)).float()
    valid = valid & ((zf - mean_z).abs() <= OUTLIER_MM)

    # deterministic subsample: valid points first (stable), SCENE_POINTS of
    # them at a stride that spreads the picks over the window
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    n_valid = valid.sum()
    stride = (n_valid // SCENE_POINTS).clamp(min=1)
    picks = torch.arange(SCENE_POINTS, device=dev)
    idx = order[(picks * stride) % n_valid.clamp(min=1)]
    return pts[idx], nrm_img[idx], valid[idx] & (picks < n_valid)


def _roll_tangent(p, win, valid, axis: int, big_step_mm: float):
    """One axis's tangent of the organized cloud p [H, W, 3]: the central
    difference where both neighbours are valid and within big_step_mm, the
    one-sided one where only one is, and whether any is. The window's first
    and last row (column) have no neighbour beyond it."""
    fwd = torch.roll(p, -1, dims=axis) - p
    bwd = p - torch.roll(p, 1, dims=axis)
    n = win.shape[axis]
    idx = torch.arange(n, device=win.device)
    shape = [1, 1]
    shape[axis] = n
    not_last = (idx < n - 1).reshape(shape)
    not_first = (idx > 0).reshape(shape)
    v_f = not_last & torch.roll(valid, -1, dims=axis) & valid & (
        (torch.roll(win, -1, dims=axis) - win).abs() < big_step_mm
    )
    v_b = not_first & torch.roll(valid, 1, dims=axis) & valid & (
        (torch.roll(win, 1, dims=axis) - win).abs() < big_step_mm
    )
    cen = 0.5 * (fwd + bwd)
    t = torch.where((v_f & v_b)[..., None], cen, torch.where(v_f[..., None], fwd, bwd))
    return t, v_f | v_b


def organized_normals(win, xx, yy, valid, *, big_step_mm: float = BLUR_EDGE_MM):
    """Per-pixel normals of the organized depth window: the cross product of
    edge-aware differences of the back-projection, averaged over a masked
    3x3 neighbourhood, unit length, oriented toward the camera.

    win: [H, W] float32 depth mm (blurred); xx, yy: [H, W] the rays'
    (u - cx) / fx and (v - cy) / fy; valid: [H, W] bool. Returns [H, W, 3]
    (garbage where invalid; callers mask). Image-space differences see the
    full-resolution surface and cost elementwise work, where the
    reference's k-NN fit (`knn_plane_normals`) sorts a [S, S] distance
    matrix."""
    p = torch.stack([xx * win, yy * win, win], dim=-1)
    tx, vx = _roll_tangent(p, win, valid, 1, big_step_mm)
    ty, vy = _roll_tangent(p, win, valid, 0, big_step_mm)
    n = torch.where((vx & vy)[..., None], _cross(tx, ty), 0.0)
    h, w = win.shape
    pad = F.pad(n, (0, 0, 1, 1, 1, 1))
    s = torch.zeros_like(n)
    for dy in range(3):
        for dx in range(3):
            s = s + pad[dy : dy + h, dx : dx + w]
    norm = sqrt32(dot3(s, s))[..., None]
    n = s / norm.clamp(min=1e-12)
    flip = (dot3(n, p) > 0)[..., None]
    return torch.where(flip, -n, n)


def knn_plane_normals(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """k-NN plane-fit normals oriented toward the camera origin.

    points: [N, 3], valid: [N]. The normal is the smallest-eigenvalue
    eigenvector of the covariance of each point's KNN nearest valid
    neighbours; on equal distances the lower index is nearer (a stable
    sort, as the reference's top_k orders ties)."""
    p2 = dot3(points, points)
    d2 = p2[:, None] + p2[None, :] - 2.0 * dot3(points[:, None, :], points[None, :, :])
    d2 = torch.where(valid[None, :], d2, 1e12)
    nbr = torch.argsort(d2, dim=1, stable=True)[:, :KNN]
    nb = points[nbr]  # [N, K, 3]
    c = nb - nb.mean(dim=1, keepdim=True)
    cov = (c[:, :, :, None] * c[:, :, None, :]).sum(dim=1)  # [N, 3, 3]
    v = torch.linalg.eigh(cov)[1][:, :, 0]  # ascending eigenvalues
    flip = (dot3(v, points) > 0)[:, None]
    return torch.where(flip, -v, v)
