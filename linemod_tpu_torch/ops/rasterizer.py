"""Triangle rasterizer: z-buffering as linear functionals of the pixel ray
and a masked min-reduce (counterpart of `linemod_tpu/ops/rasterizer.py`,
which replaces the reference's OpenGL offscreen renderer).

For a pinhole camera each triangle's edge functions and its perspective-
correct depth are linear functionals of the pixel ray q = ((u - cx) / fx,
(v - cy) / fy, 1). Faces are sorted by their projected top row and cut into
blocks of FACE_BLOCK; the image into bands of BAND_ROWS rows. A band
evaluates only the blocks whose projected row range meets it (the blocks'
ranges come to the host once a render, one sync: renders are not on the
per-frame detect path), and keeps the nearest face a pixel; the first
minimum wins ties, in block order, as in the reference.

The three-term dot products (the pose transform, the determinant and the
edge functions) are written as float32 products and fused adds, never a
matmul, so no TF32 setting can lower them (the mm-level depth gates
downstream need full float32). They fuse as XLA's CPU backend contracts the
reference's (`dot3`, `_cross`): the determinant cancels, so another order
moves a depth by up to ~0.2 mm at 600 mm, and this one gives the
reference's depths bit for bit.

Conventions: CV camera frame (x right, y down, z forward), mm, pixel =
(fx * x / z + cx, fy * y / z + cy); depth images float32 mm with 0 =
background; faces outside the near/far slab (100 / 10,000 mm) are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gradients import _fma

NEAR_MM = 100.0
FAR_MM = 10000.0
FACE_BLOCK = 512  # faces a block; meshes are padded to a multiple
BAND_ROWS = 32  # image rows a band; the height is a multiple


class MeshArrays(NamedTuple):
    """A mesh's buffers on one device."""

    vertices: torch.Tensor  # [V, 3] float32, model frame (mm)
    faces: torch.Tensor  # [F, 3] int64
    colors: torch.Tensor  # [V, 3] float32 in [0, 1]


def mesh_to_arrays(mesh, device) -> MeshArrays:
    """A host Mesh on `device`, its face list padded to a block multiple
    with degenerate (0, 0, 0) triangles, which the inside test rejects."""
    faces = np.asarray(mesh.indices, dtype=np.int64)
    f = faces.shape[0]
    target = max(FACE_BLOCK, int(np.ceil(f / FACE_BLOCK)) * FACE_BLOCK)
    if target > f:
        faces = np.concatenate([faces, np.zeros((target - f, 3), np.int64)], axis=0)
    return MeshArrays(
        vertices=torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=device),
        faces=torch.as_tensor(faces, device=device),
        colors=torch.as_tensor(np.asarray(mesh.colors, np.float32), device=device),
    )


def dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_k x_k y_k over the last axis (3), each later product fused into
    the running sum."""
    return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b, each component a_i b_j - a_j b_i with the first product fused."""

    def comp(i, j):
        return _fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def _face_functionals(p_cam: torch.Tensor, faces: torch.Tensor, fx, fy, cx, cy):
    """Per face: (M [F, 3, 3], |det| [F], valid [F], zlo, zhi [F], vlo, vhi
    [F], ulo, uhi [F]).

    Rows of M are the edge cofactors c_i = cross(p_j, p_k) times sign(det):
    for a pixel ray q, lambda_i = c_i . q are (up to the factor det) the 3-D
    barycentric weights of the ray's hit, so inside = all lambda_i >= 0 and
    depth = |det| / sum(lambda). vlo/vhi and ulo/uhi are the face's
    projected rows and columns (+-inf where it is not valid)."""
    tri = p_cam[faces]  # [F, 3, 3]
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    c0, c1, c2 = _cross(p1, p2), _cross(p2, p0), _cross(p0, p1)
    det = dot3(c0, p0)
    z = tri[:, :, 2]
    valid = (det.abs() > 1e-6) & (z > NEAR_MM).all(-1) & (z < FAR_MM).all(-1)
    m = torch.stack([c0, c1, c2], dim=1) * torch.sign(det)[:, None, None]
    inf = torch.full_like(det, torch.inf)
    ranges = []
    for proj in (fy * tri[:, :, 1] / z + cy, fx * tri[:, :, 0] / z + cx):
        ranges += [torch.where(valid, proj.amin(-1), inf), torch.where(valid, proj.amax(-1), -inf)]
    return (m, det.abs(), valid, z.amin(-1), z.amax(-1), *ranges)


def _edges(q: torch.Tensor, m: torch.Tensor) -> list:
    """The three [P, B] edge functions m[b, i] . q[p], as dot3 (q[:, 2] is 1)."""
    qx, qy = q[:, 0, None], q[:, 1, None]
    return [_fma(qy, m[None, :, i, 1], qx * m[None, :, i, 0]) + m[None, :, i, 2] for i in range(3)]


def transform(vertices: torch.Tensor, rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """vertices @ rot.T + t, each row's product as dot3."""
    return dot3(vertices[:, None, :], rot[None, :, :]) + t


def _f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def render(
    mesh: MeshArrays,
    rotation,
    translation,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    *,
    width: int = 640,
    height: int = 480,
    with_color: bool = False,
    origin=(0.0, 0.0),
):
    """Render one view. Returns depth [H, W] float32 mm (0 = empty) and,
    with `with_color`, also the color image [H, W, 3] float32 in [0, 1].

    rotation [3, 3] / translation [3] (arrays or tensors): the object-to-
    camera transform, p_cam = R v + t. `origin` places the window's top-left
    pixel for cropped renders; width and height are the window's size."""
    if height % BAND_ROWS:
        raise ValueError(f"height {height} is not a multiple of {BAND_ROWS}")
    dev = mesh.vertices.device
    rot, trans = _f32(rotation, dev), _f32(translation, dev)
    p_cam = transform(mesh.vertices, rot, trans)
    m, det, valid, zlo, zhi, vlo, vhi, ulo, uhi = _face_functionals(
        p_cam, mesh.faces, fx, fy, cx, cy
    )
    nblocks = mesh.faces.shape[0] // FACE_BLOCK
    # faces sorted by projected top row: a block's rows are then coherent,
    # and most blocks miss most bands
    order = torch.argsort(vlo, stable=True)
    m, det, valid, zlo, zhi = m[order], det[order], valid[order], zlo[order], zhi[order]
    # the blocks' projected rows and columns, on the host (one sync)
    blk = torch.stack([
        vlo[order].reshape(nblocks, FACE_BLOCK).amin(1),
        vhi[order].reshape(nblocks, FACE_BLOCK).amax(1),
        ulo[order].reshape(nblocks, FACE_BLOCK).amin(1),
        uhi[order].reshape(nblocks, FACE_BLOCK).amax(1),
    ]).tolist()

    ox, oy = float(origin[0]), float(origin[1])
    # divisors as tensors: torch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds unlike the reference
    fx_t, fy_t = (torch.tensor(f, dtype=torch.float32, device=dev) for f in (fx, fy))
    u = (torch.arange(width, dtype=torch.float32, device=dev) + ox - cx) / fx_t
    depth = torch.zeros((height, width), dtype=torch.float32, device=dev)
    rgb = torch.zeros((height, width, 3), dtype=torch.float32, device=dev) if with_color else None
    for band in range(height // BAND_ROWS):
        band_v0 = band * BAND_ROWS + oy  # the band's first image row
        blocks = [
            b for b in range(nblocks)
            if blk[0][b] <= band_v0 + BAND_ROWS and blk[1][b] >= band_v0 - 1.0
        ]
        if not blocks:
            continue
        # only the columns the band's blocks reach (with a pixel's margin:
        # a pixel further outside a triangle's projection is never inside)
        c0 = max(0, int(np.floor(min(blk[2][b] for b in blocks) - ox)) - 1)
        c1 = min(width, int(np.ceil(max(blk[3][b] for b in blocks) - ox)) + 2)
        if c0 >= c1:
            continue
        v_img = torch.arange(BAND_ROWS, dtype=torch.float32, device=dev) + float(band * BAND_ROWS) + oy
        v = (v_img - cy) / fy_t
        nc = c1 - c0
        q = torch.stack(
            [u[None, c0:c1].expand(BAND_ROWS, nc), v[:, None].expand(BAND_ROWS, nc),
             torch.ones((BAND_ROWS, nc), dtype=torch.float32, device=dev)], dim=-1,
        ).reshape(BAND_ROWS * nc, 3)
        zmin = torch.full((BAND_ROWS * nc,), torch.inf, dtype=torch.float32, device=dev)
        fid = torch.full((BAND_ROWS * nc,), -1, dtype=torch.int64, device=dev)
        for b in blocks:
            s = slice(b * FACE_BLOCK, (b + 1) * FACE_BLOCK)
            e0, e1, e2 = _edges(q, m[s])  # [pixels, B] each
            # inclusive fill rule: a pixel exactly on a shared edge belongs
            # to both triangles (their cofactors are exact negations), which
            # closes cracks without an epsilon band
            inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & valid[s][None, :]
            den = e0 + e1 + e2
            z = det[s][None, :] / torch.where(den == 0.0, 1.0, den)
            # clamp to the triangle's own z-range: kills sliver artifacts
            z_ok = (z >= zlo[s][None, :] - 1.0) & (z <= zhi[s][None, :] + 1.0)
            z = torch.where(inside & z_ok, z, torch.inf)
            bmin, barg = z.min(dim=1)  # the first minimum
            take = bmin < zmin
            zmin = torch.where(take, bmin, zmin)
            fid = torch.where(take, order[s][barg], fid)
        hit = torch.isfinite(zmin)
        rows = slice(band * BAND_ROWS, (band + 1) * BAND_ROWS)
        depth[rows, c0:c1] = torch.where(hit, zmin, 0.0).reshape(BAND_ROWS, nc)
        if with_color:
            rgb[rows, c0:c1] = _band_color(mesh, p_cam, q, fid, hit).reshape(BAND_ROWS, nc, 3)
    if not with_color:
        return depth
    return depth, rgb.clamp(0.0, 1.0)


def _band_color(mesh: MeshArrays, p_cam, q, fid, hit) -> torch.Tensor:
    """Perspective-correct vertex color of each pixel's winning face."""
    tri = mesh.faces[fid.clamp(min=0)]  # [P, 3]
    pv = p_cam[tri]  # [P, 3, 3]
    lam = torch.stack(
        [(_cross(pv[:, 1], pv[:, 2]) * q).sum(-1), (_cross(pv[:, 2], pv[:, 0]) * q).sum(-1),
         (_cross(pv[:, 0], pv[:, 1]) * q).sum(-1)], dim=-1,
    )
    # lambda_i are already the perspective-correct 3-D barycentric weights
    lam_sum = lam.sum(-1, keepdim=True)
    wgt = lam / torch.where(lam_sum.abs() < 1e-12, 1.0, lam_sum)
    rgb = (wgt[..., None] * mesh.colors[tri]).sum(1)
    return torch.where(hit[:, None], rgb, 0.0)


def render_views(mesh: MeshArrays, rotations, translations, cam, *, with_color: bool = False):
    """Render a stack of views with the principal point at the image centre
    (template generation, verification and VSD all render so; detection
    recentres its input frames to match).

    rotations [N, 3, 3], translations [N, 3] -> depth [N, H, W] (and color
    [N, H, W, 3] with `with_color`)."""
    views = [
        render(
            mesh, r, t, cam.fx, cam.fy, cam.width / 2.0, cam.height / 2.0,
            width=cam.width, height=cam.height, with_color=with_color,
        )
        for r, t in zip(rotations, translations)
    ]
    if not with_color:
        return torch.stack(views)
    return torch.stack([d for d, _ in views]), torch.stack([c for _, c in views])
