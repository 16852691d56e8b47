"""Triangle rasterizer: z-buffering as linear functionals of the pixel ray
and a masked min-reduce (counterpart of `linemod_tpu/ops/rasterizer.py`,
which replaces the reference's OpenGL offscreen renderer).

For a pinhole camera each triangle's edge functions and its perspective-
correct depth are linear functionals of the pixel ray q = ((u - cx) / fx,
(v - cy) / fy, 1). Faces are sorted by their projected top row and cut into
blocks of FACE_BLOCK; the image into bands of BAND_ROWS rows. A band
evaluates only the blocks whose projected row range meets it, as the
reference does, and only the columns that their faces' computed inside
test can reach (`_ray_reach`; the few faces whose rounding reaches further
are evaluated alone over the band's other columns). The ranges come to the
host once a render (one sync: renders are not on the per-frame detect
path). A pixel keeps its nearest face; the first minimum wins ties, in
block order, as in the reference.

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
# columns a face's reach may pass its own projection before it is wild
WILD_SLACK_PX = 2.0
# pixel-face pairs a z-buffer step evaluates at most (its float64 temporaries
# are [pixels, faces, 3]); a step is at least one block
_STEP_PAIRS = {"cpu": 1 << 21, "cuda": 1 << 24}


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


def _face_functionals(p_cam: torch.Tensor, faces: torch.Tensor, fy, cy):
    """Per face: (M [F, 3, 3], |det| [F], valid [F], zlo, zhi [F], vlo, vhi [F]).

    Rows of M are the edge cofactors c_i = cross(p_j, p_k) times sign(det):
    for a pixel ray q, lambda_i = c_i . q are (up to the factor det) the 3-D
    barycentric weights of the ray's hit, so inside = all lambda_i >= 0 and
    depth = |det| / sum(lambda). vlo/vhi are the face's projected rows
    (+-inf where it is not valid)."""
    tri = p_cam[faces]  # [F, 3, 3]
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    c = _cross(torch.stack([p1, p2, p0], 1), torch.stack([p2, p0, p1], 1))  # rows c0, c1, c2
    det = dot3(c[:, 0], p0)
    z = tri[:, :, 2]
    valid = (det.abs() > 1e-6) & (z > NEAR_MM).all(-1) & (z < FAR_MM).all(-1)
    m = c * torch.sign(det)[:, None, None]
    rows = fy * tri[:, :, 1] / z + cy
    inf = torch.full_like(det, torch.inf)
    vlo = torch.where(valid, rows.amin(-1), inf)
    vhi = torch.where(valid, rows.amax(-1), -inf)
    return m, det.abs(), valid, z.amin(-1), z.amax(-1), vlo, vhi


def _ray_reach(m, valid, tri, qx_max: float, qy_max: float, wild_slack: float):
    """Per face, the interval of ray x = (u - cx) / fx outside which the
    computed inside test cannot pass, in float64: (lo [F], hi [F], wild [F]).

    A computed edge function c_i . q (two roundings and a fused add) is
    within b_i = 4 u (|qx m_i0| + |qy m_i1| + |m_i2|) of the exact one, u =
    2^-24, so every ray that passes lies in the triangle whose edges are
    moved outward by b_i: the intersection of the three half-planes
    m_i . q >= -b_i. Its corners are where two of those lines meet. It is
    bounded when the three edge normals positively span the plane (their
    pairwise cross products share a sign).

    A face is `wild` where that triangle is unbounded (a face of three equal
    vertices, such as the padding, whose inside test is all rounding) or
    reaches more than `wild_slack` past the face's own rays (a sliver, whose
    corners move far along its edges); lo/hi are +-inf for wild faces and
    for faces that are not valid."""
    md = m.double()
    n0, n1, n2 = md[..., 0], md[..., 1], md[..., 2]  # [F, 3] over the edges i
    b = 4.0 * 2.0**-24 * (qx_max * n0.abs() + qy_max * n1.abs() + n2.abs())
    rhs = -b - n2
    xs, crosses = [], []
    for i, j in ((0, 1), (1, 2), (2, 0)):
        d = n0[:, i] * n1[:, j] - n1[:, i] * n0[:, j]
        crosses.append(d)
        xs.append((rhs[:, i] * n1[:, j] - rhs[:, j] * n1[:, i]) / d)
    xs, crosses = torch.stack(xs, -1), torch.stack(crosses, -1)
    bounded = ((crosses > 0).all(-1) | (crosses < 0).all(-1)) & torch.isfinite(xs).all(-1)
    lo, hi = xs.amin(-1), xs.amax(-1)
    own = tri[:, :, 0].double() / tri[:, :, 2].double()
    tight = bounded & (own.amin(-1) - lo <= wild_slack) & (hi - own.amax(-1) <= wild_slack)
    keep = valid & tight
    inf = torch.full_like(lo, torch.inf)
    return torch.where(keep, lo, inf), torch.where(keep, hi, -inf), valid & ~tight


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
    focal_reciprocal: bool = False,
):
    """Render one view. Returns depth [H, W] float32 mm (0 = empty) and,
    with `with_color`, also the color image [H, W, 3] float32 in [0, 1].

    rotation [3, 3] / translation [3] (arrays or tensors): the object-to-
    camera transform, p_cam = R v + t. `origin` places the window's top-left
    pixel for cropped renders; width and height are the window's size.

    `focal_reciprocal` scales the pixel rays by the float32 reciprocals of
    fx and fy instead of dividing by them. The reference's template
    generation compiles its renders with the camera as constants, and XLA
    turns a division by a constant into that product; its other renders
    divide. The two round apart by up to ~0.008 mm in depth."""
    if height % BAND_ROWS:
        raise ValueError(f"height {height} is not a multiple of {BAND_ROWS}")
    dev = mesh.vertices.device
    rot, trans = _f32(rotation, dev), _f32(translation, dev)
    p_cam = transform(mesh.vertices, rot, trans)
    m, det, valid, zlo, zhi, vlo, vhi = _face_functionals(p_cam, mesh.faces, fy, cy)
    nblocks = mesh.faces.shape[0] // FACE_BLOCK
    # faces sorted by projected top row: a block's rows are then coherent,
    # and most blocks miss most bands
    order = torch.argsort(vlo, stable=True)
    m, det, valid, zlo, zhi = m[order], det[order], valid[order], zlo[order], zhi[order]
    ox, oy = float(origin[0]), float(origin[1])
    # divisors as tensors: torch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds unlike the reference
    fx_t, fy_t = (torch.tensor(f, dtype=torch.float32, device=dev) for f in (fx, fy))
    if focal_reciprocal:
        one = torch.ones((), dtype=torch.float32, device=dev)
        fx_t, fy_t = one / fx_t, one / fy_t

    def ray(pix, c, f_t):
        return (pix - c) * f_t if focal_reciprocal else (pix - c) / f_t

    u = ray(torch.arange(width, dtype=torch.float32, device=dev) + ox, cx, fx_t)
    # a bound on |q| over the window for the rays' reach (1% over)
    qx_max = 1.01 * max(abs(ox - cx), abs(ox + width - cx)) / fx
    qy_max = 1.01 * max(abs(oy - cy), abs(oy + height - cy)) / fy
    lo, hi, wild = _ray_reach(m, valid, p_cam[mesh.faces[order]], qx_max, qy_max, WILD_SLACK_PX / fx)
    # the blocks' projected rows and their bounded faces' reach, the
    # window's rays, and the wild faces' vertices (-1 for the others), on
    # the host (one sync)
    host = torch.cat([
        vlo[order].reshape(nblocks, FACE_BLOCK).amin(1).double(),
        vhi[order].reshape(nblocks, FACE_BLOCK).amax(1).double(),
        lo.reshape(nblocks, FACE_BLOCK).amin(1),
        hi.reshape(nblocks, FACE_BLOCK).amax(1),
        u.double(),
        torch.where(wild[:, None], mesh.faces[order], -1).double().ravel(),
    ]).cpu().numpy()
    blk = host[: 4 * nblocks].reshape(4, nblocks).tolist()
    u_host = host[4 * nblocks : 4 * nblocks + width]
    wild_tri = host[4 * nblocks + width :].reshape(-1, 3)
    wild_pos = np.nonzero(wild_tri[:, 0] >= 0)[0]
    budget = _STEP_PAIRS.get(dev.type, _STEP_PAIRS["cuda"])

    zimg = torch.full((height, width), torch.inf, dtype=torch.float32, device=dev)
    fimg = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    for band in range(height // BAND_ROWS):
        band_v0 = band * BAND_ROWS + oy  # the band's first image row
        blocks = [
            b for b in range(nblocks)
            if blk[0][b] <= band_v0 + BAND_ROWS and blk[1][b] >= band_v0 - 1.0
        ]
        if not blocks:
            continue
        rows = slice(band * BAND_ROWS, (band + 1) * BAND_ROWS)
        v = ray(torch.arange(BAND_ROWS, dtype=torch.float32, device=dev) + band_v0, cy, fy_t)
        # the columns whose rays the blocks' bounded faces can reach (one
        # column's margin each side): there every face of the blocks
        c0 = max(0, int(np.searchsorted(u_host, min(blk[2][b] for b in blocks))) - 1)
        c1 = max(c0, min(width, int(np.searchsorted(u_host, max(blk[3][b] for b in blocks), "right")) + 1))
        if c1 > c0:
            cols = torch.arange(c0, c1, device=dev)
            zmin, fid = _zbuffer(_rays(u, v, cols), _face_steps(blocks, BAND_ROWS * (c1 - c0), budget),
                                 m, det, valid, zlo, zhi, order)
            zimg[rows, c0:c1] = zmin.reshape(BAND_ROWS, -1)
            fimg[rows, c0:c1] = fid.reshape(BAND_ROWS, -1)
        # elsewhere only a wild face can pass; one that repeats an earlier
        # one's vertices (the padding faces) never beats it, since the
        # first minimum wins
        in_band = wild_pos[np.isin(wild_pos // FACE_BLOCK, blocks)]
        if len(in_band) and (c0 > 0 or c1 < width):
            first = np.sort(in_band[np.unique(wild_tri[in_band], axis=0, return_index=True)[1]])
            cols = torch.cat([torch.arange(0, c0, device=dev), torch.arange(c1, width, device=dev)])
            idx = torch.as_tensor(first, device=dev)
            zmin, fid = _zbuffer(_rays(u, v, cols), [[idx]], m, det, valid, zlo, zhi, order)
            zimg[rows] = zimg[rows].index_copy(1, cols, zmin.reshape(BAND_ROWS, -1))
            fimg[rows] = fimg[rows].index_copy(1, cols, fid.reshape(BAND_ROWS, -1))
    hit = torch.isfinite(zimg)
    depth = torch.where(hit, zimg, 0.0)
    if not with_color:
        return depth
    # the color of the covered pixels only (a sync for their count)
    pix = torch.nonzero(hit.reshape(-1)).squeeze(1)
    v = ray(torch.arange(height, dtype=torch.float32, device=dev) + oy, cy, fy_t)
    q = torch.stack([u[pix % width], v[pix // width], torch.ones_like(pix, dtype=torch.float32)], dim=-1)
    rgb = torch.zeros((height * width, 3), dtype=torch.float32, device=dev)
    rgb[pix] = _color(mesh, p_cam, q, fimg.reshape(-1)[pix])
    return depth, rgb.reshape(height, width, 3).clamp(0.0, 1.0)


def _rays(u, v, cols) -> torch.Tensor:
    """[BAND_ROWS * len(cols), 3] pixel rays of a band's columns, row-major."""
    n = cols.shape[0]
    return torch.stack([u[cols][None, :].expand(BAND_ROWS, n), v[:, None].expand(BAND_ROWS, n),
                        torch.ones((BAND_ROWS, n), dtype=torch.float32, device=u.device)], dim=-1).reshape(-1, 3)


def _face_steps(blocks: list, pixels: int, budget: int) -> list:
    """The band's blocks in block order as steps of at most `budget`
    pixel-face pairs (at least one block a step), each step a list of face
    slices: its runs of consecutive blocks."""
    per_step = max(1, budget // (pixels * FACE_BLOCK))
    steps = []
    for i in range(0, len(blocks), per_step):
        runs = []
        for b in blocks[i : i + per_step]:
            if runs and runs[-1][1] == b:
                runs[-1][1] = b + 1
            else:
                runs.append([b, b + 1])
        steps.append([slice(r0 * FACE_BLOCK, r1 * FACE_BLOCK) for r0, r1 in runs])
    return steps


def _zbuffer(q, steps, m, det, valid, zlo, zhi, order):
    """The nearest face a ray over the faces of `steps` (lists of slices or
    index tensors of sorted positions, all in sorted order): (zmin [P],
    face id [P], -1 where none). The first minimum wins ties, as it does
    block by block in the reference."""
    zmin = torch.full((q.shape[0],), torch.inf, dtype=torch.float32, device=q.device)
    fid = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    qx, qy = q[:, 0, None], q[:, 1, None]
    for step in steps:
        def take(t):
            return t[step[0]] if len(step) == 1 else torch.cat([t[s] for s in step])

        ms, ds, vs, lo_s, hi_s, ids = (take(t) for t in (m, det, valid, zlo, zhi, order))
        # the three edge functions m_i . q, each [P, B], as dot3 (q_z is 1)
        e = [_fma(qy, ms[None, :, i, 1], qx * ms[None, :, i, 0]) + ms[None, :, i, 2] for i in range(3)]
        # inclusive fill rule: a pixel exactly on a shared edge belongs to
        # both triangles (their cofactors are exact negations), which
        # closes cracks without an epsilon band
        inside = (e[0] >= 0.0) & (e[1] >= 0.0) & (e[2] >= 0.0) & vs[None, :]
        den = (e[0] + e[1]) + e[2]
        z = ds[None, :] / torch.where(den == 0.0, 1.0, den)
        # clamp to the triangle's own z-range: kills sliver artifacts
        z_ok = (z >= lo_s[None, :] - 1.0) & (z <= hi_s[None, :] + 1.0)
        z = torch.where(inside & z_ok, z, torch.inf)
        bmin, barg = z.min(dim=1)  # the first minimum
        better = bmin < zmin
        zmin = torch.where(better, bmin, zmin)
        fid = torch.where(better, ids[barg], fid)
    return zmin, fid


def _color(mesh: MeshArrays, p_cam, q, fid) -> torch.Tensor:
    """Perspective-correct vertex color of covered pixels (rays q [P, 3],
    winning faces fid [P]), fused as XLA's CPU backend fuses the
    reference's: each lambda_i = c_i . q as dot3, their sum left to right,
    and the weighted colors as dot3."""
    tri = mesh.faces[fid]  # [P, 3]
    pv = p_cam[tri]  # [P, 3, 3]
    # c_i = cross(p_j, p_k) for (i, j, k) = (0, 1, 2), (1, 2, 0), (2, 0, 1)
    c = _cross(torch.stack([pv[:, 1], pv[:, 2], pv[:, 0]], 1), torch.stack([pv[:, 2], pv[:, 0], pv[:, 1]], 1))
    # lambda_i are already the perspective-correct 3-D barycentric weights
    lam = dot3(c, q[:, None, :])
    lam_sum = ((lam[:, 0] + lam[:, 1]) + lam[:, 2])[:, None]
    wgt = lam / torch.where(lam_sum.abs() < 1e-12, 1.0, lam_sum)
    return dot3(wgt[:, None, :], mesh.colors[tri].transpose(1, 2))


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
