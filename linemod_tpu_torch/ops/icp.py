"""Batched point-to-plane ICP and verify-by-render pose selection
(counterpart of `linemod_tpu/ops/icp.py`, which replaces HighLevelLinemodIcp
and cv::ppf_match_3d::ICP, src/HighLevelLinemodIcp.cpp:67-137).

A group's candidate poses are refined together against the scene cloud
(`depth3d.scene_cloud_from_depth`): brute-force nearest neighbours over the
whole [M, S] distance matrix, correspondences beyond rejection_scale x the
mean distance dropped (the reference's rejectionScale 2.5,
src/PoseDetection.cpp:10), back-facing and normal-incompatible ones too, and
a 6x6 point-to-plane solve about the kept points' centroid. Each pose then
renders into a VERIFY_WINDOW crop around its group's bbox and is scored by
the mean |scene - render| over the twice-eroded mask; the best pose of a
group is accepted at or below VERIFY_ACCEPT_MM
(include/HighLevelLinemodIcp.h:76).

Arithmetic. No product here is a matmul, so no TF32 setting changes a pose.
The three-term dot and cross products are `rasterizer.dot3` / `_cross`,
and the nearest-neighbour products fuse as they do (`_pair_dot`), as XLA's
CPU backend fuses the reference's: plain float32 products change 1.6% of
the first iteration's pairings on the pose0 render. The sums over the model's
points (the mean distance, the centroid, the normal equations, the
residual) accumulate in float64, and the 6x6 system is solved in float64
with `solve_ex` (no singularity check, so no host sync); sqrt, sin and cos
round a float64 result. So a pose depends on neither the device's
reduction order nor its libm. All ITERATIONS iterations run, a converged
pose frozen by `where`, as the reference's scan does: the loop never waits
for the device. One iteration agrees with the reference's to a few ulps,
but its 16 are chaotic at that level (a start one ulp away moves its pose
by up to millimetres), so the port's poses are held to the reference's
poses from ulp-different starts (tests/test_torch_icp.py).

`IcpRefiner.refine_submit` waits for the renders: `rasterizer.render` reads
its blocks' ranges on the host once a render.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..types import ObjectPose
from ..utils.geometry import mat_to_quat, quat_to_mat
from .depth3d import scene_cloud_from_depth, sqrt32
from .extract import erode_mask
from .rasterizer import MeshArrays, _cross, dot3, render

REJECTION_SCALE = 2.5
ITERATIONS = 16  # the reference: 6 outer x 8 levels; one flat loop
VERIFY_ACCEPT_MM = 35.0  # correctEstimateTreshold
VERIFY_SCENE_MIN_MM = 600.0  # the scene cut (src/HighLevelLinemodIcp.cpp:109)
# verify renders a window of this size centred on the group's bbox, not the
# whole frame: a pose's pixels land near its projection, and one so wrong
# that it renders outside the window is a cm-level reject either way
VERIFY_WINDOW = 384


def _sum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 sum over `dim`, accumulated in float64."""
    return x.double().sum(dim).float()


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v for [..., 3, 3] x [..., 3], each row as dot3."""
    return dot3(a, v[..., None, :])


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [..., 3, 3] matrices, each entry as dot3."""
    return dot3(a[..., :, None, :], b.transpose(-1, -2)[..., None, :, :])


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential of rotation vectors w [P, 3] -> [P, 3, 3]."""
    th = sqrt32(dot3(w, w)) + 1e-12
    k = w / th[:, None]
    z = torch.zeros_like(th)
    kx = torch.stack([
        torch.stack([z, -k[:, 2], k[:, 1]], -1),
        torch.stack([k[:, 2], z, -k[:, 0]], -1),
        torch.stack([-k[:, 1], k[:, 0], z], -1),
    ], 1)
    sin = th.double().sin().float()[:, None, None]
    one_cos = (1.0 - th.double().cos().float())[:, None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sin * kx + one_cos * _matmul3(kx, kx)


def _pair_dot(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """m . s for every model point m [P, M, 3] and scene point s [S, 3] ->
    [P, M, S], each later product fused into the running sum as dot3 fuses
    it (never a matmul). The float64 product is exact and the float64 sum
    rounds once more before float32: a fused multiply-add but in the rare
    case where that second rounding lands on a float32 midpoint."""
    md, sd = m.double(), s.double()
    acc = (m[..., 0, None] * s[:, 0]).double()
    acc = acc.addcmul_(md[..., 1, None], sd[:, 1]).float().double()
    return acc.addcmul_(md[..., 2, None], sd[:, 2]).float()


def _nearest(m: torch.Tensor, scene_pts, s2, scene_valid):
    """(squared distance, index) of each model point's nearest valid scene
    point, the first on ties: |m|^2 + |s|^2 - 2 m.s over the whole [P, M, S]
    matrix, in blocks of model rows on the CPU (where a block that stays in
    cache is faster), at once on a GPU."""
    rows = m.shape[1] if m.is_cuda else 256
    out = []
    for i in range(0, m.shape[1], rows):
        mb = m[:, i : i + rows]
        d2 = dot3(mb, mb)[..., None] + s2 - 2.0 * _pair_dot(mb, scene_pts)
        out.append(torch.where(scene_valid, d2, 1e12).min(dim=2))
    return torch.cat([v for v, _ in out], 1), torch.cat([j for _, j in out], 1)


def icp_refine_batch(
    model_pts: torch.Tensor,  # [M, 3]
    scene_pts: torch.Tensor,  # [S, 3]
    scene_nrm: torch.Tensor,  # [S, 3]
    scene_valid: torch.Tensor,  # [S] bool
    rots: torch.Tensor,  # [P, 3, 3] initial rotations
    trans: torch.Tensor,  # [P, 3] initial translations
    iterations: int = ITERATIONS,
    model_nrm: torch.Tensor | None = None,  # [M, 3]: enables back-face culling
    tolerance: float = 0.0,
    rejection_scale: float = REJECTION_SCALE,
):
    """Point-to-plane ICP of P poses against one scene cloud, on the
    inputs' device. Returns (rots [P, 3, 3], trans [P, 3], rmse [P]).

    Once the residual's change between two iterations falls below
    tolerance x the residual, the pose freezes (the reference's TolP break);
    with model normals, back-facing model points and correspondences whose
    normals disagree are dropped, so the model's hidden half does not drag
    the fit off the visible surface."""
    n_model = model_pts.shape[0]
    inv_m = float(np.float32(1.0) / np.float32(n_model))
    s2 = dot3(scene_pts, scene_pts)
    eye6 = 1e-4 * torch.eye(6, dtype=torch.float64, device=rots.device)
    r, t = rots, trans
    prev = torch.full((rots.shape[0],), torch.inf, dtype=torch.float32, device=rots.device)
    done = torch.zeros(rots.shape[0], dtype=torch.bool, device=rots.device)
    rmse = prev
    for _ in range(iterations):
        m = dot3(model_pts[None, :, None, :], r[:, None, :, :]) + t[:, None, :]  # [P, M, 3]
        d2min, j = _nearest(m, scene_pts, s2, scene_valid)
        d = sqrt32(d2min.clamp(min=0.0))
        keep = d < rejection_scale * (_sum64(d, 1) * inv_m)[:, None]
        s = scene_pts[j]
        n = scene_nrm[j]
        if model_nrm is not None:
            mn = dot3(model_nrm[None, :, None, :], r[:, None, :, :])
            keep = keep & (dot3(mn, m) < 0.0) & (dot3(mn, n) > 0.0)  # facing, compatible
        e = dot3(n, m - s)  # the point-to-plane residual
        w = keep.float()
        w_sum = _sum64(w, 1).clamp(min=1.0)
        # rotation about the kept points' centroid: lever arms of the
        # object's radius, not of |t|, keep the 6x6 system well conditioned
        cen = _sum64(m * w[..., None], 1) / w_sum[:, None]
        a = torch.cat([_cross(m - cen[:, None, :], n), n], dim=-1).double()  # [P, M, 6]
        aw = a * w.double()[..., None]
        ata = (aw[..., :, None] * a[..., None, :]).sum(1) + eye6
        atb = (aw * (-e).double()[..., None]).sum(1)
        x = torch.linalg.solve_ex(ata, atb)[0].float()
        dr = _exp_so3(x[:, :3])
        rmse = sqrt32(_sum64(w * e * e, 1) / w_sum)
        converged = (prev - rmse).abs() < tolerance * prev.clamp(min=1e-9)
        r = torch.where(done[:, None, None], r, _matmul3(dr, r))
        t = torch.where(done[:, None], t, _matvec(dr, t - cen) + cen + x[:, 3:])
        prev, done = rmse, done | converged
    return r, t, rmse


def verify_mean_depth_diff(depth_scene: torch.Tensor, depth_render: torch.Tensor) -> torch.Tensor:
    """Verify-by-render score (estimateBestMatch,
    src/HighLevelLinemodIcp.cpp:93-127): mean |scene - render| over the
    twice-eroded mask of rendered pixels whose scene depth is above 600 mm.

    The erosion is a 3x3 min that ignores pixels outside the image. An
    empty eroded mask scores 0.0, which passes the gate: the reference's
    count is clamped to 1, and the port keeps that."""
    m = erode_mask((depth_render > 0) & (depth_scene > VERIFY_SCENE_MIN_MM), 2)
    diff = (depth_scene - depth_render).abs()
    cnt = m.sum().clamp(min=1)
    return (torch.where(m, diff, 0.0).double().sum() / cnt).float()


def _pose_arrays(poses: list, pad_to: int):
    """(rotations [pad_to, 3, 3], translations [pad_to, 3]) float32 of the
    poses, the last repeated to pad_to."""
    padded = list(poses) + [poses[-1]] * (pad_to - len(poses))
    rots = np.stack([quat_to_mat(p.quaternion) for p in padded]).astype(np.float32)
    trans = np.stack([np.asarray(p.translation) for p in padded]).astype(np.float32)
    return rots, trans


def _pow2(n: int) -> int:
    """Pose and group batches are padded to powers of two, the last item
    repeated (the reference's compile buckets; the padding is sliced away)."""
    return 1 << (n - 1).bit_length()


class IcpRefiner:
    """The pipeline's ICP stage: the model cloud (every sample_step-th
    vertex, the last repeated to a multiple of 512) and the mesh's render
    buffers on one device.

    iterations, tolerance and rejection_scale are the reference ICP's
    (src/PoseDetection.cpp:10-11 passes 6 x 8 levels, 0.1 and 2.5; the flat
    16-iteration loop with tolerance 0.01 stands in for them, as in the
    JAX package). `mesh_arrays` (rasterizer.mesh_to_arrays) fixes the
    device; without it verify cannot render, and `device` must be given."""

    def __init__(
        self,
        mesh,
        cam,
        sample_step: int = 2,
        mesh_arrays: MeshArrays | None = None,
        iterations: int = ITERATIONS,
        tolerance: float = 0.01,
        rejection_scale: float = REJECTION_SCALE,
        device=None,
    ):
        if mesh_arrays is None and device is None:
            raise ValueError("IcpRefiner needs mesh_arrays or a device")
        self.device = mesh_arrays.vertices.device if mesh_arrays is not None else torch.device(device)
        self.iterations = int(iterations)
        self.tolerance = float(tolerance)
        self.rejection_scale = float(rejection_scale)
        pts = np.asarray(mesh.vertices, np.float32)[::sample_step]
        pad = int(np.ceil(pts.shape[0] / 512)) * 512 - pts.shape[0]

        def padded(a):
            return torch.from_numpy(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])).to(self.device)

        self.model_pts = padded(pts)
        self.model_nrm = None
        if mesh.normals is not None:
            self.model_nrm = padded(np.asarray(mesh.normals, np.float32)[::sample_step])
        self.cam = cam
        self.marr = mesh_arrays

    def _depth(self, depth: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(depth, dtype=np.float32)).to(self.device)

    def _refine_tensors(self, depth_t: torch.Tensor, bbox, rots, trans):
        cam = self.cam
        spts, snrm, svalid = scene_cloud_from_depth(
            depth_t, bbox, fx=cam.fx, fy=cam.fy, cx=cam.width / 2.0, cy=cam.height / 2.0
        )
        return icp_refine_batch(
            self.model_pts, spts, snrm, svalid,
            torch.from_numpy(rots).to(self.device), torch.from_numpy(trans).to(self.device),
            iterations=self.iterations, model_nrm=self.model_nrm,
            tolerance=self.tolerance, rejection_scale=self.rejection_scale,
        )[:2]

    def refine(self, depth: np.ndarray, poses: list) -> list:
        """Refine a group's candidate poses together against the scene cloud
        of the first pose's bbox (src/PoseDetection.cpp:75-77). depth: [H, W]
        recentred, mm. Returns one ObjectPose a pose, in order."""
        rots, trans = _pose_arrays(poses, _pow2(len(poses)))
        r, t = self._refine_tensors(self._depth(depth), poses[0].bounding_box, rots, trans)
        r, t = r.cpu().numpy(), t.cpu().numpy()
        return [
            ObjectPose(translation=t[i].astype(np.float64), quaternion=mat_to_quat(r[i]),
                       bounding_box=poses[i].bounding_box)
            for i in range(len(poses))
        ]

    def _verify(self, r, t, scene: torch.Tensor, origin, size) -> torch.Tensor:
        """Verify means [P] of poses (r [P, 3, 3], t [P, 3]) rendered into a
        window of `size` (w, h) at `origin` against `scene`, its crop."""
        cam = self.cam
        return torch.stack([
            verify_mean_depth_diff(scene, render(
                self.marr, r[i], t[i], cam.fx, cam.fy, cam.width / 2.0, cam.height / 2.0,
                width=size[0], height=size[1], origin=origin,
            ))
            for i in range(r.shape[0])
        ])

    def verify_window(self, padded_scene: torch.Tensor, bbox) -> tuple:
        """(crop, origin (x, y)) of the VERIFY_WINDOW square centred on
        `bbox` and kept inside the frame, from the scene depth padded by the
        window on its right and bottom (refine_submit's verify window)."""
        w, h = self.cam.width, self.cam.height
        vw = min(VERIFY_WINDOW, w, h)
        ox = min(max(bbox[0] + bbox[2] // 2 - vw // 2, 0), w - vw)
        oy = min(max(bbox[1] + bbox[3] // 2 - vw // 2, 0), h - vw)
        return padded_scene[oy : oy + vw, ox : ox + vw], (ox, oy)

    def refine_submit(self, depth: np.ndarray, groups: list):
        """Refine and verify all of a frame's groups (lists of poses, none
        empty); returns the handle for refine_collect: packed [G, P, 13]
        (rotation 9, translation 3, verify mean 1) on the device and the
        groups. Each group's poses are refined against its own scene cloud
        and rendered into a VERIFY_WINDOW crop centred on its bbox.

        The renders wait for the device (each reads its blocks' ranges on
        the host), so this returns when the last render is enqueued, not at
        once. Groups and poses are padded to powers of two as the reference
        pads them (the padding is sliced away). Without mesh arrays verify
        cannot run: refine_collect then refines each group and takes its
        first pose."""
        if not groups:
            return None
        if self.marr is None:
            return ("refine_only", depth, groups)
        vw = min(VERIFY_WINDOW, self.cam.width, self.cam.height)
        depth_t = self._depth(depth)
        padded_scene = F.pad(depth_t, (0, vw, 0, vw))
        p_pad = _pow2(max(len(g) for g in groups))
        out = []
        for g in list(groups) + [groups[-1]] * (_pow2(len(groups)) - len(groups)):
            bbox = tuple(int(v) for v in g[0].bounding_box)
            r, t = self._refine_tensors(depth_t, bbox, *_pose_arrays(g, p_pad))
            crop, origin = self.verify_window(padded_scene, bbox)
            means = self._verify(r, t, crop, origin, (vw, vw))
            out.append(torch.cat([r.reshape(-1, 9), t, means[:, None]], dim=1))
        return torch.stack(out), groups

    def refine_collect(self, handle) -> list:
        """Copy a refine_submit handle's results to the host; one ObjectPose
        or None a submitted group: the group's best verified pose if its
        mean depth difference passes the 35 mm gate."""
        if handle is None:
            return []
        if len(handle) == 3:  # ("refine_only", depth, groups): no renderer
            _, depth, groups = handle
            return [self.refine(depth, g)[0] for g in groups]
        packed, groups = handle
        packed = packed.cpu().numpy()
        out = []
        for i, g in enumerate(groups):
            pg = packed[i, : len(g)]
            best = int(np.argmin(pg[:, 12]))
            if pg[best, 12] > VERIFY_ACCEPT_MM:
                out.append(None)
                continue
            out.append(ObjectPose(
                translation=pg[best, 9:12].astype(np.float64),
                quaternion=mat_to_quat(pg[best, :9].reshape(3, 3)),
                bounding_box=g[best].bounding_box,
            ))
        return out

    def refine_best_many(self, depth: np.ndarray, groups: list) -> list:
        """refine_submit + refine_collect: one best verified pose (or None) a
        group."""
        return self.refine_collect(self.refine_submit(depth, groups))

    def refine_best(self, depth: np.ndarray, poses: list):
        """Refine and verify one group: its best verified pose, or None
        (without mesh arrays, the first refined pose)."""
        if not poses:
            return None
        if self.marr is None:
            return self.refine(depth, poses)[0]
        return self.refine_best_many(depth, [poses])[0]

    def best_verified(self, depth: np.ndarray, poses: list):
        """Render each pose over the whole frame and accept the best if its
        mean |delta depth| is at most 35 mm (without mesh arrays: the first
        pose). Poses are padded to a power of two; the padding repeats the
        last pose, which can only tie, and the first minimum wins."""
        if not poses or self.marr is None:
            return poses[0] if poses else None
        n = len(poses)
        rots, trans = _pose_arrays(poses, _pow2(n))
        cam = self.cam
        means = self._verify(
            torch.from_numpy(rots).to(self.device), torch.from_numpy(trans).to(self.device),
            self._depth(depth), (0, 0), (cam.width, cam.height),
        ).cpu().numpy()[:n]
        best = int(np.argmin(means))
        return poses[best] if means[best] <= VERIFY_ACCEPT_MM else None
