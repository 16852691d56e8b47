"""Camera pose from point correspondences, in float64 numpy (the port's
counterparts of `cv2.Rodrigues`, `cv2.projectPoints` and
`cv2.solvePnP(..., flags=SOLVEPNP_ITERATIVE)`).

The camera is a pinhole matrix K with OpenCV's five distortion
coefficients (k1, k2, p1, p2, k3). `solve_pnp` starts, as OpenCV's
iterative solver does, from a homography for a planar object (a DLT for
any other) on the undistorted points, then minimizes the reprojection
error in pixels by Levenberg-Marquardt until the step vanishes, so it
lands on the optimum that OpenCV's iteration approaches.
"""

from __future__ import annotations

import numpy as np


def rodrigues(v) -> np.ndarray:
    """cv2.Rodrigues: a rotation vector (3,) -> its 3x3 matrix, or a 3x3
    rotation -> its vector (3,)."""
    v = np.asarray(v, np.float64)
    if v.size == 3:
        r = v.reshape(3)
        theta = float(np.sqrt(r @ r))
        if theta < np.finfo(np.float64).eps:
            return np.eye(3)
        c, s = np.cos(theta), np.sin(theta)
        r = r * (1.0 / theta)
        rx = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
        return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * rx
    u, _, vt = np.linalg.svd(v.reshape(3, 3))
    m = u @ vt
    r = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((m[0, 0] + m[1, 1] + m[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        r = np.array([
            np.sqrt(max((m[0, 0] + 1) * 0.5, 0.0)),
            np.sqrt(max((m[1, 1] + 1) * 0.5, 0.0)) * (-1.0 if m[0, 1] < 0 else 1.0),
            np.sqrt(max((m[2, 2] + 1) * 0.5, 0.0)) * (-1.0 if m[0, 2] < 0 else 1.0)])
        if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (m[1, 2] > 0) != (r[1] * r[2] > 0):
            r[2] = -r[2]
        return r * (theta / np.sqrt(r @ r))
    return r * (theta / (2.0 * s))


def _rotation_vector(rot: np.ndarray) -> np.ndarray:
    """The rotation vector of a rotation matrix, accurate at every angle:
    `rodrigues` (as cv2.Rodrigues) returns 0 below 1e-5 rad, where this
    takes the skew part, exact to the angle's cube."""
    r = 0.5 * np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]])
    if np.sqrt(r @ r) < 1e-5 and np.trace(rot) > 0:
        return r
    return rodrigues(rot)


def _distortion(dist) -> np.ndarray:
    d = np.zeros(5)
    if dist is not None:
        flat = np.asarray(dist, np.float64).ravel()
        d[: len(flat)] = flat[:5]
    return d


def _distort(x: np.ndarray, y: np.ndarray, d: np.ndarray) -> tuple:
    """Normalized points -> distorted normalized points, and the 2x2
    Jacobian of that map at each point."""
    k1, k2, p1, p2, k3 = d
    r2 = x * x + y * y
    cd = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * cd + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * cd + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    dcd = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d cd / d r2
    jac = np.empty(x.shape + (2, 2))
    jac[..., 0, 0] = cd + 2.0 * x * x * dcd + 2.0 * p1 * y + 6.0 * p2 * x
    jac[..., 0, 1] = 2.0 * x * y * dcd + 2.0 * p1 * x + 2.0 * p2 * y
    jac[..., 1, 0] = 2.0 * x * y * dcd + 2.0 * p1 * x + 2.0 * p2 * y
    jac[..., 1, 1] = cd + 2.0 * y * y * dcd + 6.0 * p1 * y + 2.0 * p2 * x
    return xd, yd, jac


def project_points(obj, rvec, tvec, camera, dist=None) -> np.ndarray:
    """cv2.projectPoints: object points [N, 3] -> pixels [N, 2]."""
    pts = np.asarray(obj, np.float64).reshape(-1, 3)
    rot = rodrigues(rvec)
    pc = pts @ rot.T + np.asarray(tvec, np.float64).reshape(3)
    iz = np.where(pc[:, 2] != 0, 1.0 / np.where(pc[:, 2] != 0, pc[:, 2], 1.0), 1.0)
    xd, yd, _ = _distort(pc[:, 0] * iz, pc[:, 1] * iz, _distortion(dist))
    k = np.asarray(camera, np.float64)
    return np.stack([k[0, 0] * xd + k[0, 2], k[1, 1] * yd + k[1, 2]], axis=1)


def undistort_points(img, camera, dist=None) -> np.ndarray:
    """Pixels [N, 2] -> normalized undistorted points [N, 2] (the fixed-point
    iteration of cv2.undistortPoints, 20 rounds)."""
    k = np.asarray(camera, np.float64)
    d = _distortion(dist)
    p = np.asarray(img, np.float64).reshape(-1, 2)
    x0 = (p[:, 0] - k[0, 2]) / k[0, 0]
    y0 = (p[:, 1] - k[1, 2]) / k[1, 1]
    x, y = x0.copy(), y0.copy()
    k1, k2, p1, p2, k3 = d
    for _ in range(20):
        r2 = x * x + y * y
        icd = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) * icd, (y0 - dy) * icd
    return np.stack([x, y], axis=1)


def _initial_pose(obj: np.ndarray, norm: np.ndarray) -> tuple:
    """(R, t) from undistorted normalized points: a homography for a planar
    object (OpenCV's test: the smallest spread under 1e-3 of the middle),
    a DLT otherwise."""
    mean = obj.mean(axis=0)
    centered = obj - mean
    _, w, vt = np.linalg.svd(centered.T @ centered)
    if w[2] < w[1] * 1e-3:
        rplane = vt if np.linalg.det(vt) > 0 else -vt
        plane = centered @ rplane.T  # z ~ 0 in the plane's own frame
        a = []
        for (X, Y), (u, v) in zip(plane[:, :2], norm):
            a.append([X, Y, 1, 0, 0, 0, -u * X, -u * Y, -u])
            a.append([0, 0, 0, X, Y, 1, -v * X, -v * Y, -v])
        h = np.linalg.svd(np.array(a))[2][-1].reshape(3, 3)
        h /= np.sqrt(np.linalg.norm(h[:, 0]) * np.linalg.norm(h[:, 1]))
        if h[2, 2] < 0:
            h = -h
        r1, r2 = h[:, 0], h[:, 1]
        rot = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
        u, _, vt2 = np.linalg.svd(rot)
        rot = u @ vt2
        t = h[:, 2]
        # object frame -> plane frame -> camera
        return rot @ rplane, t - rot @ rplane @ mean
    a = []
    for (X, Y, Z), (u, v) in zip(obj, norm):
        a.append([X, Y, Z, 1, 0, 0, 0, 0, -u * X, -u * Y, -u * Z, -u])
        a.append([0, 0, 0, 0, X, Y, Z, 1, -v * X, -v * Y, -v * Z, -v])
    p = np.linalg.svd(np.array(a))[2][-1].reshape(3, 4)
    u, s, vt = np.linalg.svd(p[:, :3])
    scale = 1.0 / s.mean()
    rot = u @ vt
    t = p[:, 3] * scale
    if np.linalg.det(rot) < 0:
        rot, t = -rot, -t
    if (obj @ rot.T + t)[:, 2].mean() < 0:
        rot = np.diag([-1.0, -1.0, 1.0]) @ rot  # unreachable for a valid DLT
        t = -t
    return rot, t


def _residuals(obj, img, rot, t, k, d) -> tuple:
    """Reprojection residuals [2N] and their Jacobian [2N, 6] with respect to
    a left rotation increment and a translation increment."""
    pc = obj @ rot.T + t
    iz = 1.0 / pc[:, 2]
    x, y = pc[:, 0] * iz, pc[:, 1] * iz
    xd, yd, jd = _distort(x, y, d)
    res = np.stack([k[0, 0] * xd + k[0, 2] - img[:, 0], k[1, 1] * yd + k[1, 2] - img[:, 1]], axis=1)
    n = len(obj)
    dn = np.zeros((n, 2, 3))  # d(x, y) / d pc
    dn[:, 0, 0] = iz
    dn[:, 0, 2] = -x * iz
    dn[:, 1, 1] = iz
    dn[:, 1, 2] = -y * iz
    rp = pc - t  # R @ obj
    dpc = np.zeros((n, 3, 6))
    dpc[:, :, 0:3] = -np.stack([
        np.stack([np.zeros(n), -rp[:, 2], rp[:, 1]], 1),
        np.stack([rp[:, 2], np.zeros(n), -rp[:, 0]], 1),
        np.stack([-rp[:, 1], rp[:, 0], np.zeros(n)], 1)], 1)
    dpc[:, :, 3:6] = np.eye(3)
    jac = np.diag([k[0, 0], k[1, 1]])[None] @ jd @ dn @ dpc
    return res.reshape(-1), jac.reshape(-1, 6)


def solve_pnp(obj, img, camera, dist=None) -> tuple:
    """cv2.solvePnP(obj, img, camera, dist) (SOLVEPNP_ITERATIVE): the pose
    (rvec (3,), tvec (3,)) that minimizes the squared reprojection error in
    pixels, from at least 4 correspondences (obj [N, 3], img [N, 2])."""
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    img = np.asarray(img, np.float64).reshape(-1, 2)
    if len(obj) < 4 or len(obj) != len(img):
        raise ValueError(f"solve_pnp needs at least 4 matched points, got {len(obj)} and {len(img)}")
    k = np.asarray(camera, np.float64)
    d = _distortion(dist)
    rot, t = _initial_pose(obj, undistort_points(img, k, d))
    res, jac = _residuals(obj, img, rot, t, k, d)
    cost = res @ res
    lam = 1e-3
    for _ in range(200):
        a = jac.T @ jac
        g = jac.T @ res
        step = -np.linalg.solve(a + lam * np.diag(np.diag(a)), g)
        rot_new = rodrigues(step[:3]) @ rot
        t_new = t + step[3:]
        res_new, jac_new = _residuals(obj, img, rot_new, t_new, k, d)
        cost_new = res_new @ res_new
        if cost_new <= cost:
            rot, t, res, jac, cost = rot_new, t_new, res_new, jac_new, cost_new
            lam = max(lam * 0.1, 1e-12)
            if np.abs(step).max() < 1e-15 * max(1.0, np.abs(t).max()):
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return _rotation_vector(rot), t
