"""Pose math on the host (numpy): quaternions, template poses and the
view-ray rotation.

The port's own copy of the parts of `linemod_tpu/utils/geometry.py` that
template generation, detection and scoring use. Conventions follow GLM, as
the reference's template poses do: `look_at` is glm::lookAt (right-handed,
the camera looks down -z in its own frame), the GL camera frame becomes the
CV frame by left-multiplication with diag(1, -1, -1), and quaternions are
(w, x, y, z), normalized.
"""

from __future__ import annotations

import numpy as np

GL_TO_CV = np.diag([1.0, -1.0, -1.0]).astype(np.float64)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAt rotation+translation as a 4x4 (row-major math convention)."""
    eye = np.asarray(eye, dtype=np.float64)
    f = normalize(np.asarray(center, dtype=np.float64) - eye)
    s = normalize(np.cross(f, np.asarray(up, dtype=np.float64)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def rotation_about_axis(axis, angle_rad: float) -> np.ndarray:
    """Rodrigues rotation matrix about a (normalized) axis."""
    x, y, z = normalize(axis)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        dtype=np.float64,
    )


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    m = np.asarray(m, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (m[2, 1] - m[1, 2]) * s
        y = (m[0, 2] - m[2, 0]) * s
        z = (m[1, 0] - m[0, 1]) * s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return q / np.linalg.norm(q)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float64,
    )


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float64,
    )


def camera_up_on_sphere(cam_pos: np.ndarray, world_up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """The negated camera-up vector of the reference's template pose: for a
    camera at `cam_pos` looking at the origin, camUp = normalize(cross(p,
    cross(p, up))), and lookAt is given -camUp (world-up projected onto the
    plane perpendicular to the view ray). A camera on the y axis is nudged
    by 1e-11 in x, as in the reference."""
    p = np.asarray(cam_pos, dtype=np.float64).copy()
    if p[0] == 0.0 and p[2] == 0.0:
        p[0] = 1e-11
    cam_up = normalize(np.cross(p, np.cross(p, np.asarray(world_up, dtype=np.float64))))
    return -cam_up


def template_view_pose(cam_pos, inplane_deg: float) -> np.ndarray:
    """CV-frame rotation quaternion of a template viewpoint: the up-vector
    -camUp rotated by the in-plane angle about the view ray, view =
    lookAt(cam_pos, 0, rotated up), then the GL -> CV change of frame. The
    template's translation is (0, 0, |cam_pos|)."""
    p = np.asarray(cam_pos, dtype=np.float64).copy()
    if p[0] == 0.0 and p[2] == 0.0:
        p[0] = 1e-11
    neg_cam_up = camera_up_on_sphere(p)
    rot = rotation_about_axis(p, np.radians(float(inplane_deg)))
    rotated_up = rot @ neg_cam_up
    view = look_at(p, np.zeros(3), rotated_up)
    return mat_to_quat(GL_TO_CV @ view[:3, :3])


def view_ray_rotation(position: np.ndarray) -> np.ndarray:
    """View-ray rotation adjustment of the reference's `calcRotation`: the
    3x3 matrix lookAt((-x, -y, z), 0, (0,1,0)) that re-aims the template
    rotation along the detection's actual view ray."""
    x, y, z = np.asarray(position, dtype=np.float64)
    eye = np.array([-x, -y, z], dtype=np.float64)
    if eye[0] == 0.0 and eye[2] == 0.0:
        eye[0] = 1e-11
    return look_at(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))[:3, :3]
