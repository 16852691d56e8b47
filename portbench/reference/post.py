"""The plain reference of a frame's host stage: the packed candidates ->
the frame's poses.

A frozen copy of the port's numpy post-processing, which follows
HighLevelLineMOD (src/HighLevelLinemod.cpp): founder-based grouping within
the group radius, the small-group cut (integer percentage, strict >), the
lazy per-candidate color check (HSV in range over the template's hull) and
depth check (the scene's ~p20 depth over the bbox, less the template's and
the depth offset, within one distance step), and the closed-form pose
(calcTrueZ's mm^2 - px^2, the view-ray rotation). One pose a group, the
first that passes both checks; the first `num_objects` groups.

Imports only numpy.
"""

from __future__ import annotations

import numpy as np

BG_DEPTH = 65535.0


def recenter(img: np.ndarray, cam: dict) -> np.ndarray:
    """Shift the principal point to the image centre: an integer shift,
    zero fill."""
    dx = int(round(-cam["cx"] + cam["width"] / 2))
    dy = int(round(-cam["cy"] + cam["height"] / 2))
    if dx == 0 and dy == 0:
        return img
    out = np.zeros_like(img)
    h, w = img.shape[:2]
    out[max(0, dy) : h + min(0, dy), max(0, dx) : w + min(0, dx)] = \
        img[max(0, -dy) : h + min(0, -dy), max(0, -dx) : w + min(0, -dx)]
    return out


def group_matches(xs, ys, radius: float) -> list:
    n = len(xs)
    founders = np.empty((n, 2), np.float64)
    n_groups = 0
    groups: list = []
    r2 = radius * radius
    for i in range(n):
        if n_groups:
            dx = founders[:n_groups, 0] - xs[i]
            dy = founders[:n_groups, 1] - ys[i]
            hits = np.flatnonzero(dx * dx + dy * dy < r2)
            if hits.size:
                groups[hits[0]].append(i)
                continue
        founders[n_groups] = (xs[i], ys[i])
        n_groups += 1
        groups.append([i])
    return groups


def discard_small_groups(groups: list, ratio: float) -> list:
    if not groups:
        return groups
    biggest = max(len(g) for g in groups)
    return [g for g in groups if (len(g) * 100 // biggest) > ratio]


def _hsv_in_range(img: np.ndarray, lower, upper) -> np.ndarray:
    """OpenCV-convention BGR -> HSV (H in 0..180), then inRange."""
    img = img.astype(np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    mn = np.minimum(np.minimum(b, g), r)
    diff = v - mn
    s = np.where(v > 0, diff * 255.0 / np.maximum(v, 1e-6), 0.0)
    safe = np.maximum(diff, 1e-6)
    h = np.where(
        v == r,
        60.0 * (g - b) / safe,
        np.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = np.where(h < 0, h + 360.0, h) * 0.5
    hsv = np.stack([h, s, v], axis=-1)
    return np.all((hsv >= np.asarray(lower, np.float32)) & (hsv <= np.asarray(upper, np.float32)), axis=-1)


def hull_mask(hull: np.ndarray, wh) -> np.ndarray:
    """The convex hull (bbox-relative, CCW, padded by repeated vertices)
    rasterized to a [h, w] bool mask."""
    w, h = int(wh[0]), int(wh[1])
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    v0 = hull.astype(np.float32)
    e = np.roll(v0, -1, axis=0) - v0
    keep = ~((e[:, 0] == 0.0) & (e[:, 1] == 0.0))
    inside = np.ones((h, w), bool)
    for ex, ey, vx, vy in zip(e[keep, 0], e[keep, 1], v0[keep, 0], v0[keep, 1]):
        inside &= ex * (yy - vy) - ey * (xx - vx) >= 0.0
    return inside


def color_percent(color: np.ndarray, mask: np.ndarray, xy, lower, upper) -> float:
    x, y = int(xy[0]), int(xy[1])
    h, w = mask.shape
    win = color[y : y + h, x : x + w]
    if win.size == 0:
        return 0.0
    mask = mask[: win.shape[0], : win.shape[1]]
    denom = max(int(mask.sum()), 1)
    return float(_hsv_in_range(win[mask], lower, upper).sum()) * 100.0 / denom


def depth_p20(depth: np.ndarray, xy, wh) -> float:
    x, y = int(xy[0]), int(xy[1])
    w, h = int(wh[0]), int(wh[1])
    win = depth[y : y + h, x : x + w]
    if win.size == 0:
        return BG_DEPTH
    vals = np.where(win > 0, win, BG_DEPTH).astype(np.float32).ravel()
    k = len(vals) // 5
    return float(np.partition(vals, k)[k])


def _normalize(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def _look_at_rotation(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, dtype=np.float64)
    f = _normalize(np.asarray(center, dtype=np.float64) - eye)
    s = _normalize(np.cross(f, np.asarray(up, dtype=np.float64)))
    u = np.cross(s, f)
    m = np.eye(3, dtype=np.float64)
    m[0], m[1], m[2] = s, u, -f
    return m


def quat_to_mat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=np.float64)


def mat_to_quat(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w, x, y, z = 0.25 / s, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        w, x, y, z = (m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        w, x, y, z = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        w, x, y, z = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return q / np.linalg.norm(q)


def pose(match_x: float, match_y: float, bbox, quat, direct_depth: float, cam: dict):
    """(translation [3], quaternion [4] (w, x, y, z), bbox (x, y, w, h)) in
    the CV camera frame, mm."""
    w2, h2 = cam["width"] / 2.0, cam["height"] / 2.0
    pixel_x = match_x + w2 - bbox[0]
    pixel_y = match_y + h2 - bbox[1]
    off = np.hypot(pixel_x - w2, pixel_y - h2)
    z = float(np.sqrt(max(direct_depth * direct_depth - off * off, 1.0)))
    mm_per_px = z / cam["fy"]
    x = (pixel_x - w2) * mm_per_px
    y = (pixel_y - h2) * mm_per_px
    eye = np.array([-x, -y, z], dtype=np.float64)
    if eye[0] == 0.0 and eye[2] == 0.0:
        eye[0] = 1e-11
    rot = _look_at_rotation(eye, np.zeros(3), np.array([0.0, 1.0, 0.0])) @ quat_to_mat(quat)
    return (np.array([x, y, z], np.float64), mat_to_quat(rot),
            (int(match_x), int(match_y), int(bbox[2]), int(bbox[3])))


def frame_poses(packed: np.ndarray, bank: dict, settings: dict, model: dict, cam: dict,
                color: np.ndarray, depth: np.ndarray, num_objects: int, hull_cache: dict) -> list:
    """The frame's poses from its packed candidates (valid rows only)."""
    valid = packed[:, 4] > 0.5
    tid = packed[valid, 0].astype(np.int64)
    xs, ys = packed[valid, 1], packed[valid, 2]
    if len(tid) == 0:
        return []
    groups = discard_small_groups(group_matches(xs, ys, settings["group_radius"]),
                                  settings["discard_group_ratio"])
    lower = np.asarray(model["lower_color_range"], np.float32)
    upper = np.asarray(model["upper_color_range"], np.float32)
    out = []
    for g in groups:
        found = []
        for j in g:
            t = int(tid[j])
            xy = (xs[j], ys[j])
            wh = bank["bbox"][t, 2:4]
            mask = hull_cache.get(t)
            if mask is None:
                mask = hull_cache[t] = hull_mask(bank["hull"][t], wh)
            ok_color = color_percent(color, mask, xy, lower, upper) > settings["percent_to_pass_check"]
            if settings["use_depth_improvement"]:
                diff = depth_p20(depth, xy, wh) - float(bank["median_depth"][t]) - settings["depth_offset"]
                ok_depth = abs(diff) < settings["distance_step"]
                direct = float(bank["z"][t]) + diff
            else:
                ok_depth = True
                direct = float(bank["z"][t])
            if ok_color and ok_depth:
                found.append(pose(float(xs[j]), float(ys[j]), bank["bbox"][t], bank["quat"][t], direct, cam))
            if len(found) >= settings["number_wanted_poses"]:
                break
        if found:
            out.append(found[0])
        if len(out) == num_objects:
            break
    return out
