"""Match post-processing: grouping, color/depth validation, pose reconstruction.

Reproduces HighLevelLineMOD's detect-time chain (src/HighLevelLinemod.cpp):

- `group_matches`: 2-D clustering of matches within `group_radius` px of the
  group founder (groupSimilarMatches :206-229);
- `discard_small_groups`: drop groups whose integer percentage of the biggest
  group is <= discard ratio (discardSmallMatchGroups :232-253, including the
  C++ integer division);
- `color_check_host`: fraction of pixels inside the template's feature convex
  hull whose HSV falls in the model's range (colorCheck :424-434,
  templateMask :113-135);
- `depth_p20_host`: scene-vs-template ~p20 depth gate input, with the
  shiny-object z-correction applied by the caller (depthCheck :437-457);
- `reconstruct_pose`: pixel->metric translation with the reference's
  calcTrueZ quirk (mm^2 minus px^2, :512-515) and view-ray rotation
  adjustment (calcRotation :488-495).

Everything here runs host-side in numpy: grouping is tiny, and the image
checks are evaluated lazily per grouped candidate (the reference's own
post-grouping order), touching only each candidate's bbox window. Keeping
the checks off the device keeps the per-frame device program match-only, so
in color-only mode the depth image never goes to the device.

The port's own copy of `linemod_tpu/ops/postprocess.py`, unchanged in
behaviour (tests/test_torch_e2e_fixture.py holds the poses equal).
"""

from __future__ import annotations

import numpy as np

from ..types import ObjectPose
from ..utils.geometry import mat_to_quat, quat_to_mat, view_ray_rotation

BG_DEPTH = 65535.0


def group_matches(xs, ys, radius: float):
    """Greedy founder-based grouping; returns list of index lists.

    Matches must already be similarity-sorted (they are, coming from
    match_templates). Each match joins the FIRST group (creation order)
    whose founder lies within `radius` — identical semantics to the
    reference's nested loop (groupSimilarMatches,
    src/HighLevelLinemod.cpp:206-229), but the founder-distance row is one
    vectorized numpy op instead of a Python inner loop (the grouping is on
    the per-frame host path; at 512 matches the pure-Python version costs
    milliseconds on a 2-core host)."""
    n = len(xs)
    founders = np.empty((n, 2), np.float64)
    n_groups = 0
    groups: list[list[int]] = []
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


def discard_small_groups(groups, ratio: float):
    if not groups:
        return groups
    biggest = max(len(g) for g in groups)
    # C++ size_t arithmetic: integer percentage, strict > (src:246-247)
    return [g for g in groups if (len(g) * 100 // biggest) > ratio]


def bgr_to_hsv_inrange_np(img: np.ndarray, lower, upper) -> np.ndarray:
    """OpenCV-convention BGR->HSV (H in 0..180) + inRange mask (numpy).

    img: [.., 3] BGR 0..255. lower/upper: [3] (H, S, V). The checks run
    host-side, lazily per grouped candidate (exactly the reference's
    post-grouping order, src/HighLevelLinemod.cpp:382-421): this keeps the
    per-frame device program match-only, so depth never has to cross the
    host->device link in color-only mode.
    """
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
    h = np.where(h < 0, h + 360.0, h) * 0.5  # OpenCV: H/2 for uint8
    lower = np.asarray(lower, np.float32)
    upper = np.asarray(upper, np.float32)
    hsv = np.stack([h, s, v], axis=-1)
    return np.all((hsv >= lower) & (hsv <= upper), axis=-1)


def hull_mask(hull: np.ndarray, wh) -> np.ndarray:
    """Rasterize a convex hull ([HV, 2] bbox-relative CCW, possibly padded by
    repeated vertices) to a [h, w] bool mask (templateMask,
    src/HighLevelLinemod.cpp:113-135). xy-independent — callers cache it per
    template."""
    w, h = int(wh[0]), int(wh[1])
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    v0 = hull.astype(np.float32)
    v1 = np.roll(v0, -1, axis=0)
    e = v1 - v0
    keep = ~((e[:, 0] == 0.0) & (e[:, 1] == 0.0))  # drop padded repeat-vertices
    inside = np.ones((h, w), bool)
    for ex, ey, vx, vy in zip(e[keep, 0], e[keep, 1], v0[keep, 0], v0[keep, 1]):
        inside &= ex * (yy - vy) - ey * (xx - vx) >= 0.0
    return inside


def color_check_host(
    color: np.ndarray,  # [H, W, 3] BGR (recentred frame)
    mask: np.ndarray,  # [h, w] bool hull-interior mask (hull_mask output)
    xy,  # (x, y) match position (bbox top-left)
    lower,
    upper,
) -> float:
    """Percentage of hull-interior pixels that are HSV-in-range (colorCheck,
    src/HighLevelLinemod.cpp:424-434)."""
    x, y = int(xy[0]), int(xy[1])
    h, w = mask.shape
    win = color[y : y + h, x : x + w]
    if win.size == 0:
        return 0.0
    mask = mask[: win.shape[0], : win.shape[1]]
    denom = max(int(mask.sum()), 1)
    inrange = bgr_to_hsv_inrange_np(win[mask], lower, upper)
    return float(inrange.sum()) * 100.0 / denom


def depth_p20_host(depth: np.ndarray, xy, wh) -> float:
    """~p20 of scene depth over the candidate's bbox, background as 65535
    (medianMat semantics, src/HighLevelLinemod.cpp:336-349; same convention
    as the bank's per-template median, models/template_bank.py)."""
    x, y = int(xy[0]), int(xy[1])
    w, h = int(wh[0]), int(wh[1])
    win = depth[y : y + h, x : x + w]
    if win.size == 0:
        return BG_DEPTH
    vals = np.where(win > 0, win, BG_DEPTH).astype(np.float32).ravel()
    k = len(vals) // 5
    return float(np.partition(vals, k)[k])


def reconstruct_pose(
    match_x: float,
    match_y: float,
    bbox: np.ndarray,  # template bbox (x, y, w, h) at level 0
    template_quat: np.ndarray,
    direct_depth: float,
    cam,
) -> ObjectPose:
    """Closed-form translation + view-ray rotation (src/HighLevelLinemod.cpp:459-515)."""
    w2 = cam.width / 2.0
    h2 = cam.height / 2.0
    pixel_x = match_x + w2 - bbox[0]
    pixel_y = match_y + h2 - bbox[1]
    off = np.hypot(pixel_x - w2, pixel_y - h2)
    # calcTrueZ: the reference subtracts a squared *pixel* distance from a
    # squared mm distance (:512-515) — reproduced for behavioral parity.
    z = float(np.sqrt(max(direct_depth * direct_depth - off * off, 1.0)))
    mm_per_px = z / cam.fy
    x = (pixel_x - w2) * mm_per_px
    y = (pixel_y - h2) * mm_per_px
    adjust = view_ray_rotation([x, y, z])
    rot = adjust @ quat_to_mat(template_quat)
    return ObjectPose(
        translation=np.array([x, y, z], np.float64),
        quaternion=mat_to_quat(rot),
        bounding_box=(int(match_x), int(match_y), int(bbox[2]), int(bbox[3])),
    )
