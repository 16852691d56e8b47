"""Ground-truth capture tooling (counterpart of
`linemod_tpu/pipeline/aruco_capture.py`, which replaces the reference's
`Arcuo_Benchmark`, src/Aruco.cpp).

Same board: 5x7 GridBoard, DICT_6X6_100, 120 px markers / 20 px separation
(include/Aruco.h:40-46); the detected board pose is converted to the
pipeline frame with the reference's hand-measured scale (0.283 px->mm) and
board-centre offset (96, 136, 0) mm and axis flips (src/Aruco.cpp:71-78).

The port detects markers with its own detector (`ops/aruco`: gray and the
adaptive-threshold maps on `device`, contours and identification on the
host) and solves the pose with `utils/pnp`, both held to OpenCV's. Capture
takes a frame source (pipeline/sensors.py) so it runs headless; the HUD
loop needs a GUI, which the port does not have.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import aruco
from ..utils.png import write_png
from ..utils.pnp import rodrigues, solve_pnp
from ..utils.profiling import maybe_stage
from ..utils.yamlcv import write_yamlcv

MARKERS_X = 5
MARKERS_Y = 7
MARKER_LENGTH = 120
MARKER_SEPARATION = 20
PX_TO_MM = 0.283
BOARD_CENTER_OFFSET = np.array([96.0, 136.0, 0.0])


def _board() -> aruco.GridBoard:
    return aruco.GridBoard((MARKERS_X, MARKERS_Y), float(MARKER_LENGTH), float(MARKER_SEPARATION))


def create_aruco_board(path: str, width: int = 720, height: int = 1000) -> None:
    """Write the printable board image, 8-bit gray PNG (createArucoBoard,
    src/Aruco.cpp:11-34)."""
    write_png(path, _board().generate_image((width, height), margin=20))


def board_view(board_img: np.ndarray, cam, rvec, tvec) -> np.ndarray:
    """A synthetic BGR frame (cam.height x cam.width) of the printed board
    image (`create_aruco_board`'s, margin 20, one pixel a board unit) seen
    by the pinhole camera `cam` (no distortion) at the pose (rvec, tvec) of
    the board's units: each pixel reads the board pixel nearest to its
    back-projection onto the board plane, gray 128 off the board.
    Element-wise float64, so every machine draws the same frame."""
    rot = rodrigues(rvec)
    t = np.asarray(tvec, np.float64).ravel()
    # camera pixel -> board plane: invert K [r1 r2 t] by its adjugate
    h = cam.matrix @ np.stack([rot[:, 0], rot[:, 1], t], axis=1)
    inv = np.array([[h[1, 1] * h[2, 2] - h[1, 2] * h[2, 1], h[0, 2] * h[2, 1] - h[0, 1] * h[2, 2],
                     h[0, 1] * h[1, 2] - h[0, 2] * h[1, 1]],
                    [h[1, 2] * h[2, 0] - h[1, 0] * h[2, 2], h[0, 0] * h[2, 2] - h[0, 2] * h[2, 0],
                     h[0, 2] * h[1, 0] - h[0, 0] * h[1, 2]],
                    [h[1, 0] * h[2, 1] - h[1, 1] * h[2, 0], h[0, 1] * h[2, 0] - h[0, 0] * h[2, 1],
                     h[0, 0] * h[1, 1] - h[0, 1] * h[1, 0]]])
    v, u = np.mgrid[0:cam.height, 0:cam.width].astype(np.float64)
    w = inv[2, 0] * u + inv[2, 1] * v + inv[2, 2]
    bx = (inv[0, 0] * u + inv[0, 1] * v + inv[0, 2]) / w + 20.0
    by = (inv[1, 0] * u + inv[1, 1] * v + inv[1, 2]) / w + 20.0
    ix, iy = np.floor(bx + 0.5).astype(np.int64), np.floor(by + 0.5).astype(np.int64)
    rows, cols = board_img.shape
    on = (w > 0) & (ix >= 0) & (ix < cols) & (iy >= 0) & (iy < rows)
    gray = np.full((cam.height, cam.width), 128, np.uint8)
    gray[on] = board_img[iy[on], ix[on]]
    return np.repeat(gray[:, :, None], 3, axis=2)


def detect_markers(color, cam, refine: bool = True, device="cuda", timer=None) -> tuple:
    """(corners, ids) of the board's markers in one frame: the detector's
    first pass, then, when `refine` and candidates were rejected, the
    board-guided refine (cv::aruco::refineDetectedMarkers,
    src/Aruco.cpp:68). `timer` (utils/profiling.StageTimer), when given,
    times the stages "gray+threshold", "contours", "identify" and
    "refine"."""
    with maybe_stage(timer, "gray+threshold"):
        gray, maps = aruco.gray_and_maps(color, device)
    corners, ids, rejected = aruco.detect_from_maps(gray, maps, timer)
    if refine and rejected:
        with maybe_stage(timer, "refine"):
            corners, ids, _, _ = aruco.refine_detected_markers(
                gray, _board(), corners, ids, rejected, cam.matrix, np.asarray(cam.distortion, np.float64))
    return corners, ids


def board_pose(corners, ids, cam, timer=None):
    """(rot 3x3, trans mm) in the pipeline camera frame from detected
    markers, or None when fewer than one board marker was found. `timer`,
    when given, times the stage "pnp"."""
    if len(ids) == 0:
        return None
    with maybe_stage(timer, "pnp"):
        obj_pts, img_pts = aruco.match_image_points(_board(), corners, ids)
        if len(obj_pts) < 4:
            return None
        rvec, tvec = solve_pnp(obj_pts, img_pts, cam.matrix, np.asarray(cam.distortion, np.float64))
    rot = rodrigues(rvec)
    t = tvec.ravel() * PX_TO_MM
    # board-centre shift and axis flip into the pipeline frame
    # (src/Aruco.cpp:71-78)
    center = rot @ (BOARD_CENTER_OFFSET / PX_TO_MM) * PX_TO_MM + t
    rot_fixed = rot @ np.diag([1.0, -1.0, -1.0])
    return rot_fixed, center


def detect_board_pose(color, cam, refine: bool = True, device="cuda", timer=None):
    """Estimate the board pose in one frame; returns (rot 3x3, trans mm) in
    the pipeline camera frame, or None (detectBoard, src/Aruco.cpp:36-93).
    The gray frame and its threshold maps are computed on `device`.
    `timer` (utils/profiling.StageTimer), when given, times the stages of
    `detect_markers` and `board_pose`."""
    corners, ids = detect_markers(color, cam, refine, device, timer)
    return board_pose(corners, ids, cam, timer)


def capture_ground_truth(source, cam, out_dir: str = "benchmark", max_frames: int = 0, device="cuda") -> int:
    """Iterate frames from `source` (see sensors.FrameSource), saving
    img{i}.png / depth{i}.png / pose{i}.yml for frames with a detected board
    (the TAB-save loop of src/Aruco.cpp:94-108, non-interactive). Returns
    the number of frames saved."""
    os.makedirs(out_dir, exist_ok=True)
    i = 0
    for color, depth in source:
        result = detect_board_pose(color, cam, device=device)
        if result is None:
            continue
        rot, trans = result
        write_png(os.path.join(out_dir, f"img{i}.png"), np.ascontiguousarray(color, np.uint8))
        write_png(os.path.join(out_dir, f"depth{i}.png"), np.asarray(depth).astype(np.uint16))
        write_yamlcv(
            os.path.join(out_dir, f"pose{i}.yml"),
            {"rotMat": np.asarray(rot, np.float64), "position": list(map(float, trans))},
        )
        i += 1
        if max_frames and i >= max_frames:
            break
    return i


def capture_ground_truth_interactive(source, cam, out_dir: str = "benchmark"):
    """The reference's live HUD loop (src/Aruco.cpp:79-110) draws on a
    window and reads keys, which needs a GUI-capable OpenCV; the port has
    neither. Use capture_ground_truth for headless capture."""
    raise RuntimeError(
        "interactive ArUco capture needs a GUI-capable OpenCV (imshow/waitKey), "
        "which the PyTorch port does not use; run capture_ground_truth "
        "(cli aruco --capture without --interactive) for headless capture."
    )
