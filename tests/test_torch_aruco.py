"""The port's ArUco detector (`linemod_tpu_torch/ops/aruco.py`, host C++
`csrc/contours.cpp`), pose solver (`utils/pnp.py`) and ground-truth capture
(`pipeline/aruco_capture.py`) on the CPU: step by step against the cv2
function the JAX package calls, then whole against JAX.

- the DICT_6X6_100 table against `bytesList`, its bit packing both ways;
- gray over every BGR triple and the three threshold maps against
  `cvtColor` and `adaptiveThreshold`: 0 pixels differ;
- contours as ordered point lists against `findContours(RETR_LIST,
  CHAIN_APPROX_NONE)`, closed `approxPolyDP` and `isContourConvex`;
- the perspective transform, the 32x32 nearest-neighbour warp and Otsu;
- the board's object points and images (default size and one other);
- `rodrigues` and `project_points` within 1e-12, `solve_pnp` against
  `solvePnP` on seeded correspondences with distortion;
- `detect_from_maps` and `refine_detected_markers`: ids, corners and the
  rejected candidates equal to cv2's on the JAX test's frame, its
  noise-corrupted copy and four seeded perspective views at 1920x1080;
- the cases of `tests/test_aruco.py`, and the board pose and the capture
  against JAX's.

Poses. OpenCV's iterative solvePnP stops its Levenberg-Marquardt while
the step is still above float64 precision; the port iterates until the
step vanishes. solvePnP run again from its own answer
(`useExtrinsicGuess`) until it stops moving reaches the port's pose:
within 1e-9 in rotation and 1e-6 in translation (mm on the board). Its
reprojection error is never above OpenCV's, and its pose lies within the
measured gap of JAX's, which is one solvePnP call (the gaps are in the
docstrings of the cases).

Goldens: `tests/goldens/aruco_ref.npz` (cv2's board image; for each test
frame its cv2 ids and corners and JAX's pose; JAX's capture of the JAX
test frame) and the JPEG goldens of `tests/test_torch_jpeg.py`, which
`chip_smoke.py` holds the card to. Regenerate them all with
`env JAX_PLATFORMS=cpu python tests/test_torch_aruco.py`.
"""

import hashlib
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARUCO_REF = os.path.join(REPO, "tests", "goldens", "aruco_ref.npz")
# the four perspective views: (rvec, tvec) of the board, in board units
VIEW_SEEDS = (0, 2, 3, 4)
OTHER_BOARD = ((500, 730), 13)
# the port's pose against JAX's (one cv2.solvePnP call) on the clean
# frames: measured <= 1.47e-6 mm and <= 3.61e-8 in rotation
POSE_MM, POSE_ROT = 5e-6, 2e-7
# against cv2.solvePnP rerun from its own answer until it stops moving
# (`converged_pnp`): measured <= 6.5e-9 mm and <= 2.2e-10
CONVERGED_MM, CONVERGED_ROT = 1e-6, 1e-9


def camera():
    from linemod_tpu_torch.config import CameraParameters

    return CameraParameters(fx=1000.0, fy=1000.0, cx=960.0, cy=540.0, width=1920, height=1080)


def view_pose(seed: int) -> tuple:
    r = np.random.default_rng(seed)
    rvec = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.5, 0.5), r.uniform(-0.4, 0.4)])
    tvec = np.array([-340 + r.uniform(-150, 150), -480 + r.uniform(-60, 60), r.uniform(1150, 1600)])
    return rvec, tvec


def test_frames() -> dict:
    """{name: BGR frame}: the JAX test's frame (the board image on gray at
    (600, 40)), the same with a corner marker replaced by seeded noise
    (tests/test_aruco.py:41-65), and the four views, all 1920x1080. Built
    with numpy alone, so chip_smoke.py builds the same frames."""
    from linemod_tpu_torch.ops.aruco import GridBoard
    from linemod_tpu_torch.pipeline.aruco_capture import board_view

    board = GridBoard((5, 7), 120.0, 20.0).generate_image((720, 1000), 20)
    frame = np.full((1080, 1920, 3), 128, np.uint8)
    frame[40:1040, 600:1320] = board[:, :, None]
    noisy = frame.copy()
    noisy[60:180, 620:740] = np.random.default_rng(0).integers(0, 255, (120, 120, 3), dtype=np.uint8)
    out = {"jax": frame, "noisy": noisy}
    for s in VIEW_SEEDS:
        out[f"view{s}"] = board_view(board, camera(), *view_pose(s))
    return out


test_frames.__test__ = False  # a helper, not a test


@pytest.fixture(scope="module")
def frames():
    return test_frames()


@pytest.fixture(scope="module")
def cv_detector():
    import cv2

    return cv2.aruco.ArucoDetector(cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_100))


def _gray(frame):
    import cv2

    return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)


# -- the dictionary ----------------------------------------------------------------

def test_dictionary_table():
    import cv2

    from linemod_tpu_torch.ops import aruco

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_100)
    assert d.markerSize == aruco.MARKER_SIZE and d.maxCorrectionBits == aruco.MAX_CORRECTION_BITS
    assert np.array_equal(aruco.DICTIONARY.reshape(100, -1), d.bytesList.reshape(100, -1))
    for m in range(100):
        bits = cv2.aruco.Dictionary.getBitsFromByteList(d.bytesList[m:m + 1], 6)
        assert np.array_equal(aruco.unpack_bits(aruco.DICTIONARY[m, 0]), bits)
        for r in range(4):  # rotation r: the bits turned r quarter turns counter-clockwise
            assert np.array_equal(aruco.pack_bits(np.rot90(bits, r)), aruco.DICTIONARY[m, r])
        assert aruco.identify(np.rot90(bits, 1)) == (m, 1)


# -- gray and the threshold maps -----------------------------------------------------

def test_gray_every_triple():
    import cv2

    from linemod_tpu_torch.ops.aruco import to_gray

    v = np.arange(1 << 24, dtype=np.int64)
    img = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(np.uint8).reshape(4096, 4096, 3)
    assert np.array_equal(to_gray(torch.from_numpy(img)).numpy(), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("source", ["noise", "blurred", "jax", "view0", "noisy"])
def test_threshold_maps(frames, source):
    import cv2

    from linemod_tpu_torch.ops.aruco import THRESH_WINDOWS, threshold_maps

    rng = np.random.default_rng(5)
    if source == "noise":
        gray = rng.integers(0, 256, (123, 157), dtype=np.uint8)
    elif source == "blurred":
        gray = cv2.GaussianBlur(rng.integers(0, 256, (240, 320), dtype=np.uint8), (9, 9), 2.5)
    else:
        gray = _gray(frames[source])
    got = threshold_maps(torch.from_numpy(gray)).numpy()
    for k, m in zip(THRESH_WINDOWS, got):
        want = cv2.adaptiveThreshold(gray, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY_INV, k, 7)
        assert int((m != want).sum()) == 0, k


# -- contours, polygons, convexity ---------------------------------------------------

def _binaries(frames) -> dict:
    import cv2

    from linemod_tpu_torch.ops.aruco import threshold_maps

    rng = np.random.default_rng(6)
    out = {"random": (rng.random((90, 120)) < 0.5).astype(np.uint8) * 255,
           "blobs": (cv2.GaussianBlur(rng.random((200, 300)), (9, 9), 3) < 0.5).astype(np.uint8)}
    maps = threshold_maps(torch.from_numpy(_gray(frames["view0"]))).numpy()
    out.update({f"view0_{k}": m for k, m in zip((3, 13, 23), maps)})
    return out


@pytest.fixture(scope="module")
def binaries(frames):
    return _binaries(frames)


@pytest.mark.parametrize("name", ["random", "blobs", "view0_3", "view0_13", "view0_23"])
def test_contours_equal_cv2(binaries, name):
    """Every contour, point for point from its start point in OpenCV's
    direction, in OpenCV's order."""
    import cv2

    from linemod_tpu_torch.ops.aruco import find_contours

    img = binaries[name]
    want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    got = find_contours(img)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert np.array_equal(g, w.reshape(-1, 2))


@pytest.mark.parametrize("name", ["random", "blobs", "view0_13"])
def test_approx_poly_and_convexity_equal_cv2(binaries, name):
    import cv2

    from linemod_tpu_torch.ops.aruco import approx_poly_dp, find_contours, is_contour_convex

    polygons = 0
    for c in find_contours(binaries[name]):
        for eps in (0.03 * len(c), 0.5, 2.0, 5.0):
            want = cv2.approxPolyDP(c.reshape(-1, 1, 2), eps, True).reshape(-1, 2)
            got = approx_poly_dp(c, eps)
            assert np.array_equal(got, want), (len(c), eps)
            assert is_contour_convex(got) == cv2.isContourConvex(want.reshape(-1, 1, 2))
            polygons += len(got) == 4
    assert polygons > 0


# -- the bit read ---------------------------------------------------------------------

def test_warp_and_otsu_equal_cv2(frames):
    """For every square candidate of a view: OpenCV's transform, the 32x32
    nearest-neighbour warp and the Otsu threshold of the warp."""
    import cv2

    from linemod_tpu_torch.ops import aruco

    gray = _gray(frames["view2"])
    maps = aruco.threshold_maps(torch.from_numpy(gray)).numpy()
    cands = [aruco.clockwise(c) for m in maps for c, _ in aruco.marker_candidates(m)]
    assert len(cands) > 100
    for c in cands:
        m_want = cv2.getPerspectiveTransform(c, aruco._CANONICAL)
        m_got = aruco.perspective_transform(c, aruco._CANONICAL)
        np.testing.assert_allclose(m_got, m_want, rtol=1e-12, atol=1e-12)
        want = cv2.warpPerspective(gray, m_want, (32, 32), flags=cv2.INTER_NEAREST)
        got = aruco.marker_warp(gray, c)
        assert np.array_equal(got, want)
        t, _ = cv2.threshold(want, 125, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
        assert aruco.otsu_threshold(got) == int(t)


# -- the board ---------------------------------------------------------------------------

def _cv_board():
    import cv2

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_100)
    return cv2.aruco.GridBoard((5, 7), 120.0, 20.0, d)


@pytest.mark.parametrize("size", [((720, 1000), 20), OTHER_BOARD])
def test_board_image_equals_cv2(size):
    from linemod_tpu_torch.ops.aruco import GridBoard

    board = GridBoard((5, 7), 120.0, 20.0)
    assert np.array_equal(board.obj_points(), np.array(_cv_board().getObjPoints()))
    assert np.array_equal(board.ids, np.array(_cv_board().getIds()).ravel())
    want = _cv_board().generateImage(size[0], marginSize=size[1])
    assert np.array_equal(board.generate_image(*size), want)


# -- poses ---------------------------------------------------------------------------------

def test_rodrigues_and_projection_equal_cv2():
    import cv2

    from linemod_tpu_torch.utils.pnp import project_points, rodrigues

    rng = np.random.default_rng(7)
    cam = np.array([[1044.87, 0, 320], [0, 1045.69141, 240], [0, 0, 1.0]])
    dist = np.array([-2.7167827743927644e-03, 2.0942424424199252e-01, 1.1120545920170163e-03,
                     -6.6420567497010334e-03, 0.0])
    for _ in range(50):
        rvec = rng.normal(size=3) * rng.choice([1e-7, 0.5, 2.0])
        rot = cv2.Rodrigues(rvec)[0]
        np.testing.assert_allclose(rodrigues(rvec), rot, rtol=0, atol=1e-12)
        np.testing.assert_allclose(rodrigues(rot), cv2.Rodrigues(rot)[0].ravel(), rtol=0, atol=1e-12)
        tvec = np.array([rng.normal() * 100, rng.normal() * 100, 2000 + rng.random() * 1000])
        obj = rng.random((20, 3)) * 600
        want = cv2.projectPoints(obj, rvec, tvec, cam, dist)[0].reshape(-1, 2)
        np.testing.assert_allclose(project_points(obj, rvec, tvec, cam, dist), want, rtol=0, atol=1e-12 * 2048)


def converged_pnp(obj, img, cam, dist) -> tuple:
    """(rvec, tvec) of cv2.solvePnP, then of solvePnP again from its own
    answer (`useExtrinsicGuess`) until the answer stops moving, at most 20
    times: the optimum that one call approaches."""
    import cv2

    _, r, t = cv2.solvePnP(obj, img, cam, dist)
    for _ in range(20):
        _, r2, t2 = cv2.solvePnP(obj, img, cam, dist, r.copy(), t.copy(), useExtrinsicGuess=True)
        if np.array_equal(r2, r) and np.array_equal(t2, t):
            break
        r, t = r2, t2
    return r.ravel(), t.ravel()


def pipeline_pose(rvec, tvec) -> tuple:
    """JAX's board-to-pipeline conversion of a cv2 (rvec, tvec) pose
    (linemod_tpu/pipeline/aruco_capture.py:71-78), with cv2.Rodrigues."""
    import cv2

    from linemod_tpu.pipeline.aruco_capture import BOARD_CENTER_OFFSET, PX_TO_MM

    rot = cv2.Rodrigues(np.asarray(rvec, np.float64))[0]
    center = rot @ (BOARD_CENTER_OFFSET / PX_TO_MM) * PX_TO_MM + np.asarray(tvec, np.float64).ravel() * PX_TO_MM
    return rot @ np.diag([1.0, -1.0, -1.0]), center


def _cost(obj, img, rvec, tvec, cam, dist) -> float:
    from linemod_tpu_torch.utils.pnp import project_points

    return float(((project_points(obj, rvec, tvec, cam, dist) - img) ** 2).sum())


@pytest.mark.parametrize("planar", [True, False])
def test_solve_pnp_against_cv2(planar):
    """Seeded correspondences (0.5 px noise) with the fixture camera's
    distortion: the port's pose is within 1e-9 in rotation and 1e-6 in
    translation of cv2.solvePnP rerun from its own answer until it stops
    moving (measured, planar: 3.5e-10 and 1.2e-7; not planar: 1.7e-10 and
    8.5e-8). Against one solvePnP call, the port's reprojection error is
    never above cv2's, and its translation is within 5e-7 of cv2's
    relative to the distance, its rotation within 5e-6 (measured, planar:
    1.8e-7 and 1.4e-6; not planar: 1e-8 and 2.4e-8. cv2 stops with steps
    of that size left, and the flatter planar optimum lets them move the
    pose further)."""
    import cv2

    from linemod_tpu_torch.utils.pnp import solve_pnp

    rng = np.random.default_rng(8 + planar)
    cam = np.array([[1044.87, 0, 320], [0, 1045.69141, 240], [0, 0, 1.0]])
    dist = np.array([-2.7167827743927644e-03, 2.0942424424199252e-01, 1.1120545920170163e-03,
                     -6.6420567497010334e-03, 0.0])
    for _ in range(20):
        rvec = rng.normal(size=3) * 0.5
        tvec = np.array([rng.normal() * 100, rng.normal() * 100, 2000 + rng.random() * 1000])
        obj = rng.random((20, 3)) * 600
        if planar:
            obj[:, 2] = 0
        obj = obj.astype(np.float32)
        img = (cv2.projectPoints(obj.astype(np.float64), rvec, tvec, cam, dist)[0].reshape(-1, 2)
               + rng.normal(size=(20, 2)) * 0.5).astype(np.float32)
        _, r_cv, t_cv = cv2.solvePnP(obj, img, cam, dist)
        r, t = solve_pnp(obj, img, cam, dist)
        assert _cost(obj, img, r, t, cam, dist) <= _cost(obj, img, r_cv.ravel(), t_cv.ravel(), cam, dist) * (1 + 1e-12)
        scale = np.linalg.norm(t)
        assert np.abs(t - t_cv.ravel()).max() <= 5e-7 * scale
        assert np.abs(r - r_cv.ravel()).max() <= 5e-6
        r_conv, t_conv = converged_pnp(obj, img, cam, dist)
        assert np.abs(r - r_conv).max() <= 1e-9 and np.abs(t - t_conv).max() <= 1e-6
    with pytest.raises(ValueError, match="at least 4"):
        solve_pnp(obj[:3], img[:3], cam, dist)


# -- detection -----------------------------------------------------------------------------

def _same_markers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).reshape(4, 2), np.asarray(w).reshape(4, 2))


@pytest.mark.parametrize("name", ["jax", "noisy", "view0", "view2", "view3", "view4"])
def test_detect_markers_equal_cv2(frames, cv_detector, name):
    """ids, corners and rejected candidates, in cv2's order."""
    from linemod_tpu_torch.ops.aruco import detect_from_maps, gray_and_maps

    c_cv, ids_cv, rej_cv = cv_detector.detectMarkers(frames[name])
    corners, ids, rejected = detect_from_maps(*gray_and_maps(frames[name], "cpu"))
    assert np.array_equal(ids, ids_cv.ravel()) and len(ids) >= 33
    _same_markers(corners, c_cv)
    _same_markers(rejected, rej_cv)


def flip_cells(board: np.ndarray, marker: int, cells) -> np.ndarray:
    """The board image with the given inner cells (row, column) of a marker
    inverted: a marker the first pass cannot read (over 3 bits off) but
    the refine can (under 15)."""
    board = board.copy()
    row, col = divmod(marker, 5)
    x0, y0 = 20 + col * 140, 20 + row * 140
    for cy, cx in cells:
        cell = board[y0 + cy * 15:y0 + cy * 15 + 15, x0 + cx * 15:x0 + cx * 15 + 15]
        cell[:] = 255 - cell
    return board


@pytest.mark.parametrize("view", ["flat", "view3"])
def test_refine_equal_cv2(cv_detector, view):
    """refineDetectedMarkers with the camera on the first pass's output, on
    the board with five cells of markers 12 and 23 inverted (pasted flat as
    in the JAX test, and seen as view3): both recover the two markers from
    the same rejected candidates, with the same corners, ids and remaining
    rejected candidates."""
    from linemod_tpu_torch.ops import aruco
    from linemod_tpu_torch.pipeline.aruco_capture import board_view

    board = aruco.GridBoard((5, 7), 120.0, 20.0).generate_image((720, 1000), 20)
    board = flip_cells(board, 12, [(1, 1), (2, 3), (3, 5), (4, 2), (5, 4)])
    board = flip_cells(board, 23, [(1, 2), (2, 5), (3, 3), (5, 1), (6, 6)])
    if view == "flat":
        frame = np.full((1080, 1920, 3), 128, np.uint8)
        frame[40:1040, 600:1320] = board[:, :, None]
    else:
        frame = board_view(board, camera(), *view_pose(3))
    cam = camera()
    c_cv, ids_cv, rej_cv = cv_detector.detectMarkers(frame)
    c_cv2, ids_cv2, rej_cv2, rec_cv = cv_detector.refineDetectedMarkers(
        frame, _cv_board(), c_cv, ids_cv, rej_cv, cam.matrix, np.zeros(5))
    corners, ids, rejected = aruco.detect_from_maps(*aruco.gray_and_maps(frame, "cpu"))
    corners2, ids2, rejected2, recovered = aruco.refine_detected_markers(
        _gray(frame), aruco.GridBoard((5, 7), 120.0, 20.0), corners, ids, rejected, cam.matrix, np.zeros(5))
    assert len(ids) == 33 and sorted(ids2[33:]) == [12, 23]
    assert np.array_equal(ids2, ids_cv2.ravel())
    _same_markers(corners2, c_cv2)
    _same_markers(rejected2, rej_cv2)
    assert recovered == list(np.asarray(rec_cv).ravel())


# -- tests/test_aruco.py through the port -----------------------------------------------------

def test_board_pose_detected(frames):
    from linemod_tpu_torch.pipeline.aruco_capture import detect_board_pose

    result = detect_board_pose(frames["jax"], camera(), device="cpu")
    assert result is not None
    rot, trans = result
    assert rot.shape == (3, 3)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-6)


def test_refinement_recovers_occluded_marker(frames, cv_detector):
    """The noise-corrupted corner marker: the refine finds at least as many
    markers as the plain pass, the ids equal cv2's refined ids, and the
    board is still found."""
    from linemod_tpu_torch.pipeline.aruco_capture import detect_board_pose, detect_markers

    noisy, cam = frames["noisy"], camera()
    _, plain = detect_markers(noisy, cam, refine=False, device="cpu")
    _, refined = detect_markers(noisy, cam, refine=True, device="cpu")
    c_cv, ids_cv, rej_cv = cv_detector.detectMarkers(noisy)
    _, ids_cv2, _, _ = cv_detector.refineDetectedMarkers(
        noisy, _cv_board(), c_cv, ids_cv, rej_cv, cam.matrix, np.asarray(cam.distortion, np.float64))
    assert len(refined) >= len(plain)
    assert np.array_equal(refined, ids_cv2.ravel())
    assert detect_board_pose(noisy, cam, refine=True, device="cpu") is not None


def test_headless_capture_roundtrip(frames, tmp_path):
    from linemod_tpu_torch.pipeline.aruco_capture import capture_ground_truth
    from linemod_tpu_torch.utils.yamlcv import read_yamlcv

    depth = np.full(frames["jax"].shape[:2], 700, np.uint16)
    n = capture_ground_truth([(frames["jax"], depth)], camera(), out_dir=str(tmp_path), device="cpu")
    assert n == 1
    assert os.path.exists(tmp_path / "img0.png")
    assert os.path.exists(tmp_path / "depth0.png")
    d = read_yamlcv(str(tmp_path / "pose0.yml"))
    assert np.asarray(d["rotMat"]).shape == (3, 3)


def test_interactive_capture_needs_a_gui():
    from linemod_tpu_torch.pipeline.aruco_capture import capture_ground_truth_interactive

    with pytest.raises(RuntimeError, match="GUI-capable OpenCV"):
        capture_ground_truth_interactive([], camera())


# -- whole, against JAX ---------------------------------------------------------------------------

def _jax_camera():
    from linemod_tpu.config import CameraParameters

    return CameraParameters(fx=1000.0, fy=1000.0, cx=960.0, cy=540.0, width=1920, height=1080)


@pytest.mark.parametrize("name", ["jax", "view0", "view2", "view3", "view4"])
def test_board_pose_equals_jax(frames, name):
    """Clean frames: the port's pose within 5e-6 mm and 2e-7 of JAX's
    (measured <= 1.47e-6 mm, <= 3.61e-8), and its markers' reprojection
    error no larger than that of JAX's pose."""
    from linemod_tpu.pipeline.aruco_capture import detect_board_pose as jax_pose

    from linemod_tpu_torch.ops import aruco
    from linemod_tpu_torch.pipeline.aruco_capture import (
        BOARD_CENTER_OFFSET, PX_TO_MM, _board, board_pose, detect_markers)

    cam = camera()
    corners, ids = detect_markers(frames[name], cam, device="cpu")
    got = board_pose(corners, ids, cam)
    want = jax_pose(frames[name], _jax_camera())
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=POSE_ROT)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=POSE_MM)
    obj, img = aruco.match_image_points(_board(), corners, ids)

    def cost(pose):
        """Squared reprojection error of the markers at a pipeline-frame pose
        (the rotation kept as a matrix: a vector would lose the sub-1e-5
        rotations of the fronto-parallel frame)."""
        rot = pose[0] @ np.diag([1.0, -1.0, -1.0])
        t = (pose[1] - rot @ BOARD_CENTER_OFFSET) / PX_TO_MM
        pc = obj.astype(np.float64) @ rot.T + t
        uv = pc[:, :2] / pc[:, 2:] * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        return float(((uv - img) ** 2).sum())

    assert cost(got) <= cost(want) * (1 + 1e-12)


@pytest.mark.parametrize("name", ["jax", "noisy", "view0", "view2", "view3", "view4"])
def test_board_pose_equals_converged_cv2(frames, cv_detector, name):
    """The port's pose within 1e-6 mm and 1e-9 of the pose of cv2.solvePnP
    rerun from its own answer until it stops moving, on cv2's matched
    points of cv2's refined markers (measured <= 6.5e-9 mm, <= 2.2e-10),
    and equal to the golden's converged pose within the same bounds."""
    from linemod_tpu_torch.pipeline.aruco_capture import detect_board_pose

    cam = camera()
    dist = np.asarray(cam.distortion, np.float64)
    corners, ids, rejected = cv_detector.detectMarkers(frames[name])
    corners, ids, _, _ = cv_detector.refineDetectedMarkers(frames[name], _cv_board(), corners, ids, rejected, cam.matrix, dist)
    obj, img = _cv_board().matchImagePoints(corners, ids)
    want = pipeline_pose(*converged_pnp(obj, img, cam.matrix, dist))
    got = detect_board_pose(frames[name], cam, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=CONVERGED_ROT)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=CONVERGED_MM)
    ref = np.load(ARUCO_REF)
    np.testing.assert_allclose(ref[f"{name}_rot_converged"], want[0], rtol=0, atol=CONVERGED_ROT)
    np.testing.assert_allclose(ref[f"{name}_t_converged"], want[1], rtol=0, atol=CONVERGED_MM)


def test_noisy_pose_equals_jax(frames):
    """The noise-corrupted frame (refined): within 0.5 mm and 1e-3 of JAX's
    (measured 1e-6 mm)."""
    from linemod_tpu.pipeline.aruco_capture import detect_board_pose as jax_pose

    from linemod_tpu_torch.pipeline.aruco_capture import detect_board_pose

    got = detect_board_pose(frames["noisy"], camera(), device="cpu")
    want = jax_pose(frames["noisy"], _jax_camera())
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=0.5)


def test_capture_equals_jax(frames, tmp_path):
    """capture_ground_truth over the JAX frame, a board-less frame and a
    view: the files cv2.imread reads equal to JAX's, the poses within the
    solvers' gap."""
    import cv2

    from linemod_tpu.pipeline.aruco_capture import capture_ground_truth as jax_capture
    from linemod_tpu.utils.yamlcv import read_yamlcv as jax_read

    from linemod_tpu_torch.pipeline.aruco_capture import capture_ground_truth

    depth = np.full((1080, 1920), 700, np.uint16)
    source = [(frames["jax"], depth), (np.full_like(frames["jax"], 128), depth), (frames["view2"], depth + 5)]
    assert jax_capture(source, _jax_camera(), out_dir=str(tmp_path / "jax")) == 2
    assert capture_ground_truth(source, camera(), out_dir=str(tmp_path / "port"), device="cpu") == 2
    for i in range(2):
        for name in (f"img{i}.png", f"depth{i}.png"):
            want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
            assert np.array_equal(cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED), want)
        want, got = jax_read(str(tmp_path / "jax" / f"pose{i}.yml")), jax_read(str(tmp_path / "port" / f"pose{i}.yml"))
        np.testing.assert_allclose(got["rotMat"], want["rotMat"], rtol=0, atol=POSE_ROT)
        np.testing.assert_allclose(got["position"], want["position"], rtol=0, atol=POSE_MM)


def test_goldens_hold(frames):
    """aruco_ref.npz agrees with the port: the board image, every frame's
    ids and corners (first pass and refined), JAX's poses within the gap
    and the converged cv2 poses within 1e-6 mm / 1e-9; so chip_smoke.py's
    checks of the card test the same things."""
    from linemod_tpu_torch.ops.aruco import GridBoard
    from linemod_tpu_torch.pipeline.aruco_capture import detect_board_pose, detect_markers

    ref = np.load(ARUCO_REF)
    board = GridBoard((5, 7), 120.0, 20.0)
    assert np.array_equal(board.generate_image((720, 1000), 20), ref["board"])
    assert np.array_equal(board.generate_image(*OTHER_BOARD), ref["board_other"])
    assert list(ref["frames"]) == list(frames)
    for name, frame in frames.items():
        assert hashlib.sha256(frame.tobytes()).hexdigest() == str(ref[f"{name}_sha256"])
        for refine, key in ((False, "plain"), (True, "refined")):
            corners, ids = detect_markers(frame, camera(), refine=refine, device="cpu")
            assert np.array_equal(ids, ref[f"{name}_{key}_ids"])
            assert np.array_equal(np.array(corners).reshape(-1, 4, 2), ref[f"{name}_{key}_corners"])
        rot, t = detect_board_pose(frame, camera(), device="cpu")
        tol = (1e-3, 0.5) if name == "noisy" else (POSE_ROT, POSE_MM)
        np.testing.assert_allclose(rot, ref[f"{name}_rot"], rtol=0, atol=tol[0])
        np.testing.assert_allclose(t, ref[f"{name}_t"], rtol=0, atol=tol[1])
        np.testing.assert_allclose(rot, ref[f"{name}_rot_converged"], rtol=0, atol=CONVERGED_ROT)
        np.testing.assert_allclose(t, ref[f"{name}_t_converged"], rtol=0, atol=CONVERGED_MM)


# -- the goldens ------------------------------------------------------------------------------------

def make_aruco_goldens(tmp_dir: str) -> dict:
    """cv2's board images, each test frame's cv2 ids and corners (first pass
    and refined with the camera, as JAX's detect_board_pose refines), JAX's
    pose and the pose of solvePnP rerun until it stops moving
    (`converged_pnp`) on those corners, and JAX's capture of the JAX test
    frame."""
    import cv2

    from linemod_tpu.pipeline.aruco_capture import capture_ground_truth as jax_capture
    from linemod_tpu.pipeline.aruco_capture import detect_board_pose as jax_pose
    from linemod_tpu.utils.yamlcv import read_yamlcv as jax_read

    det = cv2.aruco.ArucoDetector(cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_100))
    cam = _jax_camera()
    out = {"board": _cv_board().generateImage((720, 1000), marginSize=20),
           "board_other": _cv_board().generateImage(OTHER_BOARD[0], marginSize=OTHER_BOARD[1])}
    frames = test_frames()
    out["frames"] = np.array(list(frames))
    for name, frame in frames.items():
        out[f"{name}_sha256"] = np.array(hashlib.sha256(frame.tobytes()).hexdigest())
        corners, ids, rejected = det.detectMarkers(frame)
        out[f"{name}_plain_ids"] = ids.ravel().astype(np.int32)
        out[f"{name}_plain_corners"] = np.array(corners, np.float32).reshape(-1, 4, 2)
        corners, ids, _, _ = det.refineDetectedMarkers(frame, _cv_board(), corners, ids, rejected, cam.matrix,
                                                       np.asarray(cam.distortion, np.float64))
        out[f"{name}_refined_ids"] = ids.ravel().astype(np.int32)
        out[f"{name}_refined_corners"] = np.array(corners, np.float32).reshape(-1, 4, 2)
        obj, img = _cv_board().matchImagePoints(corners, ids)
        dist = np.asarray(cam.distortion, np.float64)
        out[f"{name}_rot_converged"], out[f"{name}_t_converged"] = pipeline_pose(*converged_pnp(obj, img, cam.matrix, dist))
        rot, t = jax_pose(frame, cam)
        out[f"{name}_rot"], out[f"{name}_t"] = rot, t
    depth = np.full((1080, 1920), 700, np.uint16)
    cap = os.path.join(tmp_dir, "capture")
    assert jax_capture([(frames["jax"], depth)], cam, out_dir=cap) == 1
    out["capture_img_sha256"] = np.array(hashlib.sha256(cv2.imread(os.path.join(cap, "img0.png")).tobytes()).hexdigest())
    out["capture_depth_sha256"] = np.array(hashlib.sha256(
        cv2.imread(os.path.join(cap, "depth0.png"), cv2.IMREAD_ANYDEPTH).tobytes()).hexdigest())
    pose = jax_read(os.path.join(cap, "pose0.yml"))
    out["capture_rot"], out["capture_position"] = pose["rotMat"], np.array(pose["position"])
    np.savez_compressed(ARUCO_REF, **out)
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_jpeg import make_jpeg_goldens

    with tempfile.TemporaryDirectory() as tmp:
        jpeg = make_jpeg_goldens(tmp)
        print(f"wrote {len(jpeg['names'])} JPEG goldens and their digests, {len(jpeg['evaluate_lines'])} evaluate "
              f"and {len(jpeg['detect_lines'])} detect lines")
        aruco = make_aruco_goldens(tmp)
        print(f"wrote {ARUCO_REF}: {len(aruco['frames'])} frames")
