"""ArUco marker detection without OpenCV (counterpart of the `cv2.aruco`
calls of `linemod_tpu/pipeline/aruco_capture.py`).

A copy of OpenCV 5's `ArucoDetector.detectMarkers` and
`refineDetectedMarkers` (objdetect/aruco_detector.cpp) for one dictionary,
`DICT_6X6_100`, at the default `DetectorParameters` and
`RefineParameters`, and of `GridBoard`'s object points, `generateImage`
and `matchImagePoints` (objdetect/aruco_board.cpp). Given the same frame,
the ids, corners and rejected candidates equal OpenCV's.

The stages:
  - gray and the three adaptive-threshold maps (windows 3, 13 and 23,
    constant 7): torch ops on the caller's device (`threshold_maps`);
  - the contours of each map and the square candidates among them:
    host C++ (`csrc/contours.cpp`, built by g++ at first use);
  - corner order, grouping of candidates that lie too close, the bit read
    (perspective transform, a 32x32 nearest-neighbour warp, Otsu, cell
    counts) and identification against the dictionary: numpy here.
Corner refinement is OpenCV's default, none: corners are the integer
vertices of the approximating quadrilateral.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from ..utils import hostlib
from ..utils.pnp import project_points, solve_pnp
from ..utils.profiling import maybe_stage

# DICT_6X6_100 (cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_100)
# .bytesList): for each marker, its 6x6 bits packed row-major in 5 bytes
# (the last byte's low nibble) for each of the four rotations, in turn.
_DICT_HEX = (
    "1e3dd82a06e3ba4631096541bbc70898c625dc07", "0efba38901d7e618050e891c5df7007a01867e0b", "15907eac0dec69575006b357e09a0860aea96307", "c91b30690e42324bde0c7960cd890337bd24c402",
    "d607d6e105a4cb4abf02a876be060b4fd52d3205", "d8e8e0e6082b8c138a0f167071710bf51c831d04", "4268b41f050da5c0950daf82d16402ba903a5b00", "88a50f290a1373172600594f0a5101064e8cec08",
    "307d524f0d6d6e613c09bf24abe00c93c8676b06", "3c2f34b30c830beb340f3cd2cf430cf2cd7d0c01", "45dfc74e03fcf718e809c72e3fba0291718ef30f", "48d85b25077e54569408ea4da1b1021296a2a70e",
    "710558fc06283ae6f80263f1aa080e41f675c104", "86dcfad007e4d4d43b0ee0b5f3b6017dc2b2b207", "8d72a93f06dbb4ce46056fc954eb01a62732dd0b", "a2b89dcd0e59b1751f0a7b3b91d4055f8ae8d90a",
    "09fd1e9c044b67d4700a23978bf90050e2be6d02", "154dbd180f94bfc5700cf18bdb2a0830ea3fd209", "300a310e02183828100d4708c5000cb08141c108", "4807efaf0d3ee34fa407bf5f7e0102e25f2c770c",
    "56df11db06d03ed8bd0b6db88fb60adbd1b7c00b", "668832740c8840f3990c32e4c11606399cf02101", "76e8cb7801b5ecb6890881ed31760e1916d37a0d", "9a53d9cf037ebe0c1f03cf39bca509cf8307d70e",
    "a9cb840204028778420924021d39059421ee1400", "c675494900f12604af0009292ae6030f5206480f", "c1d28894014c849cc202829114b8034433921302", "e74808520b8414a5cb09d4a1012e079d3a528201",
    "ea2fca84082bc22da30a12153f45075c5b443d04", "e963b77b0117e7aade058deedc6907a7b55e7e08", "fa36652a0f77396ba305f54a66c50fac5d69ce0e", "065bff7b0df4e7cf1d0dbdeffda600bb8f3e720f",
    "0541d72d06b8f74254006b4eb82a0002a42ef10d", "0cf7246a02c3371a280545624ef300a1458ecc03", "1338a39e0b5df881410fd79c51cc08f82811fb0a", "15a893e70499c8525c0b2e7c915a08d3a4a13909",
    "3a417ee90e227f671d067977e8250c6b8e6fe404", "4f11e26c00eae202c9040364788f022934047507", "530db6d20000cb80f90f04b6db0c0af9f01d3000", "589bfae30462ca5e9c0f2c75fd910af397a53406",
    "6409e8a00ba49227800ed051790206701e449205", "60537a890164662c94068915eca0066293466206", "6159069b0a4077a1c40b5d9609a806d2385ee002", "6bff78d70b6f16bdfd0fdeb1effd06fbfbd68f06",
    "70ad96a40f0ddb73b00af2569b500e50dcedbb00", "75846f710ab059b7ec0458ef621a0e237ed9a00d", "7a95192f0c5a2a77b5013f498a950e8adee5450a", "8609760a0aa07301130d5506e90601bc880ce005",
    "8a2d44c30f2713412f0bfc322b4501df482c8e04", "93eb78b104210ede570e28d1ed7c097ea7b70804", "988da84d040aaa542e0c2b215b11093742a55500", "9ede2b3c08da6c9f230c13cd47b7093c4f93650b",
    "a529e07b08a1a2a34e0d1de0794a05b72c545805", "b593b8550fcc9afd5e04faa1dc9a0d27abf59303", "b7f8e4260fed9d73430df64271fe0dbc2ceb9b07", "bc2052250eab586316007a44a0430d068c61ad05",
    "c0448776051cc5c2aa01a6ee12200385543a3308", "c4c32425098c071b86049a424c3203261d8e0301", "c5a91bd80d9562d5da0ab1bd895a0355bab46a09", "ce73e6b20ce3c7cb830734d67ce703ec1d3e3c07",
    "cd0ca627028ad102e60d4e46530b03b67408b501", "c9435d440d3e074dda00b22bac290305bb2e070c", "cfbe80f304c380daef0b2cf017df03df75b01c03", "e57d158707dd1760f60bee1a8bea07d6f06e8b0b",
    "efc6858e099ea539e303971a163f07cc79ca5709", "f77ef37702f9dcaaff0d4eecf7ee0fbff553b90f", "2ce43f25049b457634042a4fc2730422c6ea2d09", "2bdcff4b0376f5347d0dcd2ff3bd04bbe2caf60e",
    "37c7ddbd0ab8bfbf75025bdbbe3e0c4aefdfd10d", "a1a254e00f25117b5a02f072a4580545ade88a04", "a982c1bb0536a0fa4603add8341905c625f0560c", "d81b49b008720a8f820a10d92d810b541f15040e",
    "035829f8065034c6490e61f941ac00792632c00a", "07c4095f0c9824d56d013fa9023e008b6ab24109", "0fe266170baf55994505de86647f00aa299aaf05", "14483644018c4d00180c8226c1220831800b2301",
    "10ad5ffb07357bd63c0bedffab5008d3c6bdea0c", "128295530f1499d91d01fcaa9414088b89b99208", "16e131840c990e5111063218c876086888a70909", "187a496b00732c0e0c090d6925e1089307034c0e",
    "1ae886110203dd90050848861175081a009bbc00", "1913ae0a0146eb0c400585075c8908a0230d7602", "1b67b5a107179f4a7506e85ade6d086ae52f9e08", "25dc95f00bd495b3780ad0fa93ba0451ecda920b",
    "288961f7063a12f20c0f6ef8691104f304f4850c", "3354146a0a403d237901556282ac0c89ec4bc002", "31c16c1f072c3ff44405ef8368380ca222ffc304", "33cb18c606081e7c590b66318d3c0cd9a3e78100",
    "3ecfe4900fa69ff9210ef0927f370c7849ff9605", "464518a30f841647b503fc518a2602cade268201", "44ba70b607ed10da900fe6d0e5d202f095b08b07", "419c623e08686093e00d17c4639802b07c906106",
    "48d1914a0156a6109801852898b102819086560a", "54f499f60ddd8cd7b803b6f992f20ac1deb31b0b", "575a9c8103c49d0cd50ac81395ae0a5ab30b9203", "558355b20cb00bdbd00334daac1a0ac0bdbd000d",
    "57b776100fe55bd9f104f086eede0a28f9bdaa07", "5c3436fe04cb69c2b80727f6c2c30ae1d4396d03", "5c48fc770eaa9dc79c0d7ee3f1230ab39e3b9505", "5e6eef4002b3dd0ca90c402f77670a39530bbc0d",
)
DICTIONARY = np.frombuffer(bytes.fromhex("".join(_DICT_HEX)), np.uint8).reshape(100, 4, 5)
MARKER_SIZE = 6
MAX_CORRECTION_BITS = 5

# DetectorParameters() defaults
THRESH_WINDOWS = (3, 13, 23)
THRESH_CONSTANT = 7
MIN_PERIMETER_RATE = 0.03
MAX_PERIMETER_RATE = 4.0
POLY_ACCURACY_RATE = 0.03
MIN_CORNER_DISTANCE_RATE = 0.05
MIN_DISTANCE_TO_BORDER = 3
MIN_MARKER_DISTANCE_RATE = np.float32(0.125)
MIN_GROUP_DISTANCE = np.float32(0.21)
BORDER_BITS = 1
CELL_PIXELS = 4
CELL_MARGIN_RATE = 0.13
MIN_OTSU_STD_DEV = 5.0
ERROR_CORRECTION_RATE = 0.6
MAX_BORDER_ERROR_RATE = 0.35
# RefineParameters() defaults
REFINE_MIN_REP_DISTANCE = 10.0
REFINE_ERROR_CORRECTION_RATE = 3.0

_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_library = []


def _lib():
    """csrc/contours.cpp, built by g++ into build/host/ at first use. A
    failed build raises."""
    with _lock:
        if not _library:
            lib = hostlib.load("contours", _CXX_FLAGS)
            vp = ctypes.c_void_p
            lib.find_contours.argtypes = [vp, ctypes.c_int, ctypes.c_int]
            lib.marker_contours.argtypes = [vp, ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_int]
            lib.find_contours.restype = lib.marker_contours.restype = vp
            lib.seq_count.argtypes = lib.seq_points.argtypes = lib.seq_free.argtypes = [vp]
            lib.seq_points.restype = ctypes.c_long
            lib.seq_copy.argtypes = [vp, vp, vp]
            lib.approx_poly_dp.argtypes = [vp, ctypes.c_int, ctypes.c_double, vp]
            lib.is_contour_convex.argtypes = [vp, ctypes.c_int]
            _library.append(lib)
        return _library[0]


def _sequences(handle) -> list:
    """The int point sequences of a contours.cpp result, freed after."""
    lib = _lib()
    try:
        n = lib.seq_count(handle)
        lengths = np.zeros(n, np.int32)
        points = np.zeros((lib.seq_points(handle), 2), np.int32)
        lib.seq_copy(handle, lengths.ctypes.data, points.ctypes.data)
    finally:
        lib.seq_free(handle)
    return np.split(points, np.cumsum(lengths)[:-1]) if n else []


def find_contours(binary: np.ndarray) -> list:
    """cv2.findContours(binary, RETR_LIST, CHAIN_APPROX_NONE)'s contours,
    each an int32 [N, 2] array of (x, y), in OpenCV's order."""
    img = np.ascontiguousarray(binary, np.uint8)
    return _sequences(_lib().find_contours(img.ctypes.data, img.shape[0], img.shape[1]))


def approx_poly_dp(points: np.ndarray, eps: float) -> np.ndarray:
    """cv2.approxPolyDP(points, eps, closed=True) on int points [N, 2]."""
    pts = np.ascontiguousarray(points, np.int32).reshape(-1, 2)
    out = np.empty_like(pts)
    k = _lib().approx_poly_dp(pts.ctypes.data, len(pts), float(eps), out.ctypes.data)
    return out[:k]


def is_contour_convex(points: np.ndarray) -> bool:
    """cv2.isContourConvex on int points [N, 2]."""
    pts = np.ascontiguousarray(points, np.int32).reshape(-1, 2)
    return bool(_lib().is_contour_convex(pts.ctypes.data, len(pts)))


# -- gray and the adaptive-threshold maps (on the device) ------------------


def to_gray(color: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(BGR2GRAY) of u8 [H, W, 3] (or u8 [H, W], returned as
    is): OpenCV 5's fixed point, (7470 B + 38470 G + 19596 R + 2^15) >> 16."""
    if color.dim() == 2:
        return color
    c = color.to(torch.int32)
    g = (c[..., 0] * 7470 + c[..., 1] * 38470 + c[..., 2] * 19596 + 32768) >> 16
    return g.to(torch.uint8)


def threshold_maps(gray: torch.Tensor) -> torch.Tensor:
    """cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_MEAN_C,
    THRESH_BINARY_INV, k, 7) for each window k of THRESH_WINDOWS -> u8
    [3, H, W].

    The mean is OpenCV's normalized box filter over the frame extended by
    BORDER_REPLICATE, rounded to u8 (k^2 is odd, so round(s / k^2) never
    ties); a pixel is 255 where gray - mean <= -7. Integer sums, so every
    device gives the same map."""
    g = gray.to(torch.int32)
    h, w = g.shape
    out = []
    for k in THRESH_WINDOWS:
        r = k // 2
        ys = torch.arange(-r, h + r, device=g.device).clamp_(0, h - 1)
        xs = torch.arange(-r, w + r, device=g.device).clamp_(0, w - 1)
        padded = g.index_select(0, ys).index_select(1, xs)
        sums = torch.nn.functional.pad(padded.cumsum(0).cumsum(1), (1, 0, 1, 0))
        box = sums[k:, k:] - sums[:-k, k:] - sums[k:, :-k] + sums[:-k, :-k]
        mean = torch.div(2 * box + k * k, 2 * k * k, rounding_mode="floor")
        out.append(((g - mean) <= -THRESH_CONSTANT).to(torch.uint8) * 255)
    return torch.stack(out)


# -- candidates ---------------------------------------------------------------


def marker_candidates(binary: np.ndarray) -> list:
    """_findMarkerContours over one thresholded map: (corners float32
    [4, 2], contour int32 [N, 2]) of every convex quadrilateral whose
    contour length, corner spacing and distance to the border pass."""
    img = np.ascontiguousarray(binary, np.uint8)
    h, w = img.shape
    seqs = _sequences(_lib().marker_contours(
        img.ctypes.data, h, w, MIN_PERIMETER_RATE, MAX_PERIMETER_RATE, POLY_ACCURACY_RATE,
        MIN_CORNER_DISTANCE_RATE, MIN_DISTANCE_TO_BORDER))
    return [(seqs[i].astype(np.float32), seqs[i + 1]) for i in range(0, len(seqs), 2)]


def clockwise(corners: np.ndarray) -> np.ndarray:
    """_reorderCandidatesCorners: swap corners 1 and 3 when the first turn
    is counter-clockwise (in image coordinates)."""
    c = corners.astype(np.float64)
    dx1, dy1 = c[1] - c[0]
    dx2, dy2 = c[2] - c[0]
    if dx1 * dy2 - dy1 * dx2 < 0.0:
        corners = corners[[0, 3, 2, 1]]
    return corners


def _perimeter(corners: np.ndarray) -> np.float32:
    d = (corners - np.roll(corners, -1, axis=0)).astype(np.float64)
    total = np.float32(0)
    for side in np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32):
        total = np.float32(total + side)
    return total


def _average_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """getAverageDistance for every pair: a [N, 4, 2], b [M, 4, 2] float32
    -> [N, M] float32, the least over the 4 corner shifts of the rms of the
    corner distances, in float32 as OpenCV sums them."""
    best = None
    for fc in range(4):
        total = np.zeros((a.shape[0], b.shape[0]), np.float32)
        for c in range(4):
            d = a[:, None, (c + fc) % 4] - b[None, :, c]
            total = total + (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        total = total / np.float32(4)
        best = total if best is None else np.minimum(best, total)
    return np.sqrt(best)


def _module_size(corners: np.ndarray) -> np.float32:
    total = np.float32(0)
    for i in range(4):
        d = corners[i] - corners[(i + 1) % 4]
        total = np.float32(total + np.sqrt(np.float32(d[0] * d[0] + d[1] * d[1])))
    return np.float32(total / np.float32(4 * (MARKER_SIZE + 2 * BORDER_BITS)))


def _point_in_polygon(poly: np.ndarray, pt) -> int:
    """cv2.pointPolygonTest(poly, pt, measureDist=False) on float points:
    1 inside, 0 on an edge, -1 outside."""
    px, py = float(pt[0]), float(pt[1])
    counter = 0
    vx, vy = float(poly[-1][0]), float(poly[-1][1])
    for i in range(len(poly)):
        v0x, v0y = vx, vy
        vx, vy = float(poly[i][0]), float(poly[i][1])
        if (v0y <= py and vy <= py) or (v0y > py and vy > py) or (v0x < px and vx < px):
            if py == vy and (px == vx or (py == v0y and (v0x <= px <= vx or vx <= px <= v0x))):
                return 0
            continue
        dist = (py - v0y) * (vx - v0x) - (px - v0x) * (vy - v0y)
        if dist == 0:
            return 0
        if vy < v0y:
            dist = -dist
        counter += dist > 0
    return 1 if counter % 2 else -1


def _inside(inner: np.ndarray, outer: np.ndarray) -> bool:
    return all(_point_in_polygon(outer, p) >= 0 for p in inner)


@dataclasses.dataclass
class Candidate:
    corners: np.ndarray   # float32 [4, 2], clockwise
    contour: np.ndarray   # int32 [N, 2]
    perimeter: np.float32
    parent: int = -1
    depth: int = 0
    close: list = dataclasses.field(default_factory=list)  # (corners, contour) to try next


def group_candidates(found: list, h: int, w: int) -> list:
    """filterTooCloseCandidates: candidates sorted by perimeter (largest
    first, stable); candidates whose average corner distance is under
    0.125 of a perimeter form a group, represented by its largest member,
    which carries the members lying farther than 0.21 modules from it to
    try when it fails; then each candidate's parent (the smallest one
    holding all four of its corners) and depth (0 for the innermost)."""
    cands = [Candidate(c, ct, _perimeter(c)) for c, ct in found]
    order = sorted(range(len(cands)), key=lambda i: -float(cands[i].perimeter))  # stable
    cands = [cands[i] for i in order]
    n = len(cands)
    selected = np.ones(n, bool)
    group_of = np.full(n, -1)
    groups: list[list[int]] = []
    if n:
        corners = np.stack([c.corners for c in cands])
        perims = np.array([c.perimeter for c in cands], np.float32)
        dist = _average_distances(corners, corners)
        close = dist < perims[None, :] * MIN_MARKER_DISTANCE_RATE
        for i in range(n):
            for j in np.nonzero(close[i, i + 1:])[0] + i + 1:
                selected[i] = selected[j] = False
                if group_of[i] < 0 and group_of[j] < 0:
                    group_of[i] = group_of[j] = len(groups)
                    groups.append([i, j])
                elif group_of[i] >= 0 and group_of[j] < 0:
                    group_of[j] = group_of[i]
                    groups[group_of[i]].append(j)
                elif group_of[j] >= 0 and group_of[i] < 0:
                    group_of[i] = group_of[j]
                    groups[group_of[j]].append(i)
    b = MIN_DISTANCE_TO_BORDER
    for members in groups:
        members = sorted(members)
        head = members[0]
        c = cands[head].corners
        if (c[:, 0] < b).any() or (c[:, 1] < b).any() or (c[:, 0] > w - 1 - b).any() or (c[:, 1] > h - 1 - b).any():
            continue
        selected[head] = True
        cur = head
        for m in members[1:]:
            d = _average_distances(cands[m].corners[None], cands[cur].corners[None])[0, 0]
            if d > MIN_GROUP_DISTANCE * _module_size(cands[m].corners):
                cur = m
                cands[head].close.append((cands[m].corners, cands[m].contour))
    out = [cands[i] for i in range(n) if selected[i]]
    for i in range(len(out) - 1, -1, -1):
        for j in range(i - 1, -1, -1):
            if _inside(out[i].corners, out[j].corners):
                out[i].parent = j
                out[j].depth = max(out[j].depth, out[i].depth + 1)
                break
    return out


# -- the bit read ---------------------------------------------------------------


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform(src, dst) (float32 [4, 2] each): the 8x8
    system solved by OpenCV's LU with partial pivoting, in float64."""
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        sx, sy = np.float32(src[i, 0]), np.float32(src[i, 1])
        dx, dy = np.float32(dst[i, 0]), np.float32(dst[i, 1])
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1
        a[i, 6] = -sx * dx
        a[i, 7] = -sy * dx
        a[i + 4, 6] = -sx * dy
        a[i + 4, 7] = -sy * dy
        b[i], b[i + 4] = dx, dy
    x = _lu_solve(a, b)
    return np.append(x, 1.0).reshape(3, 3)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's LUImpl (core/src/matrix_decomp.cpp) for one right-hand side."""
    a = a.copy()
    b = b.copy()
    m = len(b)
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if abs(a[k, i]) < np.finfo(np.float64).eps * 100:
            return np.zeros(m)  # cv::solve's answer to a singular system
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
        a[i, i] = -d
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s * a[i, i]
    return b


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv::invert(DECOMP_LU) of a 3x3: OpenCV's closed form."""
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d, (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d, (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d, (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


def warp_nearest(gray: np.ndarray, transform: np.ndarray, size: int) -> np.ndarray:
    """cv2.warpPerspective(gray, transform, (size, size), INTER_NEAREST):
    each output pixel reads the source pixel nearest (round half to even) to
    its inverse-mapped position, 0 outside the frame."""
    m = _invert3(transform).ravel()
    xs = np.arange(size, dtype=np.float64)
    ys = np.arange(size, dtype=np.float64)[:, None]
    x0 = m[1] * ys + m[2]
    y0 = m[4] * ys + m[5]
    w0 = m[7] * ys + m[8]
    wv = w0 + m[6] * xs
    wv = np.divide(1.0, wv, out=np.zeros_like(wv), where=wv != 0)
    fx = np.clip((x0 + m[0] * xs) * wv, -2.0 ** 31, 2.0 ** 31 - 1)
    fy = np.clip((y0 + m[3] * xs) * wv, -2.0 ** 31, 2.0 ** 31 - 1)
    sx = np.clip(np.rint(fx), -32768, 32767).astype(np.int64)
    sy = np.clip(np.rint(fy), -32768, 32767).astype(np.int64)
    h, w = gray.shape
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros((size, size), np.uint8)
    out[inside] = gray[sy[inside], sx[inside]]
    return out


def otsu_threshold(img: np.ndarray) -> int:
    """The threshold cv2.threshold(img, 125, 255, THRESH_BINARY | THRESH_OTSU)
    picks (getThreshVal_Otsu_8u)."""
    hist = np.bincount(img.ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return int(max_val)


_CANONICAL = np.float32(
    [[0, 0], [(MARKER_SIZE + 2 * BORDER_BITS) * CELL_PIXELS - 1, 0],
     [(MARKER_SIZE + 2 * BORDER_BITS) * CELL_PIXELS - 1, (MARKER_SIZE + 2 * BORDER_BITS) * CELL_PIXELS - 1],
     [0, (MARKER_SIZE + 2 * BORDER_BITS) * CELL_PIXELS - 1]])


def marker_warp(gray: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """The candidate seen square: 32x32 u8 (8 cells of 4 pixels)."""
    size = (MARKER_SIZE + 2 * BORDER_BITS) * CELL_PIXELS
    return warp_nearest(gray, perspective_transform(corners, _CANONICAL), size)


def extract_bits(gray: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """_extractBits: the 8x8 cells (border included) of the candidate, 1
    where more than half of a cell's pixels are white after Otsu; all 0 or
    all 1 when the inner region is too flat for Otsu."""
    cells = MARKER_SIZE + 2 * BORDER_BITS
    img = marker_warp(gray, corners)
    half = CELL_PIXELS // 2
    inner = img[half:-half, half:-half].astype(np.float64)
    mean = inner.mean()
    std = np.sqrt(max((inner * inner).mean() - mean * mean, 0.0))
    if std < MIN_OTSU_STD_DEV:
        return np.full((cells, cells), 1 if mean > 127 else 0, np.uint8)
    binary = img > otsu_threshold(img)
    margin = int(CELL_MARGIN_RATE * CELL_PIXELS)
    side = CELL_PIXELS - 2 * margin
    bits = np.zeros((cells, cells), np.uint8)
    for y in range(cells):
        for x in range(cells):
            y0, x0 = y * CELL_PIXELS + margin, x * CELL_PIXELS + margin
            bits[y, x] = binary[y0:y0 + side, x0:x0 + side].sum() > side * side // 2
    return bits


def border_errors(bits: np.ndarray) -> int:
    b = BORDER_BITS
    ring = np.ones(bits.shape, bool)
    ring[b:-b, b:-b] = False
    return int(bits[ring].sum())


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Dictionary::getByteListFromBits, rotation 0: the 6x6 bits row-major,
    8 to a byte, the last byte holding the last 4 bits in its low nibble."""
    flat = bits.ravel().astype(np.uint8)
    out = np.zeros(-(-flat.size // 8), np.uint8)
    for i, bit in enumerate(flat):
        out[i // 8] = ((int(out[i // 8]) << 1) | int(bit)) & 0xFF
    return out


def unpack_bits(packed: np.ndarray) -> np.ndarray:
    """Dictionary::getBitsFromByteList: 6x6 bits of one rotation's bytes."""
    n = MARKER_SIZE * MARKER_SIZE
    bits = []
    for i, byte in enumerate(packed):
        width = 8 if 8 * (i + 1) <= n else n - 8 * i
        bits += [(int(byte) >> (width - 1 - k)) & 1 for k in range(width)]
    return np.array(bits, np.uint8).reshape(MARKER_SIZE, MARKER_SIZE)


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.bitwise_xor(a, b), axis=-1).sum(axis=-1)


def identify(bits: np.ndarray):
    """Dictionary::identify: the first marker (by id) within
    int(5 * 0.6) bits of the candidate in one of its rotations -> (id,
    rotation of the least distance), or None."""
    dist = _hamming(DICTIONARY, pack_bits(bits)[None, None])  # [100, 4]
    ok = np.nonzero(dist.min(axis=1) <= int(MAX_CORRECTION_BITS * ERROR_CORRECTION_RATE))[0]
    if not len(ok):
        return None
    m = int(ok[0])
    return m, int(np.argmin(dist[m]))


def identify_candidate(gray: np.ndarray, corners: np.ndarray):
    """_identifyOneCandidate -> (id, rotation) or None."""
    bits = extract_bits(gray, corners)
    if border_errors(bits) > int(MARKER_SIZE * MARKER_SIZE * MAX_BORDER_ERROR_RATE):
        return None
    return identify(bits[BORDER_BITS:-BORDER_BITS, BORDER_BITS:-BORDER_BITS])


def identify_candidates(gray: np.ndarray, cands: list) -> tuple:
    """identifyCandidates: candidates are read innermost first (by depth);
    a candidate that fails tries its group's farther members; once every
    candidate is accounted for (a valid one accounts for its parents), the
    rest are not read. -> (corners list, ids, rejected corners list), the
    accepted corners turned so the first is the marker's top-left."""
    n = len(cands)
    result = [None] * n
    visited = np.zeros(n, bool)
    by_depth: dict[int, list[int]] = {}
    for i, c in enumerate(cands):
        by_depth.setdefault(c.depth, []).append(i)
    depth = counter = 0
    while counter < n:
        level = by_depth.get(depth, [])
        for v in level:
            visited[v] = True
            found = identify_candidate(gray, cands[v].corners)
            if found is None:
                for corners, contour in cands[v].close:
                    found = identify_candidate(gray, corners)
                    if found is not None:
                        cands[v].corners, cands[v].contour = corners, contour
                        break
            result[v] = found
        for v in level:
            if result[v] is not None:
                p = cands[v].parent
                while p != -1:
                    if not visited[p]:
                        visited[p] = True
                        counter += 1
                    p = cands[p].parent
            counter += 1
        depth += 1
    corners, ids, rejected = [], [], []
    for c, found in zip(cands, result):
        if found is None:
            rejected.append(c.corners)
        else:
            marker, rot = found
            corners.append(np.roll(c.corners, rot, axis=0))
            ids.append(marker)
    return corners, np.array(ids, np.int32), rejected


def gray_and_maps(color, device) -> tuple:
    """The device stage: (gray u8 [H, W], threshold maps u8 [3, H, W]) of a
    BGR u8 [H, W, 3] or gray [H, W] frame, computed on `device` and
    returned to the host."""
    gray_t = to_gray(torch.as_tensor(np.asarray(color)).to(device))
    maps = threshold_maps(gray_t).cpu().numpy()
    return gray_t.cpu().numpy(), maps


def detect_from_maps(gray: np.ndarray, maps: np.ndarray, timer=None) -> tuple:
    """ArucoDetector(DICT_6X6_100).detectMarkers after the device stage
    (`gray_and_maps`), on the host: (corners, a list of float32 [4, 2];
    ids, int32 [N]; rejected, a list of float32 [4, 2]). `timer`
    (utils/profiling.StageTimer), when given, times the "contours" and
    "identify" stages."""
    with maybe_stage(timer, "contours"):
        found = []
        for m in maps:
            found += [(clockwise(c), ct) for c, ct in marker_candidates(m)]
    with maybe_stage(timer, "identify"):
        cands = group_candidates(found, *gray.shape)
        return identify_candidates(gray, cands)


# -- the board -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridBoard:
    """cv2.aruco.GridBoard(size, marker_length, separation, DICT_6X6_100)
    with ids 0, 1, ...: markers row by row from the top left, each with
    its corners clockwise from its top-left, z = 0."""

    size: tuple  # (markers across, markers down)
    marker_length: float
    separation: float

    @property
    def ids(self) -> np.ndarray:
        return np.arange(self.size[0] * self.size[1], dtype=np.int32)

    def obj_points(self) -> np.ndarray:
        """board.getObjPoints(): float32 [markers, 4, 3]."""
        step = np.float32(self.marker_length + self.separation)
        length = np.float32(self.marker_length)
        pts = []
        for y in range(self.size[1]):
            for x in range(self.size[0]):
                c0 = np.float32([x * step, y * step, 0])
                pts.append([c0, c0 + [length, 0, 0], c0 + [length, length, 0], c0 + [0, length, 0]])
        return np.array(pts, np.float32)

    def generate_image(self, out_size: tuple, margin: int = 0) -> np.ndarray:
        """board.generateImage(out_size, marginSize=margin): u8 [H, W]
        (out_size is (width, height)). OpenCV 5 stretches the board over the
        area inside the margin, each axis on its own, and draws each marker,
        the nearest-neighbour resize of its cells to the lesser of its
        stretched sides, from its top-left corner."""
        width, height = out_size
        img = np.full((height, width), 255, np.uint8)
        zone = img[margin:height - margin, margin:width - margin]
        rows, cols = zone.shape
        obj = self.obj_points()
        min_x, min_y = obj[..., 0].min(), obj[..., 1].min()
        size_x, size_y = np.float32(obj[..., 0].max() - min_x), np.float32(obj[..., 1].max() - min_y)

        def place(p):
            return (np.float32(np.float32(p[0] - min_x) / size_x * np.float32(cols)),
                    np.float32(np.float32(p[1] - min_y) / size_y * np.float32(rows)))

        for marker, corners in zip(self.ids, obj):
            (x0, y0), (x2, y2) = place(corners[0]), place(corners[2])
            side = min(int(np.rint(x2 - x0)), int(np.rint(y2 - y0)))
            top, left = int(np.rint(y0)), int(np.rint(x0))
            zone[top:top + side, left:left + side] = marker_image(int(marker), side)
        return img


def marker_image(marker: int, side: int) -> np.ndarray:
    """Dictionary::generateImageMarker: the marker's cells (a black border
    of one cell) resized to side x side by nearest neighbour."""
    cells = MARKER_SIZE + 2 * BORDER_BITS
    tiny = np.zeros((cells, cells), np.uint8)
    tiny[BORDER_BITS:-BORDER_BITS, BORDER_BITS:-BORDER_BITS] = unpack_bits(DICTIONARY[marker, 0]) * 255
    inv = 1.0 / (side / cells)
    idx = np.minimum(np.floor(np.arange(side) * inv).astype(np.int64), cells - 1)
    return tiny[idx][:, idx]


def match_image_points(board: GridBoard, corners: list, ids) -> tuple:
    """board.matchImagePoints(corners, ids): (object points float32 [4N, 3],
    image points float32 [4N, 2]) of the detected markers on the board,
    in detection order."""
    obj = board.obj_points()
    board_ids = list(board.ids)
    obj_pts, img_pts = [], []
    for c, marker in zip(corners, np.asarray(ids).ravel()):
        if marker in board_ids:
            j = board_ids.index(marker)
            obj_pts += list(obj[j])
            img_pts += list(np.asarray(c, np.float32).reshape(4, 2))
    return np.array(obj_pts, np.float32).reshape(-1, 3), np.array(img_pts, np.float32).reshape(-1, 2)


def refine_detected_markers(gray: np.ndarray, board: GridBoard, corners: list, ids, rejected: list,
                            camera: np.ndarray, distortion) -> tuple:
    """ArucoDetector.refineDetectedMarkers with a camera: the board pose
    from the detected markers (solvePnP) projects each missing marker; the
    rejected candidate whose corners (in the best of its four turns) all
    lie within 10 px of a projection and whose bits are within 15 of the
    marker's becomes that marker. -> (corners, ids, rejected, recovered
    indexes into the rejected list)."""
    ids = np.asarray(ids, np.int32).ravel()
    if len(ids) == 0 or len(rejected) == 0:
        return corners, ids, rejected, []
    obj, img = match_image_points(board, corners, ids)
    if len(obj) < 4:
        return corners, ids, rejected, []
    rvec, tvec = solve_pnp(obj, img, camera, distortion)
    missing = [(int(m), o) for m, o in zip(board.ids, board.obj_points()) if m not in ids]
    max_corr = int(MAX_CORRECTION_BITS * REFINE_ERROR_CORRECTION_RATE)
    used = np.zeros(len(rejected), bool)
    corners = list(corners)
    ids = list(ids)
    recovered = []
    for marker, obj_pts in missing:
        projected = project_points(obj_pts.astype(np.float64), rvec, tvec, camera, distortion).astype(np.float32)
        best, best_dist, best_corners = -1, REFINE_MIN_REP_DISTANCE ** 2 + 1, None
        for j, rej in enumerate(rejected):
            if used[j]:
                continue
            valid, rot, min_dist = False, 0, best_dist + 1
            for c in range(4):
                d = projected - np.roll(rej, -c, axis=0)  # float32, as OpenCV's Point2f
                dist = float((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).max())
                if dist < best_dist:
                    valid, rot, min_dist = True, c, dist
            if not valid:
                continue
            turned = np.roll(rej, -rot, axis=0)
            bits = extract_bits(gray, turned)[BORDER_BITS:-BORDER_BITS, BORDER_BITS:-BORDER_BITS]
            if int(_hamming(DICTIONARY[marker, 0], pack_bits(bits))) < max_corr:
                best, best_dist, best_corners = j, min_dist, turned
        if best >= 0:
            used[best] = True
            corners.append(best_corners)
            ids.append(marker)
            recovered.append(best)
    rejected = [r for r, u in zip(rejected, used) if not u]
    return corners, np.array(ids, np.int32), rejected, recovered
