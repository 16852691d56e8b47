"""Similarity scans: the CUDA kernels' wrappers and their plain PyTorch twins
(counterpart of `linemod_tpu/ops/similarity_pallas.py`).

- `coarse_scores(planes, off3, ch, cw, plan)` -> int32 [N, ch, cw]: every
  template at every coarse grid cell.
- `coarse_max(planes, off3, lim, ch, cw, plan)` -> int32 [N]: each
  template's masked max of the coarse scores over the cells where it fits,
  -1 where it fits nowhere (phase 1 of the large-bank prefiltered cut).
  The two share one kernel body and one plan: `coarse_max_plan` builds it
  (features sorted by plane into per-chunk buckets) once per match state,
  and `CoarseMaxPlan.take_rows` cuts it to a subset of the templates on the
  device.
- `fine_scores(planes, off3, cand_t, base_yx, win)` -> int32 [K, win, win]:
  each candidate's template over the window at its fine-grid origin.

A wrapper given CUDA tensors launches its kernel from `csrc/similarity.cu`
or raises; given CPU tensors it runs the plain version, which is also what
the CPU tests hold the JAX reference against. Each kernel launch adds one
to the wrapper's `launches` count. `ops/cuda_lib.py` builds the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import cuda_lib

# cap on the int64 gather-index tensor of one chunk of the plain versions
_INDEX_BYTES = 64 * 1024 * 1024
# templates per chunk of coarse_max_plain's masked max
_MAX_CHUNK = 4096
_INT32_MAX = 2**31 - 1


def feature_plane_triplets(feats, valids, t, zero_plane_idx):
    """Per-feature (plane, sy, sx) int32 triplets for the similarity kernels.

    feats: [N, 64, 3] (x, y, ori) bbox-relative at one pyramid level;
    invalid features map to the all-zero plane at `zero_plane_idx`."""
    xs = feats[:, :, 0].astype(np.int64)
    ys = feats[:, :, 1].astype(np.int64)
    oris = feats[:, :, 2].astype(np.int64)
    plane = (oris * t + ys % t) * t + xs % t
    sy = ys // t
    sx = xs // t
    trip = np.stack([plane, sy, sx], axis=-1)
    trip = np.where(valids[:, :, None], trip, np.array([zero_plane_idx, 0, 0]))
    return trip.astype(np.int32)


# ---------------------------------------------------------------- build ---

_P, _I = ctypes.c_void_p, ctypes.c_int
_GEOMETRY = ctypes.c_int * 7
_SIGNATURES = {
    "coarse_scores": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _GEOMETRY, _I, _P, _P],
    "coarse_scores_clusters": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "coarse_max": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _GEOMETRY, _P, _P],
    "fine_scores": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load `csrc/similarity.cu`."""
    return cuda_lib.load("similarity", _SIGNATURES)


def _launch(fn: str, device, *args) -> None:
    cuda_lib.launch("similarity", _SIGNATURES, fn, device, *args)


def _check_tensor(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name}: want {dtype} with {ndim} dims, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, planes on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_planes(planes, off3):
    _check_tensor("planes", planes, torch.uint8, 3, planes.device)
    _check_tensor("off3", off3, torch.int32, 3, planes.device)
    if off3.shape[2] != 3:
        raise ValueError(f"off3 must be [N, F, 3], got {tuple(off3.shape)}")
    if planes.numel() > _INT32_MAX:
        raise ValueError("planes exceed int32 offsets")


# ------------------------------------------------------------ plain twins ---

def _flat_offsets(planes: torch.Tensor, off3: torch.Tensor) -> torch.Tensor:
    """(plane, sy, sx) triplets -> int64 offsets into planes.reshape(-1)."""
    rows, stride = planes.shape[1], planes.shape[2]
    o = off3.long()
    return (o[..., 0] * rows + o[..., 1]) * stride + o[..., 2]


def _gather_sum(flat, off, pos):
    """sum_f flat[off[r, f] + pos[r or 0, s]] -> int32 [R, S], chunked over R."""
    r, f = off.shape
    s = pos.shape[1]
    out = torch.empty((r, s), dtype=torch.int32, device=flat.device)
    chunk = max(1, _INDEX_BYTES // (8 * f * s))
    for c0 in range(0, r, chunk):
        p = pos if pos.shape[0] == 1 else pos[c0 : c0 + chunk]
        idx = off[c0 : c0 + chunk, :, None] + p[:, None, :]
        out[c0 : c0 + chunk] = flat[idx].sum(dim=1, dtype=torch.int32)
    return out


def coarse_scores_plain(planes, off3, ch: int, cw: int) -> torch.Tensor:
    """Plain PyTorch coarse scan: a template-chunked gather over the flat
    planes (the XLA gather branch of linemod_tpu/ops/matching.py:344-358)."""
    stride = planes.shape[2]
    dev = planes.device
    grid = (
        torch.arange(ch, device=dev)[:, None] * stride
        + torch.arange(cw, device=dev)[None, :]
    ).reshape(1, -1)
    scores = _gather_sum(planes.reshape(-1), _flat_offsets(planes, off3), grid)
    return scores.reshape(-1, ch, cw)


def coarse_max_plain(planes, off3, lim, ch: int, cw: int) -> torch.Tensor:
    """Plain PyTorch masked max: the chunked coarse scan, then each
    template's max over the cells with gy < lim[n, 0] and gx < lim[n, 1],
    -1 where no cell fits (the dense form of coarse_max_pallas,
    linemod_tpu/ops/similarity_pallas.py:159)."""
    n = off3.shape[0]
    dev = planes.device
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if ch * cw == 0:
        return out
    gy = torch.arange(ch, device=dev)[None, :, None]
    gx = torch.arange(cw, device=dev)[None, None, :]
    for c0 in range(0, n, _MAX_CHUNK):
        scores = coarse_scores_plain(planes, off3[c0 : c0 + _MAX_CHUNK], ch, cw)
        lim_c = lim[c0 : c0 + _MAX_CHUNK, :, None, None]
        fits = (gy < lim_c[:, 0]) & (gx < lim_c[:, 1])
        out[c0 : c0 + _MAX_CHUNK] = torch.where(fits, scores, -1).flatten(1).amax(dim=1)
    return out


def fine_scores_plain(planes, off3, cand_t, base_yx, win: int) -> torch.Tensor:
    """Plain PyTorch fine refine (linemod_tpu/ops/matching.py:635-644)."""
    stride = planes.shape[2]
    dev = planes.device
    sub = (
        torch.arange(win, device=dev)[:, None] * stride
        + torch.arange(win, device=dev)[None, :]
    ).reshape(-1)
    base = base_yx[:, 0].long() * stride + base_yx[:, 1].long()
    off = _flat_offsets(planes, off3[cand_t.long()])
    scores = _gather_sum(planes.reshape(-1), off, base[:, None] + sub[None, :])
    return scores.reshape(-1, win, win)


# ------------------------------------------------ the coarse kernels' plan ---

# the coarse kernel's constants (csrc/similarity.cu): shared memory per
# chunk (kStageBytes), the cells of one warp's unit (32 rows x 8 * kItems
# columns), units per block of the masked max and of the scan (kMaxUnits,
# kScanUnits), features (u16 sums of bytes <= 7), blocks sharing a group in
# the scan (kMaxSplit), the scan's partial sums a block (kPartItems, as
# bytes)
STAGE_BYTES = 180 * 1024
_UNIT_ROWS, _UNIT_COLS = 32, 8 * 5
UNITS_PER_BLOCK = 16 * 3
SCAN_UNITS_PER_BLOCK = 16 * 2
_MAX_FEATURES = 8192
MAX_SPLIT = 8
_PARTIAL_BYTES = SCAN_UNITS_PER_BLOCK * _UNIT_ROWS * _UNIT_COLS * 2


@dataclasses.dataclass(frozen=True, eq=False)
class CoarseMaxPlan:
    """The coarse kernel's view of a bank at one plane geometry (the scan
    and the masked max take the same plan).

    A template's cells are cut into row_bands x col_bands bands of 32 rows
    x 40 columns, one unit of warp work each; a block takes UNITS_PER_BLOCK
    (the masked max) or SCAN_UNITS_PER_BLOCK (the scan) templates of one
    band (the groups are band-major). The kernel walks the
    planes in `chunks` chunks of `chunk_planes` consecutive planes; of each
    plane it stages the rectangle its band reaches, rows [row0, row0 +
    stage_rows) and 4 * pitch bytes of each row from the band's first column
    rounded down to 16 bytes (bytes past the planes read as 0), into shared
    memory, one rectangle after the other. feat [N, F] holds each template's
    features on planes below the trailing zero plane, sorted by plane, as
    byte offsets into their chunk's staged rectangles, relative to the
    band's corner; chunk c's bucket is feat[t, starts[t, c]:starts[t, c + 1]].
    Features on the trailing plane add 0 and are left out."""

    off3: torch.Tensor  # the triplets it was built from
    version: int  # off3._version then
    planes_shape: tuple  # (P + 1, rows, stride)
    grid: tuple  # (ch, cw)
    feat: torch.Tensor
    starts: torch.Tensor
    stage_rows: int
    pitch: int  # 32-bit words a staged row; odd, so a warp's 32 rows hit 32 banks
    chunk_planes: int
    chunks: int
    row_bands: int
    col_bands: int

    @property
    def geometry(self) -> tuple:
        """The kernel's geometry argument."""
        return (self.planes_shape[0] - 1, self.stage_rows, self.pitch, self.chunk_planes,
                self.chunks, self.row_bands, self.col_bands)

    def groups(self, units: int = UNITS_PER_BLOCK) -> int:
        """Groups of `units` templates of one band: the masked max's blocks
        (the scan's with SCAN_UNITS_PER_BLOCK, before its split)."""
        return self.row_bands * self.col_bands * -(-self.feat.shape[0] // units)

    def staged_bytes(self, units: int = UNITS_PER_BLOCK) -> tuple[int, int]:
        """(bytes one group stages, bytes all groups stage): what the kernel
        reads from L2 for the planes, whatever the scan's split."""
        group = (self.planes_shape[0] - 1) * self.stage_rows * 4 * self.pitch
        return group, group * self.groups(units)

    def scan_smem(self) -> int:
        """The scan's dynamic shared memory a block: the stage, or the
        partial sums where they are larger."""
        return max(4 * self.chunk_planes * self.stage_rows * self.pitch, _PARTIAL_BYTES)

    def take_rows(self, rows, off3: torch.Tensor) -> "CoarseMaxPlan":
        """The plan of the templates `rows` (a slice or an index tensor on the
        plan's device), whose triplets are off3 (= the bank's off3[rows]).
        The bank's geometry covers every subset, so this is feat[rows] and
        starts[rows], cut on the device: no copy to the host, no sync."""
        feat, starts = self.feat[rows], self.starts[rows]
        if off3.shape[:2] != feat.shape:
            raise ValueError(f"off3 {tuple(off3.shape)} is not the plan's rows {tuple(feat.shape)}")
        return dataclasses.replace(self, off3=off3, version=off3._version, feat=feat, starts=starts)

    def check(self, planes, off3, ch: int, cw: int) -> None:
        if off3 is not self.off3 or off3._version != self.version:
            raise ValueError("the plan was built for other triplets")
        if tuple(planes.shape) != self.planes_shape or (ch, cw) != self.grid:
            raise ValueError(
                f"the plan is for planes {self.planes_shape} and grid {self.grid}, "
                f"got {tuple(planes.shape)} and {(ch, cw)}"
            )


def coarse_max_plan(off3: torch.Tensor, planes_shape, ch: int, cw: int) -> CoarseMaxPlan:
    """Build the CoarseMaxPlan of int32 [N, F, 3] triplets for planes of
    shape planes_shape = (P + 1, rows, stride) and a ch x cw grid, on
    off3's device. Raises ValueError where a triplet reaches outside the
    planes or one plane's staged rectangle exceeds STAGE_BYTES."""
    n_planes, rows, stride = (int(v) for v in planes_shape)
    if ch * cw == 0:
        raise ValueError("the grid is empty")
    zero = n_planes - 1
    o = off3.cpu().numpy().astype(np.int64)
    n, f = o.shape[:2]
    p, sy, sx = o[..., 0], o[..., 1], o[..., 2]
    if o.size and (
        p.min() < 0 or p.max() > zero or sy.min() < 0 or sx.min() < 0
        or sy.max() + ch > rows or sx.max() + cw > stride
    ):
        raise ValueError(f"triplets reach outside planes {tuple(planes_shape)} on a {ch}x{cw} grid")
    keep = p < zero
    max_sy = int(sy[keep].max()) if keep.any() else 0
    max_sx = int(sx[keep].max()) if keep.any() else 0
    row_bands = -(-ch // _UNIT_ROWS)
    col_bands = -(-cw // _UNIT_COLS)
    stage_rows = min(ch, _UNIT_ROWS) + max_sy
    # a band's columns start 0 or 8 bytes into its stage (40 * b rounded
    # down to 16); its last item, at x0, reads 3 words from ((x0 + sx) & ~3)
    last_x0 = (8 if col_bands > 1 else 0) + _UNIT_COLS - 8
    pitch = (((last_x0 + max_sx) & ~3) + 12) // 4 | 1
    rect = stage_rows * 4 * pitch
    if rect > STAGE_BYTES:
        raise ValueError(
            f"one plane's staged rectangle ({stage_rows} x {4 * pitch} = {rect} B) exceeds "
            f"the kernel's {STAGE_BYTES} B of shared memory"
        )
    chunks = -(-zero // (STAGE_BYTES // rect))
    chunk_planes = -(-zero // chunks) if chunks else 1
    chunk = np.where(keep, p // chunk_planes, chunks)
    local = np.where(keep, (p - chunk * chunk_planes) * rect + sy * 4 * pitch + sx, 0)
    order = np.argsort(np.where(keep, p, n_planes), axis=1, kind="stable")
    feat = np.take_along_axis(local, order, axis=1)
    cell = (np.arange(n)[:, None] * (chunks + 1) + chunk).reshape(-1)
    counts = np.bincount(cell, minlength=n * (chunks + 1)).reshape(n, chunks + 1)
    starts = np.zeros((n, chunks + 1), np.int64)
    starts[:, 1:] = np.cumsum(counts[:, :chunks], axis=1)
    dev = off3.device
    return CoarseMaxPlan(
        off3=off3, version=off3._version, planes_shape=(n_planes, rows, stride), grid=(ch, cw),
        feat=torch.from_numpy(feat.astype(np.int32)).to(dev),
        starts=torch.from_numpy(starts.astype(np.int32)).to(dev),
        stage_rows=stage_rows, pitch=pitch, chunk_planes=chunk_planes, chunks=chunks,
        row_bands=row_bands, col_bands=col_bands,
    )


# ------------------------------------------------ the fine kernel's layout ---

# the fine kernel's constants (csrc/similarity.cu): warps a block (at most
# kFineMaxWarps, 8), features a lane adds into byte lanes
# between flushes (kFineFlush), features at most (kFineMaxFeatures: u16
# totals of bytes <= 7); the warp takes its template's features in batches
# of FINE_BATCH (kFineBatch), one triplet a lane
FINE_WARPS = 4
FINE_FLUSH = 32
FINE_BATCH = 32


def fine_layout(win: int) -> tuple[int, int]:
    """(lanes_row, slices): the fine kernel's lanes at window `win`
    (fine_kernel<L, S>). A window row's W = ceil(win / 4) result words need
    W + 1 aligned plane words, held by lanes_row lanes, the least power of
    two >= W + 1; a warp holds 32 // lanes_row rows. A warp takes half the
    window's rows rounded up to a power of two (at least 1, at most what it
    holds), so a candidate takes two warps from windows 2 to 8 (measured
    faster than one at 1280x960 and the dual shape, no slower at the
    fixture and K=2,048); the warp's rows are split into `slices` slices
    that take every slices-th feature of a batch. Lane = (slice *
    rows_a_slice + row) * lanes_row + word; a candidate takes
    ceil(win / rows_a_slice) warps."""
    if not 1 <= win <= 32:
        raise ValueError(f"window {win} outside 1..32")
    lanes_row = 1 << (-(-win // 4)).bit_length()
    rows = min(32 // lanes_row, max(1, (1 << (win - 1).bit_length()) // 2))
    return lanes_row, 32 // lanes_row // rows


# --------------------------------------------------------------- wrappers ---

_active_clusters: dict[tuple, int] = {}


def active_clusters(device, split: int, smem: int) -> int:
    """Clusters of `split` scan blocks with `smem` bytes of shared memory each
    that the card runs at once (cudaOccupancyMaxActiveClusters), cached."""
    key = (device.index, split, smem)
    if key not in _active_clusters:
        active = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = load_library().coarse_scores_clusters(split, smem, ctypes.byref(active))
        cuda_lib.check_launch("coarse_scores_clusters", err)
        _active_clusters[key] = active.value
    return _active_clusters[key]


_splits: dict[tuple, int] = {}


def coarse_split(plan: CoarseMaxPlan, device) -> int:
    """Blocks a group of the scan: the S <= MAX_SPLIT that needs the fewest
    rounds of resident clusters times chunks a block; on a tie the fewest
    rounds (each round pays its own combine), then the largest S (each block
    combines 1/S of the cells). At 2,048 templates (64 groups) S = 1 would
    leave half the 132 SMs idle. Cached by the numbers it reads."""
    groups, smem = plan.groups(SCAN_UNITS_PER_BLOCK), plan.scan_smem()
    key = (device.index, groups, plan.chunks, smem)
    if key not in _splits:
        costs = {}
        for s in range(1, min(MAX_SPLIT, max(plan.chunks, 1)) + 1):
            active = active_clusters(device, s, smem)
            if active:
                rounds = -(-groups // active)
                costs[s] = (rounds * -(-plan.chunks // s), rounds, -s)
        _splits[key] = min(costs, key=costs.get, default=1)
    return _splits[key]


def coarse_scores(planes, off3, ch: int, cw: int, plan=None) -> torch.Tensor:
    """int32 [N, ch, cw] coarse scores of every template at every cell.

    planes: uint8 [P+1, rows, stride]; off3: int32 [N, F, 3] (plane, sy, sx)
    with sy + ch <= rows and sx + cw <= stride for every feature. plan: the
    CoarseMaxPlan of off3 at this geometry (the match state's, or one cut
    from it by take_rows); without one, a launch builds it first, which
    copies off3 to the host. The kernel leaves out features on the trailing
    plane, which must be all zero (it is: invalid features point there), and
    is exact for plane bytes up to 7 (responses are 0..4) and F <= 8192.
    Raises ValueError where one plane's staged rectangle exceeds
    STAGE_BYTES (coarse_max_plan)."""
    _check_planes(planes, off3)
    if not (0 <= ch <= planes.shape[1] and 0 <= cw <= planes.shape[2]):
        raise ValueError(f"grid {ch}x{cw} unsupported for planes {tuple(planes.shape)}")
    if plan is not None:
        plan.check(planes, off3, ch, cw)
    if planes.device.type == "cpu":
        return coarse_scores_plain(planes, off3, ch, cw)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    n, f, _ = off3.shape
    _check_coarse_kernel(planes, f)
    out = torch.empty((n, ch, cw), dtype=torch.int32, device=planes.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    _launch(
        "coarse_scores", planes.device, planes.data_ptr(), planes.shape[1], planes.shape[2],
        plan.feat.data_ptr(), plan.starts.data_ptr(), n, f, ch, cw,
        _GEOMETRY(*plan.geometry), coarse_split(plan, planes.device), out.data_ptr(),
    )
    coarse_scores.launches += 1
    return out


coarse_scores.launches = 0


def _check_coarse_kernel(planes, f: int) -> None:
    if f > _MAX_FEATURES:
        raise ValueError(f"the coarse kernel takes at most {_MAX_FEATURES} features, got {f}")
    if planes.shape[2] % 16 or planes.data_ptr() % 16:
        raise ValueError("the coarse kernel loads 16-byte words: the planes' stride and address must be multiples of 16")


def coarse_max(planes, off3, lim, ch: int, cw: int, plan=None) -> torch.Tensor:
    """int32 [N]: each template's max coarse score over the cells where it
    fits (gy < min(lim[n, 0], ch), gx < min(lim[n, 1], cw)), -1 where none does.

    planes, off3, ch, cw, plan and the kernel's limits as for coarse_scores;
    lim: int32 [N, 2]."""
    _check_planes(planes, off3)
    _check_tensor("lim", lim, torch.int32, 2, planes.device)
    n, f, _ = off3.shape
    if lim.shape != (n, 2):
        raise ValueError(f"lim must be [{n}, 2], got {tuple(lim.shape)}")
    if not (0 <= ch <= planes.shape[1] and 0 <= cw <= planes.shape[2]):
        raise ValueError(f"grid {ch}x{cw} unsupported for planes {tuple(planes.shape)}")
    if plan is not None:
        plan.check(planes, off3, ch, cw)
    if planes.device.type == "cpu":
        return coarse_max_plain(planes, off3, lim, ch, cw)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    _check_coarse_kernel(planes, f)
    out = torch.full((n,), -1, dtype=torch.int32, device=planes.device)
    if n == 0 or ch * cw == 0:
        return out
    if plan is None:
        plan = coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    _launch(
        "coarse_max", planes.device, planes.data_ptr(), planes.shape[1], planes.shape[2],
        plan.feat.data_ptr(), plan.starts.data_ptr(), lim.data_ptr(), n, f, ch, cw,
        _GEOMETRY(*plan.geometry), out.data_ptr(),
    )
    coarse_max.launches += 1
    return out


coarse_max.launches = 0


def fine_scores(planes, off3, cand_t, base_yx, win: int) -> torch.Tensor:
    """int32 [K, win, win] fine scores of candidate k's template cand_t[k] over
    the window at fine-grid origin base_yx[k] = (y, x).

    planes: uint8 [P+1, rows, stride]; off3: int32 [N, F, 3];
    cand_t: int32 [K] in [0, N); base_yx: int32 [K, 2]; win 1..32. The kernel
    takes a warp a group of a window's rows (FINE_WARPS warps a block, lanes
    by `fine_layout`), reads the planes as 32-bit words, so their stride and
    address must be multiples of 4, and is exact for plane bytes up to 7
    (responses are 0..4) and F <= 8192."""
    _check_planes(planes, off3)
    _check_tensor("cand_t", cand_t, torch.int32, 1, planes.device)
    _check_tensor("base_yx", base_yx, torch.int32, 2, planes.device)
    k = cand_t.shape[0]
    if base_yx.shape != (k, 2):
        raise ValueError(f"base_yx must be [{k}, 2], got {tuple(base_yx.shape)}")
    fine_layout(win)
    if planes.device.type == "cpu":
        return fine_scores_plain(planes, off3, cand_t, base_yx, win)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    f = off3.shape[1]
    if f > _MAX_FEATURES:
        raise ValueError(f"the fine kernel takes at most {_MAX_FEATURES} features, got {f}")
    if planes.shape[2] % 4 or planes.data_ptr() % 4:
        raise ValueError("the fine kernel loads 32-bit words: the planes' stride and address must be multiples of 4")
    out = torch.empty((k, win, win), dtype=torch.int32, device=planes.device)
    if k == 0:
        return out
    _launch(
        "fine_scores", planes.device, planes.data_ptr(), *planes.shape, off3.data_ptr(), f,
        cand_t.data_ptr(), base_yx.data_ptr(), k, win, FINE_WARPS, *fine_layout(win), out.data_ptr(),
    )
    fine_scores.launches += 1
    return out


fine_scores.launches = 0
