"""Similarity scans: the CUDA kernels' wrappers and their plain PyTorch twins
(counterpart of `linemod_tpu/ops/similarity_pallas.py`).

- `coarse_scores(planes, off3, ch, cw)` -> int32 [N, ch, cw]: every template
  at every coarse grid cell.
- `coarse_max(planes, off3, lim, ch, cw)` -> int32 [N]: each template's
  masked max of the coarse scores over the cells where it fits, -1 where it
  fits nowhere (phase 1 of the large-bank prefiltered cut).
- `fine_scores(planes, off3, cand_t, base_yx, win)` -> int32 [K, win, win]:
  each candidate's template over the window at its fine-grid origin.

A wrapper given CUDA tensors launches its kernel from `csrc/similarity.cu`
or raises; given CPU tensors it runs the plain version, which is also what
the CPU tests hold the JAX reference against. Each kernel launch adds one
to the wrapper's `launches` count. `ops/cuda_lib.py` builds the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

# cap on the int64 gather-index tensor of one chunk of the plain versions
_INDEX_BYTES = 64 * 1024 * 1024
# templates per chunk of coarse_max_plain's masked max
_MAX_CHUNK = 4096
_INT32_MAX = 2**31 - 1
_MAX_COARSE_CELLS = 65535 * 256  # grid.y limit x cells per coarse block


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
_SIGNATURES = {
    "coarse_scores": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    "coarse_max": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    "fine_scores": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _P, _P],
}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load `csrc/similarity.cu`."""
    return cuda_lib.load("similarity", _SIGNATURES)


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


# --------------------------------------------------------------- wrappers ---

def coarse_scores(planes, off3, ch: int, cw: int) -> torch.Tensor:
    """int32 [N, ch, cw] coarse scores of every template at every cell.

    planes: uint8 [P+1, rows, stride]; off3: int32 [N, F, 3] (plane, sy, sx)
    with sy + ch <= rows and sx + cw <= stride for every feature."""
    _check_planes(planes, off3)
    if ch > planes.shape[1] or cw > planes.shape[2] or ch * cw > _MAX_COARSE_CELLS:
        raise ValueError(f"grid {ch}x{cw} unsupported for planes {tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return coarse_scores_plain(planes, off3, ch, cw)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    n, f, _ = off3.shape
    out = torch.empty((n, ch, cw), dtype=torch.int32, device=planes.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(planes.device):
        err = lib.coarse_scores(
            planes.data_ptr(), planes.shape[1], planes.shape[2],
            off3.data_ptr(), n, f, ch, cw, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check_launch("coarse_scores", err)
    coarse_scores.launches += 1
    return out


coarse_scores.launches = 0


def coarse_max(planes, off3, lim, ch: int, cw: int) -> torch.Tensor:
    """int32 [N]: each template's max coarse score over the cells where it
    fits (gy < min(lim[n, 0], ch), gx < min(lim[n, 1], cw)), -1 where none does.

    planes, off3, ch, cw as for coarse_scores; lim: int32 [N, 2]."""
    _check_planes(planes, off3)
    _check_tensor("lim", lim, torch.int32, 2, planes.device)
    n, f, _ = off3.shape
    if lim.shape != (n, 2):
        raise ValueError(f"lim must be [{n}, 2], got {tuple(lim.shape)}")
    if not (0 <= ch <= planes.shape[1] and 0 <= cw <= planes.shape[2]):
        raise ValueError(f"grid {ch}x{cw} unsupported for planes {tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return coarse_max_plain(planes, off3, lim, ch, cw)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    out = torch.empty((n,), dtype=torch.int32, device=planes.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(planes.device):
        err = lib.coarse_max(
            planes.data_ptr(), planes.shape[1], planes.shape[2],
            off3.data_ptr(), lim.data_ptr(), n, f, ch, cw, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check_launch("coarse_max", err)
    coarse_max.launches += 1
    return out


coarse_max.launches = 0


def fine_scores(planes, off3, cand_t, base_yx, win: int) -> torch.Tensor:
    """int32 [K, win, win] fine scores of candidate k's template cand_t[k] over
    the window at fine-grid origin base_yx[k] = (y, x).

    planes: uint8 [P+1, rows, stride]; off3: int32 [N, F, 3];
    cand_t: int32 [K] in [0, N); base_yx: int32 [K, 2]."""
    _check_planes(planes, off3)
    _check_tensor("cand_t", cand_t, torch.int32, 1, planes.device)
    _check_tensor("base_yx", base_yx, torch.int32, 2, planes.device)
    k = cand_t.shape[0]
    if base_yx.shape != (k, 2):
        raise ValueError(f"base_yx must be [{k}, 2], got {tuple(base_yx.shape)}")
    if not 1 <= win <= 32:
        raise ValueError(f"window {win} outside 1..32")
    if planes.device.type == "cpu":
        return fine_scores_plain(planes, off3, cand_t, base_yx, win)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    out = torch.empty((k, win, win), dtype=torch.int32, device=planes.device)
    if k == 0:
        return out
    lib = load_library()
    with torch.cuda.device(planes.device):
        err = lib.fine_scores(
            planes.data_ptr(), planes.shape[1], planes.shape[2],
            off3.data_ptr(), off3.shape[1], cand_t.data_ptr(),
            base_yx.data_ptr(), k, win, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check_launch("fine_scores", err)
    fine_scores.launches += 1
    return out


fine_scores.launches = 0
