"""Template feature extraction and scattered feature selection
(counterpart of `linemod_tpu/ops/extract.py`), batched over views.

A rendered template view is quantized at two pyramid levels; the strong
candidates inside the eroded object mask are cut to the 512 best by score,
and 63 spatially scattered features are chosen greedily from that list with
a shrinking minimum distance (d, d/2, d/4, 0, d = n_candidates / 63 + 1).

The work is split in two so that generation can cut every view first and
select for all of them at once: `cut_candidates` (per level and modality,
on whole maps) and `scan_select` (one loop of 4 x 512 dependent steps over
the candidate lists of all rows, each step a few elementwise operations on
[rows] and [rows, 63] tensors). Only the [rows, 512] lists and the
[rows, 63] selections live across the scan.

Exactness with the reference, which XLA compiles on the CPU:
- the cut keeps the lower index among equal scores (lax.top_k's order),
  through a stable descending sort;
- d = n * float32(1 / 63) + 1 with the product fused into the add: XLA turns
  the division by the constant 63 into that product and contracts it;
- the squared distances are of integer pixel coordinates, hence exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .gradients import _fma, quantize_color_gradients
from .normals import quantize_normals

MAX_CANDIDATES = 512
NUM_FEATURES = 63
STRONG_THRESHOLD = 55.0
PASS_MULT = (1.0, 0.5, 0.25, 0.0)  # the minimum distance's schedule
# the index of the highest set bit of max(q, 1): a feature's orientation bin
_ORI = np.array([int(np.floor(np.log2(max(v, 1)))) for v in range(256)], np.int32)


def erode_mask(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3x3 binary erosion of [..., H, W] masks in which the image border
    does not erode inward (a max pool of the negated mask pads with -inf)."""
    h, w = mask.shape[-2:]
    m = mask.reshape(-1, 1, h, w).float()
    for _ in range(iterations):
        m = -F.max_pool2d(-m, 3, stride=1, padding=1)
    return (m > 0.5).reshape(mask.shape)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample of [H, W] or [H, W, C] float images; an odd
    last row or column is dropped, as in a VALID window. The four taps are
    summed in row-major window order, as XLA's reduce_window sums them."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    x = img[: 2 * h, : 2 * w]
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]) * 0.25


class Candidates(NamedTuple):
    """The cut candidate lists of a batch of rows (views x levels)."""

    x: torch.Tensor  # [R, 512] float32 pixel column
    y: torch.Tensor  # [R, 512] float32 pixel row
    valid: torch.Tensor  # [R, 512] bool (a finite score)
    quant: torch.Tensor  # [R, 512] uint8 quantized orientation there
    quant00: torch.Tensor  # [R] uint8 quantized orientation at pixel (0, 0)
    d0: torch.Tensor  # [R] float32 initial minimum distance


def cut_candidates(score, quantized, candidate_mask, num_features: int = NUM_FEATURES) -> Candidates:
    """The 512 best-scoring candidates of each [R, H, W] map, higher score
    first and the lower pixel index first among equal scores."""
    r, h, w = score.shape
    dev = score.device
    flat = torch.where(candidate_mask, score, -torch.inf).reshape(r, h * w)
    top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top, idx = top[:, :MAX_CANDIDATES], idx[:, :MAX_CANDIDATES]
    n_cand = candidate_mask.reshape(r, -1).sum(1).float()
    recip = torch.tensor(np.float32(1.0) / np.float32(num_features), device=dev)
    return Candidates(
        x=(idx % w).float(),
        y=(idx // w).float(),
        valid=torch.isfinite(top),
        quant=quantized.reshape(r, h * w).gather(1, idx),
        quant00=quantized[:, 0, 0],
        d0=_fma(n_cand, recip, torch.ones_like(n_cand)),
    )


def concat_candidates(parts: list) -> Candidates:
    return Candidates(*(torch.cat(f) for f in zip(*parts)))


def scan_select(c: Candidates, num_features: int = NUM_FEATURES):
    """Greedy scattered selection over every row's candidate list at once:
    4 passes over the 512 candidates in order, each taking a candidate not
    yet taken whose squared distance to every selected feature is at least
    (d * mult)^2, until `num_features` are taken. Returns (x, y, ori, valid),
    each [R, num_features] (int32, int32, int32, bool); x = y = 0 where not
    valid, and ori is then that of pixel (0, 0)."""
    rows = c.x.shape[0]
    dev = c.x.device
    selx = torch.full((rows, num_features), 1e9, dtype=torch.float32, device=dev)
    sely = torch.full_like(selx, 1e9)
    selc = torch.zeros((rows, num_features), dtype=torch.int64, device=dev)
    count = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
    taken = torch.zeros((rows, MAX_CANDIDATES), dtype=torch.bool, device=dev)
    slots = torch.arange(num_features, device=dev)[None, :]
    for mult in PASS_MULT:
        dm = c.d0 * mult
        d2 = (dm * dm)[:, None]
        for ci in range(MAX_CANDIDATES):
            x, y = c.x[:, ci : ci + 1], c.y[:, ci : ci + 1]
            dx, dy = selx - x, sely - y
            dist2 = (dx * dx + dy * dy).amin(1, keepdim=True)
            ok = c.valid[:, ci : ci + 1] & ~taken[:, ci : ci + 1] & (count < num_features) & (dist2 >= d2)
            put = (slots == count) & ok
            selx = torch.where(put, x, selx)
            sely = torch.where(put, y, sely)
            selc = torch.where(put, ci, selc)
            taken[:, ci : ci + 1] |= ok
            count = count + ok
    valid = slots < count
    x = torch.where(valid, selx, 0.0).int()
    y = torch.where(valid, sely, 0.0).int()
    q = torch.where(valid, c.quant.gather(1, selc), c.quant00[:, None])
    ori = torch.as_tensor(_ORI, device=dev)[q.long()]
    return x, y, ori, valid


def select_scattered_features(score, quantized, candidate_mask, num_features: int = NUM_FEATURES):
    """Cut and scan of [R, H, W] maps: (x, y, ori, valid), each [R, num_features]."""
    return scan_select(cut_candidates(score, quantized, candidate_mask, num_features), num_features)


def _levels(depth):
    """Per level (half, depth [B, h, w], mask [B, h, w]): level 0 is the
    view, level 1 the color 2x2-averaged (the quantizer's `half`) and the
    depth and the eroded mask subsampled."""
    mask0 = erode_mask(depth > 0, 1)
    return [(False, depth, mask0), (True, depth[:, ::2, ::2], mask0[:, ::2, ::2])]


def quantize_views(color, depth, dual_modality: bool = False) -> dict:
    """The quantized maps of a batch of rendered views, keyed "grad0",
    "grad1" and, with `dual_modality`, "norm0" and "norm1": each (score,
    quantized, candidate mask), [B, h, w] at that level's resolution.

    color: [B, H, W, 3] float32 0..255 (BGR), depth: [B, H, W] float32 mm
    (0 = background). Color candidates are strong gradients, normal
    candidates any quantized normal, both inside the eroded object mask."""
    out = {}
    for lvl, (half, d, m) in enumerate(_levels(depth)):
        quant, mag2 = quantize_color_gradients(color, half=half)
        out[f"grad{lvl}"] = (mag2, quant, (quant != 0) & (mag2 > STRONG_THRESHOLD**2) & m)
        if dual_modality:
            nquant, nmag2 = quantize_normals(d)
            out[f"norm{lvl}"] = (nmag2, nquant, (nquant != 0) & m)
    return out


def extract_template(color, depth, dual_modality: bool = False, num_features: int = NUM_FEATURES) -> dict:
    """Per-level features of a batch of rendered views: a dict keyed as
    `quantize_views` of (x, y, ori, valid), each [B, num_features]. The
    levels and modalities share one scan."""
    maps = quantize_views(color, depth, dual_modality)
    cands = {k: cut_candidates(*m, num_features) for k, m in maps.items()}
    b = color.shape[0]
    sel = scan_select(concat_candidates(list(cands.values())), num_features)
    return {k: tuple(a[i * b : (i + 1) * b] for a in sel) for i, k in enumerate(cands)}
