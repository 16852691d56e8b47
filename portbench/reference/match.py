"""The plain reference of the match program: one frame -> the packed
[top_k, 5] candidates (template id, x, y, similarity %, valid).

Written from LINE-MOD's definition, in pixel coordinates, and independent
of the port's plane layout, plans and cuts:

- both pyramid levels are quantized (`quantize.quantize`; level 1 is the
  2x2 average of the frame), cropped to a multiple of T (2 at level 0, 8
  at level 1), OR-spread over the forward T x T window (zeros past the
  edge) and turned into 8 response maps, R_o(y, x) = the best of
  4 - (circular bin distance) over the spread byte's bits, at least 0;
- a dual-modality bank (`make_bank(..., dual=True)`: its arrays hold
  `nfeat*`/`nvalid*` beside the color features) also quantizes the depth's normals (`normals.quantize_normals`;
  level 1 reads every second pixel of each second row) into 8 more response
  maps, with T = 5 at level 0; its normal features read those maps, so a
  template's raw score sums both modalities' responses and its similarity
  divides by both modalities' valid features;
- a template's raw score at grid cell (gy, gx) of a level is
  sum over its valid features (x, y, o) of R_o(gy*T + y, gx*T + x), read
  as 0 outside the cropped image; its similarity is
  raw * 100 / (4 * valid features), in float32;
- every template is scored at every level-1 cell (the dense scan), -1
  where its bbox does not fit: gy < H1/8 - ceil(h/16), gx < W1/8 - ceil(w/16);
- the exact top-K of the flat [N * G] similarity, by similarity descending
  and then flat index ascending;
- each candidate's window of ceil(16 / T0) x ceil(16 / T0) level-0 cells
  (8 x 8 at T0 = 2, 4 x 4 at T0 = 5) from cell (16 gy // T0, 16 gx // T0)
  is scored, the first maximum kept;
- a candidate is valid where both similarities reach the threshold; the
  rows are sorted by fine similarity (stable), invalid rows set to
  (-1, 0, 0, -1, 0).

The bank is padded as the configuration states (to a multiple of
min(256, the next power of two of its size), with featureless 1-pixel
templates). Also returned: what the kernels' bounds need (the cut's
candidates and each template's masked max).

Imports only numpy, torch and the reference's quantizers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .normals import quantize_normals
from .quantize import downsample2, quantize

T_FINE = 2
T_FINE_DUAL = 5
T_COARSE = 8
MAX_RESPONSE = 4
_DIST = np.minimum((np.arange(8)[:, None] - np.arange(8)[None, :]) % 8,
                   (np.arange(8)[None, :] - np.arange(8)[:, None]) % 8)
SIMILARITY = np.maximum(4 - _DIST, 0).astype(np.uint8)  # [orientation, bit]
# index chunk of the dense scan's gathers (int64 entries)
_CHUNK_ENTRIES = 16 * 1024 * 1024


def pad_count(n: int) -> int:
    """Templates after padding: a multiple of min(256, next pow2 of n)."""
    chunk = min(256, 1 << int(np.ceil(np.log2(max(n, 1)))))
    return int(np.ceil(n / chunk)) * chunk


@dataclasses.dataclass
class Bank:
    """The bank's arrays the match needs, padded, on one device."""

    feat0: torch.Tensor  # [N, F, 3] int64 (x, y, map), level 0
    valid0: torch.Tensor  # [N, F] bool
    feat1: torch.Tensor  # [N, F, 3] int64, level 1
    valid1: torch.Tensor
    wh: torch.Tensor  # [N, 2] int64 bbox (w, h) at level 0
    n_real: int
    dual: bool = False  # F holds the color features, then the normal ones (maps 8-15)

    @property
    def t_fine(self) -> int:
        return T_FINE_DUAL if self.dual else T_FINE


def make_bank(arrays: dict, device, dual: bool = False) -> Bank:
    """Pad and upload: arrays holds feat0, valid0, feat1, valid1, bbox and,
    for a dual-modality bank (`dual`), nfeat0, nvalid0, nfeat1, nvalid1
    (appended to the color features, their orientations read as maps 8-15)."""
    if dual:
        def both(level):
            normal = arrays[f"nfeat{level}"].astype(np.int64)
            normal[..., 2] += 8
            return (np.concatenate([arrays[f"feat{level}"].astype(np.int64), normal], axis=1),
                    np.concatenate([arrays[f"valid{level}"], arrays[f"nvalid{level}"]], axis=1))

        (f0, v0), (f1, v1) = both(0), both(1)
        arrays = dict(arrays, feat0=f0, valid0=v0, feat1=f1, valid1=v1)
    n = arrays["bbox"].shape[0]
    pad = pad_count(n) - n

    def padded(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return Bank(
        feat0=dev(padded(arrays["feat0"], 0).astype(np.int64)),
        valid0=dev(padded(arrays["valid0"], False)),
        feat1=dev(padded(arrays["feat1"], 0).astype(np.int64)),
        valid1=dev(padded(arrays["valid1"], False)),
        wh=dev(padded(arrays["bbox"][:, 2:4], 1).astype(np.int64)),
        n_real=n,
        dual=dual,
    )


def response_maps(quant: torch.Tensor, t: int) -> torch.Tensor:
    """[H, W] uint8 one-hot -> [8, H', W'] uint8 responses of the image
    cropped to multiples of t, spread over the forward t x t window."""
    h, w = quant.shape
    h, w = h - h % t, w - w % t
    q = torch.zeros((h + t - 1, w + t - 1), dtype=torch.uint8, device=quant.device)
    q[:h, :w] = quant[:h, :w]
    spread = torch.zeros((h, w), dtype=torch.uint8, device=quant.device)
    for dy in range(t):
        for dx in range(t):
            spread |= q[dy : dy + h, dx : dx + w]
    resp = torch.zeros((8, h, w), dtype=torch.uint8, device=quant.device)
    sim = torch.as_tensor(SIMILARITY, device=quant.device)
    for b in range(8):
        has = ((spread >> b) & 1).bool()
        resp = torch.maximum(resp, torch.where(has[None], sim[:, b, None, None], 0).to(torch.uint8))
    return resp


class _Reader:
    """R_o(y, x) with zeros around: a flat padded copy of the M response
    maps plus an all-zero map, the (M+1)-th, that invalid features read."""

    def __init__(self, resp: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor):
        maps, h, w = resp.shape
        self.h, self.w = h, w
        my = int(feats[..., 1].max().item()) + 1 if feats.numel() else 1
        mx = int(feats[..., 0].max().item()) + 1 if feats.numel() else 1
        self.hp, self.wp = h + my, w + mx
        pad = torch.zeros((maps + 1, self.hp, self.wp), dtype=torch.uint8, device=resp.device)
        pad[:maps, :h, :w] = resp
        self.flat = pad.reshape(-1)
        base = (feats[..., 2] * self.hp + feats[..., 1]) * self.wp + feats[..., 0]
        self.base = torch.where(valid, base, maps * self.hp * self.wp)  # [N, F]

    def pixel_offsets(self, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        return ys * self.wp + xs

    def scores(self, rows: torch.Tensor | slice, pos: torch.Tensor) -> torch.Tensor:
        """int32 [R, S]: sum over features of row r of R at base + pos[., s]
        (pos [S] shared, or [R, S])."""
        base = self.base[rows]
        r, f = base.shape
        s = pos.shape[-1]
        out = torch.zeros((r, s), dtype=torch.int32, device=base.device)
        step = max(1, _CHUNK_ENTRIES // max(s, 1))
        for r0 in range(0, r, step):
            p = pos if pos.dim() == 1 else pos[r0 : r0 + step]
            acc = out[r0 : r0 + step]
            for j in range(f):
                acc += self.flat[base[r0 : r0 + step, j, None] + p].to(torch.int32)
        return out


def _percent(raw: torch.Tensor, nf: torch.Tensor) -> torch.Tensor:
    return raw.float() * 100.0 / (MAX_RESPONSE * nf.float())


@dataclasses.dataclass
class FrameResult:
    packed: np.ndarray  # [top_k, 5] float32
    cand_t: torch.Tensor  # [top_k] the cut's candidates, cut order
    cand_gy: torch.Tensor
    cand_gx: torch.Tensor
    template_max: torch.Tensor  # [N] masked max similarity (-1: fits nowhere)


def exact_top_k(flat: torch.Tensor, k: int):
    """(values, indices) of the k largest entries, similarity descending,
    then index ascending."""
    kth = torch.topk(flat, k).values[-1]
    idx = torch.nonzero(flat >= kth).squeeze(1)
    vals = flat[idx]
    order = torch.sort(vals, descending=True, stable=True).indices[:k]
    return vals[order], idx[order]


def match_frame(bank: Bank, color: torch.Tensor, threshold: float, top_k: int,
                precision: str = "float32", depth: torch.Tensor | None = None) -> FrameResult:
    """color: [H, W, 3] uint8 BGR on the bank's device (recentred); depth:
    [H, W] mm (recentred), read by a dual-modality bank only."""
    t_fine = bank.t_fine
    img = color.float()
    q0 = quantize(img, precision)
    q1 = quantize(downsample2(img), precision)
    resp0 = response_maps(q0, t_fine)
    resp1 = response_maps(q1, T_COARSE)
    if bank.dual:
        if depth is None:
            raise ValueError("a dual-modality bank needs the depth")
        n0 = quantize_normals(depth)[: q0.shape[0], : q0.shape[1]]
        n1 = quantize_normals(depth[::2, ::2])[: q1.shape[0], : q1.shape[1]]
        resp0 = torch.cat([resp0, response_maps(n0, t_fine)])
        resp1 = torch.cat([resp1, response_maps(n1, T_COARSE)])
    dev = resp0.device

    # the dense scan at level 1
    coarse = _Reader(resp1, bank.feat1, bank.valid1)
    ch, cw = coarse.h // T_COARSE, coarse.w // T_COARSE
    gy = torch.arange(ch, device=dev).repeat_interleave(cw)
    gx = torch.arange(cw, device=dev).repeat(ch)
    cells = coarse.pixel_offsets(gy * T_COARSE, gx * T_COARSE)
    raw = coarse.scores(slice(None), cells)  # [N, G]
    nf1 = bank.valid1.sum(1).clamp(min=1)
    step = 2 * T_COARSE
    lim_y = ch - (bank.wh[:, 1] + step - 1) // step
    lim_x = cw - (bank.wh[:, 0] + step - 1) // step
    fits = (gy[None, :] < lim_y[:, None]) & (gx[None, :] < lim_x[:, None])
    sim = torch.where(fits, _percent(raw, nf1[:, None]), -1.0)
    del raw
    template_max = sim.max(dim=1).values
    top_sim, top_idx = exact_top_k(sim.reshape(-1), top_k)
    del sim
    n_cells = ch * cw
    cand_t = top_idx // n_cells
    cand_g = top_idx % n_cells
    cand_gy, cand_gx = cand_g // cw, cand_g % cw

    # the fine refine at level 0
    fine = _Reader(resp0, bank.feat0, bank.valid0)
    win = -(-step // t_fine)
    base_gy = cand_gy * step // t_fine
    base_gx = cand_gx * step // t_fine
    wy = torch.arange(win, device=dev).repeat_interleave(win)
    wx = torch.arange(win, device=dev).repeat(win)
    pos = fine.pixel_offsets((base_gy[:, None] + wy[None]) * t_fine, (base_gx[:, None] + wx[None]) * t_fine)
    scores = fine.scores(cand_t, pos)  # [K, win * win]
    best = scores.argmax(dim=1)
    best_raw = scores.gather(1, best[:, None])[:, 0]
    nf0 = bank.valid0.sum(1).clamp(min=1)
    fsim = _percent(best_raw, nf0[cand_t])
    x = (base_gx + best % win) * t_fine
    y = (base_gy + best // win) * t_fine

    valid = (fsim >= threshold) & (top_sim >= threshold)
    order = torch.argsort(-torch.where(valid, fsim, -1.0), stable=True)
    v = valid[order]
    packed = torch.stack([
        torch.where(v, cand_t[order], -1).float(),
        torch.where(v, x[order], 0).float(),
        torch.where(v, y[order], 0).float(),
        torch.where(v, fsim[order], -1.0),
        v.float(),
    ], dim=1)
    return FrameResult(packed.cpu().numpy(), cand_t, cand_gy, cand_gx, template_max)
