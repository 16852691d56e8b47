"""What each scan kernel's work needs, counted from the inputs' shapes and
values whatever implements it, and the least time the card could take.

A kernel's bound is the larger of its bytes over the memory rate (each
input byte read once, each output byte written once) and its adds over the
packed int32 add rate (four one-byte cells an int32 add). The peaks are one
NVIDIA H100 SXM's published figures at its full 700 W: 3.35 TB/s of HBM3,
and int32 adds at 64 lanes x 132 SMs x 1.98 GHz (16.7 T/s). The card's power
limit is printed beside every result.

The inputs are laid out as the kernels read them: one byte a (orientation,
pixel) response in (8 T^2 + 1) planes of `plane_shape` (the last all zero,
where invalid features point), int32 (plane, sy, sx) triplets over the 64
feature slots, int32 outputs. A dual-modality bank (color gradients and
depth normals) has T = 5 at level 0, both modalities' planes (2 x 8 T^2 + 1:
the normal planes follow the color ones) and 128 feature slots, the normal
features' orientations read as 8-15.

- `coarse_scores` (2.1): N templates x every coarse cell; the dense cut
  scans the padded bank, the prefiltered cut the rescan's templates (the
  best `rescan_templates` by masked max, template index breaking ties).
- `coarse_max` (2.3): every template's valid features at each cell of its
  fit box (the cells where its bbox fits), plus [N, 2] limits in, [N] out.
- `fine_scores` (2.2): the distinct plane bytes the K candidates' windows
  read (a mask set through the gather indices), the K x 64 x 12 triplet
  bytes, K x 12 bytes of candidate and origin, K x win^2 x 4 out; the adds
  are the valid features over the windows, one int32 add each (the
  windows' cells are not packed four to an add).

Copied from the port's measurement scripts (`chip_smoke.bound`,
`fitting_cells`, `tools/fine_time.fine_work`), expressed here on the
bank's arrays and the reference's candidates.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.match import T_COARSE, T_FINE, T_FINE_DUAL

HBM_BYTES_PER_S = 3.35e12
INT32_ADDS_PER_S = 64 * 132 * 1.98e9
CELLS_PER_ADD = 4
SLOTS = 64  # feature slots a template a modality
TRIPLET_BYTES = 12


def bound_s(nbytes: float, adds: float) -> float:
    """The least seconds: bytes over HBM's rate or int32 adds over the
    int32 rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, adds / INT32_ADDS_PER_S)


def plane_shape(h: int, w: int, t: int, max_cells: int) -> tuple:
    """(cells_h, cells_w, rows, stride) of one level's planes: the grid
    plus the bank's largest feature shift, rows to 8 (at least 32 cells),
    the stride to 128."""
    ch, cw = h // t, w // t
    rows = int(np.ceil((max(ch, 32) + max_cells) / 8.0)) * 8
    stride = int(np.ceil((cw + max_cells) / 128.0)) * 128
    return ch, cw, rows, stride


class Geometry:
    """The planes of both levels for a bank (padded arrays) and frame size;
    `dual`: a dual-modality bank."""

    def __init__(self, bbox: np.ndarray, width: int, height: int, dual: bool = False):
        modalities = 2 if dual else 1
        self.t_fine = T_FINE_DUAL if dual else T_FINE
        self.slots = modalities * SLOTS
        big = int(max(bbox[:, 2].max(), bbox[:, 3].max()))
        mc_f = int(np.ceil(big / self.t_fine)) + 1
        mc_c = int(np.ceil(big / 2 / T_COARSE)) + 1
        self.fine = plane_shape(height, width, self.t_fine, mc_f)
        self.coarse = plane_shape(height // 2, width // 2, T_COARSE, mc_c)
        self.fine_planes = modalities * 8 * self.t_fine * self.t_fine
        self.coarse_planes = modalities * 8 * T_COARSE * T_COARSE

    def plane_bytes(self, level: str) -> int:
        _, _, rows, stride = getattr(self, level)
        return (getattr(self, f"{level}_planes") + 1) * rows * stride


def coarse_scores_work(geo: Geometry, live: np.ndarray) -> tuple:
    """(bytes, int32 adds) of 2.1 over the templates whose valid-feature
    counts are `live`."""
    ch, cw = geo.coarse[:2]
    n = len(live)
    nbytes = geo.plane_bytes("coarse") + n * geo.slots * TRIPLET_BYTES + 4 * n * ch * cw
    return nbytes, int(live.sum()) * ch * cw / CELLS_PER_ADD


def coarse_max_work(geo: Geometry, live: np.ndarray, wh: np.ndarray) -> tuple:
    """(bytes, int32 adds) of 2.3 over the whole (padded) bank: live [N]
    valid features, wh [N, 2] bbox (w, h) at level 0."""
    ch, cw = geo.coarse[:2]
    step = 2 * T_COARSE
    ny = np.clip(ch - (wh[:, 1].astype(np.int64) + step - 1) // step, 0, ch)
    nx = np.clip(cw - (wh[:, 0].astype(np.int64) + step - 1) // step, 0, cw)
    n = len(live)
    nbytes = geo.plane_bytes("coarse") + n * geo.slots * TRIPLET_BYTES + 8 * n + 4 * n
    return nbytes, int((ny * nx * live.astype(np.int64)).sum()) / CELLS_PER_ADD


def fine_scores_work(geo: Geometry, feat0: torch.Tensor, valid0: torch.Tensor, cand_t: torch.Tensor,
                     cand_gy: torch.Tensor, cand_gx: torch.Tensor) -> tuple:
    """(bytes, int32 adds) of 2.2 for one frame's K candidates (feat0
    [N, slots, 3], valid0 [N, slots] of the padded bank, the reference's,
    on the candidates' device)."""
    _, _, rows, stride = geo.fine
    t = geo.t_fine
    win = -(-2 * T_COARSE // t)
    dev = cand_t.device
    f = feat0[cand_t]  # [K, slots, 3] (x, y, ori)
    v = valid0[cand_t]
    plane = torch.where(v, (f[..., 2] * t + f[..., 1] % t) * t + f[..., 0] % t, geo.fine_planes)
    sy = torch.where(v, f[..., 1] // t, 0)
    sx = torch.where(v, f[..., 0] // t, 0)
    origin = (cand_gy * 2 * T_COARSE // t) * stride + cand_gx * 2 * T_COARSE // t
    sub = (torch.arange(win, device=dev)[:, None] * stride + torch.arange(win, device=dev)[None, :]).reshape(-1)
    flat = (plane * rows + sy) * stride + sx + origin[:, None]  # [K, slots]
    mask = torch.zeros(geo.plane_bytes("fine"), dtype=torch.bool, device=dev)
    mask[(flat[:, :, None] + sub).reshape(-1)] = True
    k = cand_t.shape[0]
    nbytes = int(mask.sum().item()) + k * geo.slots * TRIPLET_BYTES + k * 12 + 4 * k * win * win
    return nbytes, int(v.sum().item()) * win * win


def rescan_live(template_max: torch.Tensor, live: torch.Tensor, n_sel: int) -> np.ndarray:
    """Valid-feature counts of the prefiltered cut's rescan: the n_sel
    templates of highest masked max, lower index first among ties."""
    order = torch.sort(template_max, descending=True, stable=True).indices[:n_sel]
    return live[order].cpu().numpy()
