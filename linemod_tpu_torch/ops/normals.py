"""Quantized surface-normal orientations from depth (counterpart of
`linemod_tpu/ops/normals.py`), the second modality of dual-modality
detection (cv::linemod::DepthNormal's place in the reference).

Depth-image central differences with bilateral rejection of
discontinuities (50 mm), the azimuth of the projected slope quantized to 8
bins of 45 degrees, and a 3x3 agreement vote; a uint8 one-hot bitmask per
pixel like the color modality's, so spreading and scanning are shared.

The arithmetic is exact wherever the reference's is: depth is integer mm,
so the differences, their means and the squared slope (half-integers below
the 50 mm gate) are exact in float32 in any order, the vote counts ones,
`round` is half to even on both sides and `argmax` takes the first
maximum. Only `atan2` may differ by an ulp between backends, and no integer
slope lies within an ulp of a bin edge.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .gradients import _fma, atan2

DIFFERENCE_THRESHOLD = 50.0  # mm, depth-discontinuity rejection
MIN_SLOPE = 1.0  # mm depth change a pixel before a direction is meaningful
NEIGHBOR_VOTES = 5  # of the 9 in a 3x3 patch


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], 0 outside the image."""
    h, w = x.shape[-2:]
    pad = F.pad(x, (1, 1, 1, 1))
    return pad[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def quantize_normals(depth: torch.Tensor):
    """Quantize the depth slope's azimuth into 8-bin one-hot bitmasks.

    depth: [..., H, W] float mm (0 = invalid). Returns (quantized [..., H, W]
    uint8, slope_mag2 [..., H, W] float32)."""
    d = depth.to(torch.float32)

    def grad(a, b):
        # central difference; a neighbour across a discontinuity or a hole
        # is rejected and the other side's one-sided difference is used
        ga = a - d
        gb = d - b
        ok_a = (ga.abs() < DIFFERENCE_THRESHOLD) & (a > 0)
        ok_b = (gb.abs() < DIFFERENCE_THRESHOLD) & (b > 0)
        zero = torch.zeros_like(d)
        g = torch.where(
            ok_a & ok_b, 0.5 * (ga + gb), torch.where(ok_a, ga, torch.where(ok_b, gb, zero))
        )
        return g, ok_a | ok_b

    gx, okx = grad(_shift(d, 0, 1), _shift(d, 0, -1))
    gy, oky = grad(_shift(d, 1, 0), _shift(d, -1, 0))
    ok = (d > 0) & okx & oky
    # fused as XLA's CPU backend fuses it: on integer-mm depths the products
    # are exact either way, on rendered (float) depths only this order
    # gives the reference's magnitudes, which order the feature selection
    mag2 = _fma(gx, gx, gy * gy)

    # 8 azimuth bins over the full 360 degrees (normals are directed)
    angle = atan2(gy, gx)
    bin8 = torch.round(angle * float(np.float32(8.0 / (2.0 * np.pi)))).to(torch.int32) & 7

    # 3x3 vote over the edge-padded one-hot bins
    h, w = d.shape[-2:]
    onehot = F.one_hot(bin8.long(), 8).to(torch.float32).movedim(-1, -3)  # [..., 8, H, W]
    pad = F.pad(onehot.reshape(-1, 8, h, w), (1, 1, 1, 1), mode="replicate")
    pad = pad.reshape(*onehot.shape[:-2], h + 2, w + 2)
    votes = sum(pad[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3))
    winner = votes.argmax(dim=-3)  # first maximum
    count = votes.amax(dim=-3)
    keep = (count >= NEIGHBOR_VOTES) & ok & (mag2 > MIN_SLOPE * MIN_SLOPE)
    onebit = torch.bitwise_left_shift(torch.ones_like(winner), winner).to(torch.uint8)
    return torch.where(keep, onebit, torch.zeros_like(onebit)), mag2
