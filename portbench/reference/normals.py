"""The depth-normal quantizer of the plain reference, in plain PyTorch: the
second modality of a dual-modality configuration (cv::linemod::DepthNormal's
place), written from its definition:

- the depth's central differences along x and y, each with bilateral
  rejection of discontinuities: a neighbour that is a hole (0) or lies 50 mm
  or more away is left out, and the other side's one-sided difference is
  used (0 where both are left out);
- a pixel has an orientation where its depth is valid, a difference along
  each axis was kept, and the squared slope exceeds 1 mm^2 a pixel;
- the azimuth of the slope, atan2(gy, gx), quantized to 8 bins of 45 degrees
  over the full circle (round half to even, modulo 8);
- a 3x3 vote over the one-hot bins (the border replicated): the first bin
  with the most votes wins where it has at least 5;
- a uint8 one-hot bitmask a pixel, 0 for none, as the color modality's.

The depth is integer millimetres, so the differences, their means and the
squared slope are exact in float32; the angle is fdlibm's atan2f
(`quantize.atan2`), as the configuration's quantizers state it.

Imports only numpy, torch and the reference's quantizer.
"""

from __future__ import annotations

import numpy as np
import torch

from .quantize import _sep_conv2d, atan2

DIFFERENCE_THRESHOLD = 50.0  # mm
MIN_SLOPE = 1.0  # mm a pixel
NEIGHBOR_VOTES = 5  # of the 9 in a 3x3 patch


def _neighbour(d: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = d[y + dy, x + dx], 0 outside the image."""
    h, w = d.shape
    out = torch.zeros_like(d)
    out[max(0, -dy) : h - max(0, dy), max(0, -dx) : w - max(0, dx)] = \
        d[max(0, dy) : h - max(0, -dy), max(0, dx) : w - max(0, -dx)]
    return out


def _difference(d: torch.Tensor, ahead: torch.Tensor, behind: torch.Tensor) -> tuple:
    """(slope, whether a side was kept) of one axis."""
    ga, gb = ahead - d, d - behind
    ok_a = (ga.abs() < DIFFERENCE_THRESHOLD) & (ahead > 0)
    ok_b = (gb.abs() < DIFFERENCE_THRESHOLD) & (behind > 0)
    g = torch.where(ok_a & ok_b, 0.5 * (ga + gb),
                    torch.where(ok_a, ga, torch.where(ok_b, gb, torch.zeros_like(d))))
    return g, ok_a | ok_b


def quantize_normals(depth: torch.Tensor) -> torch.Tensor:
    """[H, W] depth in mm (0: no reading) -> [H, W] uint8 one-hot
    orientation of the surface slope (0: none)."""
    d = depth.to(torch.float32)
    gx, ok_x = _difference(d, _neighbour(d, 0, 1), _neighbour(d, 0, -1))
    gy, ok_y = _difference(d, _neighbour(d, 1, 0), _neighbour(d, -1, 0))
    mag2 = gx * gx + gy * gy
    angle = atan2(gy, gx)
    bin8 = (torch.round(angle * float(np.float32(8.0 / (2.0 * np.pi)))).to(torch.int32) & 7).long()
    onehot = torch.nn.functional.one_hot(bin8, 8).to(torch.float32)
    ones3 = np.ones(3, np.float32)
    votes = _sep_conv2d(onehot, ones3, ones3, fused=False)
    winner = votes.argmax(dim=-1)
    count = votes.amax(dim=-1)
    keep = (count >= NEIGHBOR_VOTES) & (d > 0) & ok_x & ok_y & (mag2 > MIN_SLOPE * MIN_SLOPE)
    onebit = torch.bitwise_left_shift(torch.ones_like(winner), winner).to(torch.uint8)
    return torch.where(keep, onebit, torch.zeros_like(onebit))
