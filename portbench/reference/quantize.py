"""The color-gradient quantizer of the plain reference, in plain PyTorch.

A frozen copy of the port's plain quantizer (cv::linemod::ColorGradient
semantics: Sobel gradients of a 7x7 Gaussian-smoothed image, the strongest
color channel per pixel, the orientation folded to 180 degrees and
quantized to 8 bins, then a 3x3 vote; a uint8 one-hot bitmask per pixel, 0
for none). The configuration states its arithmetic: float32, each
`a * k + acc` of the filter sums contracted into one fused multiply-add (as
XLA's CPU backend compiles the original), and the C library's `atan2f`.
`_fma` and `atan2` reproduce both operation by operation, so the maps are
the same on any device.

`precision="bfloat16"` is the control: the same filters and vote computed
in bfloat16 with plain products and adds, the angle by torch.atan2 of the
bfloat16 gradients. It is never the reference; it is the lower precision
that the comparison must catch.

Imports only numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

WEAK_THRESHOLD = 10.0
NEIGHBOR_VOTES = 5  # of the 9 in a 3x3 patch


def _gaussian_kernel_1d(ksize: int = 7) -> np.ndarray:
    # OpenCV's getGaussianKernel default sigma for ksize=7
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _edge_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Replicate-pad the H and W axes of [..., H, W, C] by (ry, rx)."""
    h, w = img.shape[-3:-1]
    yi = torch.arange(-ry, h + ry, device=img.device).clamp(0, h - 1)
    xi = torch.arange(-rx, w + rx, device=img.device).clamp(0, w - 1)
    return img.index_select(-3, yi).index_select(-2, xi)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with a single rounding: the float64 sum made
    round-to-odd (TwoSum's error nudges an inexact even result one ulp
    toward the exact value), then rounded to float32."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _f32_bits(*bits) -> np.ndarray:
    return np.array(bits, np.uint32).view(np.float32)


# fdlibm's atanf / atan2f constants, as glibc builds them
_ATAN_HI = _f32_bits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATAN_LO = _f32_bits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_ATAN_ODD = _f32_bits(0x3EAAAAAB, 0x3E124925, 0x3DBA2E6E, 0x3D886B35, 0x3D4BDA59, 0x3C8569D7)
_ATAN_EVEN = _f32_bits(0xBE4CCCCD, 0xBDE38E38, 0xBD9D8795, 0xBD6EF16B, 0xBD15A221)
_PI, _PI_O_2, _PI_LO = _f32_bits(0x40490FDB, 0x3FC90FDB, 0xB3BBBD2E)


def _atanf_nonneg(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's atanf of x >= 0, operation by operation."""
    dev = x.device

    def c(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    one, two, three_halves = c(1.0), c(2.0), c(1.5)
    ix = x.view(torch.int32)
    idx = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
           + (ix >= 0x401C0000).int()) - 1
    reduced = [
        (two * x - one) / (two + x),
        (x - one) / (x + one),
        (x - three_halves) / (one + three_halves * x),
        -one / x,
    ]
    xr = x
    for i, r in enumerate(reduced):
        xr = torch.where(idx == i, r, xr)
    z = xr * xr
    w = z * z
    p1 = c(_ATAN_ODD[5])
    for k in (4, 3, 2, 1, 0):
        p1 = p1 * w + c(_ATAN_ODD[k])
    p2 = c(_ATAN_EVEN[4])
    for k in (3, 2, 1, 0):
        p2 = p2 * w + c(_ATAN_EVEN[k])
    t = xr * (z * p1 + p2 * w)
    k = idx.clamp(min=0).long()
    hi = torch.as_tensor(_ATAN_HI, device=dev)[k]
    lo = torch.as_tensor(_ATAN_LO, device=dev)[k]
    out = torch.where(idx < 0, xr - t, hi - ((t - lo) - xr))
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(ix >= 0x4C000000, c(_ATAN_HI[3]) + c(_ATAN_LO[3]), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2(y, x) as fdlibm's atan2f, subnormals flushed to zero."""
    dev = x.device

    def c(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    def flush(v):
        return torch.where(v.abs() < c(2.0**-126), v * c(0.0), v)

    x, y = flush(x), flush(y)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    k = (iy - ix) >> 23
    z = _atanf_nonneg(flush(y / torch.where(ix == 0, c(1.0), x)).abs())
    z = torch.where(k > 60, c(_PI_O_2) + c(0.5) * c(_PI_LO), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    pi, pi_lo, tiny = c(_PI), c(_PI_LO), c(1e-30)
    r = torch.where(m == 0, z, torch.where(m == 1, -z,
                    torch.where(m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    on_x = torch.where(m <= 1, y, torch.where(m == 2, pi + tiny, -pi - tiny))
    r = torch.where(iy == 0, on_x, r)
    on_y = torch.where(hy < 0, -c(_PI_O_2) - tiny, c(_PI_O_2) + tiny)
    return torch.where((ix == 0) & (iy != 0), on_y, r)


def _sum_of_products(terms, fused: bool) -> torch.Tensor:
    """sum_i x_i * k_i, left to right; `fused`: each add after the first
    product contracted with its product (XLA's CPU order)."""
    (x0, k0), *rest = terms
    if not rest:
        return x0 * k0
    (x1, k1), *rest = rest
    if not fused:
        acc = x0 * k0 + x1 * k1
        for x, k in rest:
            acc = acc + x * k
        return acc
    acc = _fma(x0, k0, x1 * k1)
    for x, k in rest:
        acc = _fma(x, k, acc)
    return acc


def _sep_conv2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray, fused: bool) -> torch.Tensor:
    """Separable 2-D convolution with replicate padding on [..., H, W, C]:
    the row pass left to right, then the column pass top to bottom, zero
    taps skipped."""
    h, w = img.shape[-3:-1]
    rx = len(kx) // 2
    ry = len(ky) // 2
    x = _edge_pad(img, ry, rx)
    row = _sum_of_products([(x[..., i : i + w, :], float(k)) for i, k in enumerate(kx) if k != 0.0], fused)
    return _sum_of_products([(row[..., j : j + h, :, :], float(k)) for j, k in enumerate(ky) if k != 0.0], fused)


def quantize(img: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """[H, W, 3] float BGR 0..255 -> [H, W] uint8 one-hot orientation (0:
    none). `precision` is "float32" (the configuration's) or "bfloat16" (the
    control)."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    fused = precision == "float32"
    dtype = torch.float32 if fused else torch.bfloat16
    img = img.to(dtype)
    g = _gaussian_kernel_1d(7)
    sm = _sep_conv2d(img, g, g, fused)
    dx = _sep_conv2d(sm, np.array([-1, 0, 1], np.float32), np.array([1, 2, 1], np.float32), fused)
    dy = _sep_conv2d(sm, np.array([1, 2, 1], np.float32), np.array([-1, 0, 1], np.float32), fused)
    mag2 = _fma(dx, dx, dy * dy) if fused else dx * dx + dy * dy
    m0, m1, m2 = mag2[..., 0], mag2[..., 1], mag2[..., 2]
    pick1 = m1 > m0
    m01 = torch.where(pick1, m1, m0)
    pick2 = m2 > m01

    def sel(a):
        return torch.where(pick2, a[..., 2], torch.where(pick1, a[..., 1], a[..., 0]))

    best_dx, best_dy = sel(dx), sel(dy)
    best_mag2 = torch.where(pick2, m2, m01)
    if fused:
        angle = atan2(best_dy, best_dx)
    else:
        angle = torch.atan2(best_dy.float(), best_dx.float()).to(dtype).float()
    bin16 = torch.round(angle * float(np.float32(16.0 / (2.0 * np.pi)))).to(torch.int32) & 15
    bin8 = (bin16 & 7).long()
    onehot = torch.nn.functional.one_hot(bin8, 8).to(dtype)
    ones3 = np.ones(3, np.float32)
    votes = _sep_conv2d(onehot, ones3, ones3, fused)
    winner = votes.argmax(dim=-1)
    count = votes.amax(dim=-1)
    keep = (count >= NEIGHBOR_VOTES) & (best_mag2 > (WEAK_THRESHOLD * WEAK_THRESHOLD))
    onebit = torch.bitwise_left_shift(torch.ones_like(winner), winner).to(torch.uint8)
    return torch.where(keep, onebit, torch.zeros_like(onebit))


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of [H, W, C] float, the four taps summed in
    row-major order."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    x = img[: 2 * h, : 2 * w]
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]) * 0.25
