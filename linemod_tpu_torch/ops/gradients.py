"""Quantized color-gradient orientations (counterpart of
`linemod_tpu/ops/gradients.py`).

cv::linemod::ColorGradient semantics: Sobel gradients of a 7x7
Gaussian-smoothed image, the strongest color channel per pixel, orientation
folded to 180 degrees and quantized to 8 bins, then a 3x3 neighbourhood vote.
Output is a uint8 one-hot bitmask per pixel (0 = no orientation).

The float arithmetic follows the JAX version term for term: the same
shift-and-add order in `_sep_conv2d`, edge padding, `round` half to even,
`& 15` on negative int32 and the first maximum in the channel pick and the
vote. XLA's CPU backend contracts each `a * k + acc` of those sums into a
fused multiply-add (one rounding instead of two), so `_fma` reproduces that
contraction exactly; with it the quantized maps agree bit for bit with the
JAX reference on the CPU. The angle's `atan2` is the C library's atanf
algorithm (`atan2`), which XLA calls.

`quantize_color_gradients` given a CUDA tensor launches the kernel of
`csrc/quantize.cu` (one launch a pyramid level; with `half` it reads the
level-0 frame and fuses the 2x2 downsample) or raises, and adds one to its
`launches` count; given a CPU tensor it runs `quantize_color_gradients_plain`,
the operation chain above, which is also what the card's tests hold the
kernel to bit for bit. `ops/cuda_lib.py` builds the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_lib

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
    """float32 a * b + c with a single rounding, as a hardware FMA gives it.

    a * b is exact in float64 (24 + 24 significand bits). The float64 sum is
    made round-to-odd (its TwoSum error nudges an inexact even result one
    ulp toward the exact value), and rounding a round-to-odd float64 to
    float32 is then the correctly rounded float32 of the exact a * b + c."""
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


# the C library's float arctangent (fdlibm's atanf and atan2f, as glibc
# builds them): argument reduction breakpoints' values, odd and even
# polynomial coefficients, pi and its low part
_ATAN_HI = _f32_bits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATAN_LO = _f32_bits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_ATAN_ODD = _f32_bits(0x3EAAAAAB, 0x3E124925, 0x3DBA2E6E, 0x3D886B35, 0x3D4BDA59, 0x3C8569D7)
_ATAN_EVEN = _f32_bits(0xBE4CCCCD, 0xBDE38E38, 0xBD9D8795, 0xBD6EF16B, 0xBD15A221)
_PI, _PI_O_2, _PI_LO = _f32_bits(0x40490FDB, 0x3FC90FDB, 0xB3BBBD2E)


def _atanf_nonneg(x: torch.Tensor) -> torch.Tensor:
    """atanf of x >= 0, operation by operation as the C library computes it:
    reduced about 0, 0.5, 1, 1.5 or infinity by |x|, then an odd and an even
    polynomial in x^2."""
    dev = x.device

    def c(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    one, two, three_halves = c(1.0), c(2.0), c(1.5)
    ix = x.view(torch.int32)
    idx = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int() + (ix >= 0x3F980000).int()
           + (ix >= 0x401C0000).int()) - 1  # -1 below 7/16, then 0..3
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
    odd, even = _ATAN_ODD, _ATAN_EVEN
    p1 = c(odd[5])
    for k in (4, 3, 2, 1, 0):
        p1 = p1 * w + c(odd[k])
    p2 = c(even[4])
    for k in (3, 2, 1, 0):
        p2 = p2 * w + c(even[k])
    t = xr * (z * p1 + p2 * w)
    k = idx.clamp(min=0).long()
    hi = torch.as_tensor(_ATAN_HI, device=dev)[k]
    lo = torch.as_tensor(_ATAN_LO, device=dev)[k]
    out = torch.where(idx < 0, xr - t, hi - ((t - lo) - xr))
    out = torch.where(ix < 0x31000000, x, out)  # below 2^-29: x itself
    return torch.where(ix >= 0x4C000000, c(_ATAN_HI[3]) + c(_ATAN_LO[3]), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2(y, x) bit for bit as the C library's atan2f (fdlibm's,
    as glibc builds it), which XLA's CPU backend calls for the reference's
    arctan2. Each operation is one float32 rounding, so the result is the
    same on any device. torch.atan2 differs from it by an ulp on ~16% of
    inputs, which moves an orientation bin where the angle lies within an
    ulp of a bin's edge. Finite inputs (no NaN or infinity); subnormal
    inputs and quotients count as zero, as in XLA's CPU code."""
    dev = x.device

    def c(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    def flush(v):  # XLA's CPU code runs with subnormals flushed to (signed) zero
        return torch.where(v.abs() < c(2.0**-126), v * c(0.0), v)

    x, y = flush(x), flush(y)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23  # the exponents' difference
    z = _atanf_nonneg(flush(y / torch.where(ix == 0, c(1.0), x)).abs())
    z = torch.where(k > 60, c(_PI_O_2) + c(0.5) * c(_PI_LO), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    pi, pi_lo, tiny = c(_PI), c(_PI_LO), c(1e-30)
    r = torch.where(m == 0, z, torch.where(m == 1, -z,
                    torch.where(m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    on_x = torch.where(m <= 1, y, torch.where(m == 2, pi + tiny, -pi - tiny))  # y = 0
    r = torch.where(iy == 0, on_x, r)
    on_y = torch.where(hy < 0, -c(_PI_O_2) - tiny, c(_PI_O_2) + tiny)  # x = 0, y != 0
    return torch.where((ix == 0) & (iy != 0), on_y, r)


def _sum_of_products(terms) -> torch.Tensor:
    """sum_i x_i * k_i in the order XLA's CPU backend evaluates it: the first
    add fuses the first product into the second, each later add fuses its
    own product into the running sum."""
    (x0, k0), *rest = terms
    if not rest:
        return x0 * k0
    (x1, k1), *rest = rest
    acc = _fma(x0, k0, x1 * k1)
    for x, k in rest:
        acc = _fma(x, k, acc)
    return acc


def _sep_conv2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Separable 2-D convolution with replicate padding on [..., H, W, C]
    float32, as shift-and-add in the JAX version's term order (row pass
    left to right, then column pass top to bottom, zero taps skipped)."""
    h, w = img.shape[-3:-1]
    rx = len(kx) // 2
    ry = len(ky) // 2
    x = _edge_pad(img, ry, rx)
    row = _sum_of_products(
        [(x[..., i : i + w, :], float(k)) for i, k in enumerate(kx) if k != 0.0]
    )
    return _sum_of_products(
        [(row[..., j : j + h, :, :], float(k)) for j, k in enumerate(ky) if k != 0.0]
    )


def quantize_color_gradients_plain(img: torch.Tensor, weak: float = WEAK_THRESHOLD):
    """Quantize image gradients to 8-bin orientation bitmasks (the plain
    PyTorch version of `quantize_color_gradients`).

    img: [..., H, W, 3] float (0..255, BGR). Returns (quantized [..., H, W]
    uint8 one-hot-or-zero, magnitude2 [..., H, W] float32 of the strongest
    channel).
    """
    img = img.to(torch.float32)
    g = _gaussian_kernel_1d(7)
    sm = _sep_conv2d(img, g, g)

    # Sobel 3x3 = [-1,0,1] x [1,2,1]
    dx = _sep_conv2d(sm, np.array([-1, 0, 1], np.float32), np.array([1, 2, 1], np.float32))
    dy = _sep_conv2d(sm, np.array([1, 2, 1], np.float32), np.array([-1, 0, 1], np.float32))
    mag2 = _fma(dx, dx, dy * dy)  # [H, W, 3], dx * dx + dy * dy
    m0, m1, m2 = mag2[..., 0], mag2[..., 1], mag2[..., 2]
    pick1 = m1 > m0  # the first maximum wins ties, hence strict compares
    m01 = torch.where(pick1, m1, m0)
    pick2 = m2 > m01

    def sel(a):
        return torch.where(pick2, a[..., 2], torch.where(pick1, a[..., 1], a[..., 0]))

    best_dx = sel(dx)
    best_dy = sel(dy)
    best_mag2 = torch.where(pick2, m2, m01)

    # orientation folded to 180 degrees, 8 bins: round(angle * 16 / 2pi) & 7
    angle = atan2(best_dy, best_dx)
    bin16 = torch.round(angle * float(np.float32(16.0 / (2.0 * np.pi)))).to(torch.int32) & 15
    bin8 = (bin16 & 7).long()

    # 3x3 vote over every neighbour's raw orientation; a pixel keeps an
    # orientation if it passes the weak threshold itself and >= 5 of its
    # 3x3 patch agree on one bin
    onehot = torch.nn.functional.one_hot(bin8, 8).to(torch.float32)
    ones3 = np.ones(3, np.float32)
    votes = _sep_conv2d(onehot, ones3, ones3)  # [..., H, W, 8]
    winner = votes.argmax(dim=-1)  # first maximum
    count = votes.amax(dim=-1)
    keep = (count >= NEIGHBOR_VOTES) & (best_mag2 > (weak * weak))
    onebit = torch.bitwise_left_shift(torch.ones_like(winner), winner).to(torch.uint8)
    quantized = torch.where(keep, onebit, torch.zeros_like(onebit))
    return quantized, best_mag2


# ------------------------------------------------------------- the kernel ---

_P, _I = ctypes.c_void_p, ctypes.c_int
# img, batch, src_h, src_w, half, strong2, quant, mag2, stream
_SIGNATURES = {"gradient_quant": [_P, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P]}
_MAX_BATCH = 65535  # the kernel's grid takes the batch on blockIdx.z


def quantize_color_gradients(img: torch.Tensor, weak: float = WEAK_THRESHOLD, half: bool = False):
    """`quantize_color_gradients_plain(img, weak)`, or with `half` the same of
    the 2x2-averaged image (`extract.downsample2` of each image: an odd last
    row or column dropped).

    img: [..., H, W, 3] float (0..255, BGR), the batch (if any) flattened
    onto the kernel's grid. Returns (quantized [..., h, w] uint8,
    magnitude2 [..., h, w] float32) at the level's (h, w)."""
    img = img.to(torch.float32)
    if img.dim() < 3 or img.shape[-1] != 3:
        raise ValueError(f"want [..., H, W, 3] color, got {tuple(img.shape)}")
    if img.device.type == "cpu":
        if half:
            from .extract import downsample2  # extract imports this module

            h, w = img.shape[-3:-1]
            views = img.reshape(-1, h, w, 3).permute(1, 2, 0, 3)
            img = downsample2(views).permute(2, 0, 1, 3).reshape(*img.shape[:-3], h // 2, w // 2, 3)
        return quantize_color_gradients_plain(img, weak)
    img = img.contiguous()
    lead, (src_h, src_w) = img.shape[:-3], img.shape[-3:-1]
    h, w = (src_h // 2, src_w // 2) if half else (src_h, src_w)
    batch = math.prod(lead)
    if batch < 1 or batch > _MAX_BATCH or h < 1 or w < 1:
        raise ValueError(f"the quantizer takes 1..{_MAX_BATCH} images of at least one pixel a level, "
                         f"got {tuple(img.shape)} (half={half})")
    quant = torch.empty((*lead, h, w), dtype=torch.uint8, device=img.device)
    mag2 = torch.empty((*lead, h, w), dtype=torch.float32, device=img.device)
    cuda_lib.launch("quantize", _SIGNATURES, "gradient_quant", img.device, img.data_ptr(), batch, src_h, src_w,
                    int(half), float(np.float32(weak * weak)), quant.data_ptr(), mag2.data_ptr())
    quantize_color_gradients.launches += 1
    return quant, mag2


quantize_color_gradients.launches = 0
