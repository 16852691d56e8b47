"""Orientation spreading, response maps and linearized planes (counterpart of
`linemod_tpu/ops/spread.py`).

1. `spread_orientations`: OR the one-hot orientation bytes over a T x T
   forward window.
2. `response_maps`: per template orientation, the best similarity (0..4)
   against any orientation in the spread byte.
3. `linearized_response_planes`: the planes re-laid out on the T-strided
   grid, so that a feature at template offset (y, x) with orientation o
   scores every grid cell g from the contiguous slice at
   `feature_flat_offsets(...) + g`. This is the layout the coarse and fine
   similarity kernels read.
4. The band forms for bank sharding (`parallel/sharded_match.py`): rank i
   of n computes grid rows [i*rows/n, (i+1)*rows/n) of the planes,
   `linearized_response_planes_band` from a quantized map and
   `band_planes_from_image` from the raw image (the quantizer band-sharded
   too); one all-gather along the rows reassembles the full planes.

Shapes and padding match the JAX version byte for byte, so flat offsets and
feature triplets computed for one index the other.
"""

from __future__ import annotations

import numpy as np
import torch

_BIN_DIST = np.minimum(
    (np.arange(8)[:, None] - np.arange(8)[None, :]) % 8,
    (np.arange(8)[None, :] - np.arange(8)[:, None]) % 8,
)
SIMILARITY = np.maximum(4 - _BIN_DIST, 0).astype(np.uint8)  # [8(ori), 8(bit)]
# RESPONSE_LUT[o, s] = max over set bits b of byte s of SIMILARITY[o, b]
_BITS = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1  # [256, 8]
RESPONSE_LUT = np.max(SIMILARITY[:, None, :] * _BITS[None], axis=2).astype(np.uint8)


def _spread_axis(x: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = t - 1
    padded = torch.cat([x, x.new_zeros(pad_shape)], dim=dim)
    out = x.clone()
    for d in range(1, t):
        out |= padded.narrow(dim, d, n)
    return out


def spread_orientations(quantized: torch.Tensor, t: int) -> torch.Tensor:
    """OR-spread [H, W] uint8 orientation bytes over the forward T x T window
    (zeros past the image edge). Returns [H, W] uint8."""
    return _spread_axis(_spread_axis(quantized, t, 0), t, 1)


def response_maps(spread: torch.Tensor) -> torch.Tensor:
    """[...] uint8 spread bytes -> [8, ...] uint8 responses 0..4 (pointwise,
    so any layout works)."""
    lut = torch.as_tensor(RESPONSE_LUT, device=spread.device)
    return lut[:, spread.long()]


def linear_plane_shape(h: int, w: int, t: int, max_cells: int):
    """(cells_h, cells_w, rows, stride) of the padded grid planes.

    rows and stride hold the grid plus the bank's largest feature shift, so
    every shifted read stays in bounds. The row count keeps the JAX
    version's floor of 32 cells and 8-row alignment, and the stride its
    128-lane alignment, so both layouts are the same bytes."""
    ch, cw = h // t, w // t
    rows = int(np.ceil((max(ch, 32) + max_cells) / 8.0)) * 8
    stride = int(np.ceil((cw + max_cells) / 128.0)) * 128
    return ch, cw, rows, stride


def linearized_response_planes(quant: torch.Tensor, t: int, max_cells: int) -> torch.Tensor:
    """quant: [H, W] uint8 one-hot orientations (H, W multiples of T) ->
    planes [8, T, T, rows, stride] uint8, where
    planes[o, ry, rx, gy, gx] = response[o] at pixel (gy*T + ry, gx*T + rx)."""
    h, w = quant.shape
    ch, cw, rows, stride = linear_plane_shape(h, w, t, max_cells)
    spread = spread_orientations(quant, t)
    s = spread.reshape(ch, t, cw, t).permute(1, 3, 0, 2)  # [T, T, ch, cw]
    resp = response_maps(s)  # [8, T, T, ch, cw]
    planes = resp.new_zeros((8, t, t, rows, stride))
    planes[..., :ch, :cw] = resp
    return planes


def feature_flat_offsets(
    xs: np.ndarray, ys: np.ndarray, oris: np.ndarray, t: int, rows: int, stride: int
) -> np.ndarray:
    """Flat offsets into planes viewed as [8*T*T*rows*stride] for features at
    (x, y, ori): the response at grid cell (gy, gx) is at
    offset + gy*stride + gx."""
    ry = ys % t
    rx = xs % t
    sy = ys // t
    sx = xs // t
    plane = (oris * t + ry) * t + rx
    return (plane * rows + sy) * stride + sx


def linearize(resp: torch.Tensor, t: int, max_cells: int) -> torch.Tensor:
    """Grid-stride re-layout of response maps: resp [8, H, W] uint8 (H, W
    multiples of T) -> planes [8, T, T, rows, stride] with
    planes[o, ry, rx, gy, gx] = resp[o, gy*T + ry, gx*T + rx], zero-padded
    to the plane shape."""
    o, h, w = resp.shape
    ch, cw, rows, stride = linear_plane_shape(h, w, t, max_cells)
    planes = resp.new_zeros((o, t, t, rows, stride))
    planes[..., :ch, :cw] = resp.reshape(o, ch, t, cw, t).permute(0, 2, 4, 1, 3)
    return planes


def _band_planes(spread: torch.Tensor, t: int, cw: int, stride: int) -> torch.Tensor:
    """Spread bytes of a band [bh*T, cw*T] -> its planes [8, T, T, bh, stride]."""
    bh = spread.shape[0] // t
    s = spread.reshape(bh, t, cw, t).permute(1, 3, 0, 2)  # [T, T, bh, cw]
    resp = response_maps(s)
    planes = resp.new_zeros((8, t, t, bh, stride))
    planes[..., :cw] = resp
    return planes


def _band_rows(rows: int, n_bands: int) -> int:
    if rows % n_bands:
        raise ValueError(f"rows {rows} not divisible by n_bands {n_bands}")
    return rows // n_bands


def linearized_response_planes_band(
    quant: torch.Tensor, t: int, max_cells: int, band: int, n_bands: int
) -> torch.Tensor:
    """Band `band` of n_bands of `linearized_response_planes`: grid rows
    [band*rows/n_bands, (band+1)*rows/n_bands). quant: [H, W] uint8, cropped
    here to multiples of T. Rows past the real grid see zero spread bytes,
    as the full planes' padding. Returns [8, T, T, rows/n_bands, stride]."""
    h, w = quant.shape
    h -= h % t
    w -= w % t
    ch, cw, rows, stride = linear_plane_shape(h, w, t, max_cells)
    bh = _band_rows(rows, n_bands)
    spread = spread_orientations(quant[:h, :w], t)
    padded = spread.new_zeros((rows * t, w))
    padded[:h] = spread
    return _band_planes(padded[band * bh * t : (band + 1) * bh * t], t, cw, stride)


# image rows above and below a band's slice that cover the quantizers'
# receptive field (color: 7x7 blur 3, Sobel 1, vote 1; normals: shift 1,
# vote 1)
_HALO = 8


def band_planes_from_image(
    img: torch.Tensor, t: int, max_cells: int, band: int, n_bands: int, quantize_fn
) -> torch.Tensor:
    """Band `band` of n_bands of the planes computed from the raw image
    (img [H, W, ...]): the quantizer runs only on the image rows the band's
    spread needs, plus an 8-row halo, so quantization is band-sharded too.

    The quantizers pad stage by stage (pad, blur, pad, Sobel), so a slice
    padded wider would differ from the full path at the true image edges.
    The slice is therefore clamped to [0, H]: the first and last bands'
    slices start and end at the real image boundary, the quantizer's own
    padding applies there, and every row equals the quantized full image's.
    Rows past the T-cropped height are forced to orientation 0, as the full
    path crops and zero-pads. quantize_fn: image slice -> (orientations, _),
    e.g. gradients.quantize_color_gradients or normals.quantize_normals.
    Returns [8, T, T, rows/n_bands, stride] uint8."""
    h_img, w_img = img.shape[:2]
    h = h_img - h_img % t
    w = w_img - w_img % t
    ch, cw, rows, stride = linear_plane_shape(h, w, t, max_cells)
    bh = _band_rows(rows, n_bands)
    bh_px = bh * t
    need = bh_px + t  # the spread of the band's rows reads t-1 rows below it
    sh = min(need + 2 * _HALO, h_img)
    start = min(max(band * bh_px - _HALO, 0), h_img - sh)
    quant = quantize_fn(img[start : start + sh])[0][:, :w]
    # the band's rows [band*bh_px, band*bh_px + need) of the quantized full
    # image (start <= band*bh_px); rows past the slice stay zero, and so do
    # the rows past the T-cropped image
    got = quant[band * bh_px - start :][: max(0, min(need, h - band * bh_px))]
    want = quant.new_zeros((need, w))
    want[: got.shape[0]] = got
    return _band_planes(spread_orientations(want, t)[:bh_px], t, cw, stride)
