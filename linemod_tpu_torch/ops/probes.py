"""The JAX package's two Pallas layout probes, as CUDA kernels with plain
PyTorch twins (counterparts of the `kernel`s in `scripts/test_bitcast.py`
and `scripts/test_u8_roll.py`). No detection path runs them.

- `bitcast_u8_to_i32(x)`: uint8 [4R, C] -> int32 [R, C]; word (r, c) packs
  rows 4r..4r+3 of column c, row 4r in the least significant byte (the
  packing pltpu.bitcast gives); `bitcast_i32_to_u8` undoes it.
- `roll2d_u8(x, sy, sx)`: uint8 [H, W] rolled by sy rows and sx columns,
  np.roll(np.roll(x, sy, 0), sx, 1).

As in `ops/similarity_cuda.py`: a wrapper given a CUDA tensor launches its
kernel from `csrc/probes.cu` or raises, given a CPU tensor it runs the plain
twin, and each launch adds one to the wrapper's `launches` count.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bitcast_u8_to_i32": [_P, _I, _I, _P, _P],
    "bitcast_i32_to_u8": [_P, _I, _I, _P, _P],
    "roll2d_u8": [_P, _I, _I, _I, _I, _P, _P],
}
_MAX_ELEMENTS = 2**31 - 1


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load `csrc/probes.cu`."""
    return cuda_lib.load("probes", _SIGNATURES)


def _check(name, x, dtype):
    if x.dtype != dtype or x.dim() != 2:
        raise ValueError(f"{name}: want 2-D {dtype}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if 4 * x.numel() > _MAX_ELEMENTS:
        raise ValueError(f"{name} exceeds int32 indexing")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(fn: str, device, *args) -> None:
    cuda_lib.launch("probes", _SIGNATURES, fn, device, *args)


# ------------------------------------------------------------ plain twins ---

def bitcast_u8_to_i32_plain(x: torch.Tensor) -> torch.Tensor:
    r, c = x.shape
    b = x.reshape(r // 4, 4, c).long()
    w = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def bitcast_i32_to_u8_plain(w: torch.Tensor) -> torch.Tensor:
    r4, c = w.shape
    v = w.long() & 0xFFFFFFFF
    b = torch.stack([(v >> (8 * k)) & 0xFF for k in range(4)], dim=1)
    return b.reshape(4 * r4, c).to(torch.uint8)


def roll2d_u8_plain(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    h, w = x.shape
    rows = (torch.arange(h, device=x.device) - sy) % h
    cols = (torch.arange(w, device=x.device) - sx) % w
    return x[rows][:, cols]


# --------------------------------------------------------------- wrappers ---

def bitcast_u8_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint8 [4R, C] -> int32 [R, C], rows 4r..4r+3 packed LSB first."""
    _check("x", x, torch.uint8)
    if x.shape[0] % 4:
        raise ValueError(f"rows must be a multiple of 4, got {x.shape[0]}")
    if x.device.type == "cpu":
        return bitcast_u8_to_i32_plain(x)
    out = torch.empty((x.shape[0] // 4, x.shape[1]), dtype=torch.int32, device=x.device)
    if out.numel():
        _launch("bitcast_u8_to_i32", x.device, x.data_ptr(), out.shape[0], out.shape[1], out.data_ptr())
        bitcast_u8_to_i32.launches += 1
    return out


bitcast_u8_to_i32.launches = 0


def bitcast_i32_to_u8(w: torch.Tensor) -> torch.Tensor:
    """int32 [R, C] -> uint8 [4R, C], the inverse of bitcast_u8_to_i32."""
    _check("w", w, torch.int32)
    if w.device.type == "cpu":
        return bitcast_i32_to_u8_plain(w)
    out = torch.empty((4 * w.shape[0], w.shape[1]), dtype=torch.uint8, device=w.device)
    if out.numel():
        _launch("bitcast_i32_to_u8", w.device, w.data_ptr(), w.shape[0], w.shape[1], out.data_ptr())
        bitcast_i32_to_u8.launches += 1
    return out


bitcast_i32_to_u8.launches = 0


def roll2d_u8(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """uint8 [H, W] rolled by sy rows and sx columns (any integers)."""
    _check("x", x, torch.uint8)
    if x.device.type == "cpu":
        return roll2d_u8_plain(x, sy, sx)
    h, w = x.shape
    out = torch.empty_like(x)
    if out.numel():
        _launch("roll2d_u8", x.device, x.data_ptr(), h, w, sy % h, sx % w, out.data_ptr())
        roll2d_u8.launches += 1
    return out


roll2d_u8.launches = 0
