"""Host-side ingest (counterpart of `linemod_tpu/utils/native.py`).

- `quantize_frame`: the gradient quantizer in host C++ (`csrc/quantize.cpp`,
  built by g++ at first use, utils/hostlib), equal bit for bit to the
  reference's `native/quantize.cpp`. The host-quantize route
  (`PoseDetection(host_quant=True)`) uploads its two u8 maps in place of
  the color frame.
- `decode_png`: one PNG as stored (RGB or gray, 8 or 16 bits).
- `NativeFrameLoader`: a PNG RGB-D sequence, decoded one frame ahead on a
  background thread, so the decode of frame i+1 overlaps the processing of
  frame i. The decode is `utils/png.read_png`: its file read, its zlib
  inflate and its C++ unfilter release the interpreter lock.
"""

from __future__ import annotations

import ctypes
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import hostlib
from .png import _SIGNATURE, read_png

# the reference's flags (native/Makefile); no FMA contraction may be enabled
QUANTIZE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-fopenmp", "-shared")
_lock = threading.Lock()
_quantize = []


def _load_quantize():
    with _lock:
        if not _quantize:
            fn = hostlib.load("quantize", QUANTIZE_FLAGS).linemod_quantize_frame
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = None
            _quantize.append(fn)
        return _quantize[0]


def quantize_frame(color_bgr: np.ndarray) -> tuple:
    """The one-hot orientation maps of a BGR uint8 [H, W, 3] frame at both
    pyramid levels, on the host: (quant0 [H, W] u8, quant1 [H/2, W/2] u8,
    the second quantized on the 2x2-average downsample)."""
    color_bgr = np.ascontiguousarray(color_bgr, np.uint8)
    if color_bgr.ndim != 3 or color_bgr.shape[2] != 3 or min(color_bgr.shape[:2]) < 2:
        raise ValueError(f"quantize_frame takes a BGR frame [H >= 2, W >= 2, 3], got {color_bgr.shape}")
    h, w = color_bgr.shape[:2]
    q0 = np.empty((h, w), np.uint8)
    q1 = np.empty((h // 2, w // 2), np.uint8)
    _load_quantize()(color_bgr.ctypes.data, w, h, q0.ctypes.data, q1.ctypes.data)
    return q0, q1


def decode_png(path: str) -> np.ndarray:
    """One non-interlaced gray or RGB PNG as stored: uint8 [H, W, 3] in RGB
    order (8 bits), uint8 [H, W] or uint16 [H, W] (gray of 8 or 16 bits).
    Any other file raises IOError."""
    try:
        with open(path, "rb") as f:
            head = f.read(26)
        if len(head) == 26 and head[:8] == _SIGNATURE and head[12:16] == b"IHDR":
            depth, ctype = head[24], head[25]
            if ctype == 2 and depth == 8:
                return np.ascontiguousarray(read_png(path, "color")[:, :, ::-1])
            if ctype == 0 and depth in (8, 16):
                return read_png(path, "anydepth")
    except (OSError, ValueError, zlib.error) as e:
        raise IOError(f"PNG decode failed: {path}: {e}") from e
    raise IOError(f"PNG decode failed: {path}: not an 8-bit RGB or 8/16-bit gray PNG")


def _frame_path(template: str, i: int) -> str:
    return template % i if "%" in template else template


class NativeFrameLoader:
    """An RGB-D PNG sequence, `img_template % i` and `depth_template % i` for
    i = 0, 1, ..., up to the first frame whose color or depth file does not
    exist. Yields (color BGR uint8 [H, W, 3], depth uint16 [H, W]) of
    `height` x `width`; a frame of another size, or a file that does not
    decode, raises from `next`. One frame is decoded ahead on a background
    thread: frame i+1's decode starts when frame i is handed out. `close()`
    (idempotent) waits for the thread."""

    def __init__(self, img_template: str, depth_template: str, width: int = 640, height: int = 480):
        self.img_template = img_template
        self.depth_template = depth_template
        self.width = width
        self.height = height
        self._index = 0
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="frame-prefetch")
        self._next = self._pool.submit(self._load, 0)

    def _load(self, i: int):
        img_path = _frame_path(self.img_template, i)
        depth_path = _frame_path(self.depth_template, i)
        if not (os.path.exists(img_path) and os.path.exists(depth_path)):
            return None
        color = read_png(img_path, "color")
        depth = read_png(depth_path, "anydepth").astype(np.uint16, copy=False)
        if color.shape != (self.height, self.width, 3) or depth.shape != (self.height, self.width):
            raise ValueError(
                f"frame {i}: color {color.shape} and depth {depth.shape}, the loader reads "
                f"{self.height}x{self.width}"
            )
        return color, depth

    def __iter__(self):
        return self

    def __next__(self):
        pending, self._next = self._next, None
        frame = None if pending is None else pending.result()
        if frame is None:
            self.close()
            raise StopIteration
        self._index += 1
        self._next = self._pool.submit(self._load, self._index)
        return frame

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._next = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
