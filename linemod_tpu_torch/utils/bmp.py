"""BMP reading, as `cv2.imread` reads BMP files (OpenCV's own BmpDecoder).

`read_bmp(path, mode)` takes BITMAPINFOHEADER, BITMAPV4HEADER and
BITMAPV5HEADER files, bottom-up or top-down, of

- 1-, 4- and 8-bit palettes (BI_RGB), and BI_RLE8 / BI_RLE4 (bottom-up);
  an index past the palette reads black, as OpenCV's zero-filled palette;
- 16-bit pixels: BI_RGB as 5-5-5, BI_BITFIELDS with the 5-5-5 or 5-6-5
  masks (in a BITMAPINFOHEADER only: OpenCV refuses 16-bit bitfields in
  the V4 and V5 headers), each field shifted up without filling its low
  bits, as OpenCV's BGR5x5 conversions do;
- 24-bit and 32-bit pixels (BI_RGB, or BI_BITFIELDS: the masks are
  ignored in a BITMAPINFOHEADER, as OpenCV ignores them, and in a V4 or V5
  header each color's must be one whole byte).

Conversions are `utils/imconvert`'s (a palette's gray is its colors'
gray), except the gray of a V4 / V5 32-bit BI_BITFIELDS file, which
OpenCV computes in float32 and truncates (`bitfields_gray`). The
run-length streams are decoded by host C++ (`csrc/bmp_rle.cpp`, built by
g++ at first use into `build/host/`, utils/hostlib), which follows
OpenCV's decoder step by step. Everything else (OS/2 and other header
sizes, other masks, BI_JPEG / BI_PNG, a run past its row, data that ends
early) raises a ValueError that names the file and the reason.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from . import hostlib, imconvert

SIGNATURE = b"BM"
_HEADERS = {40: "BITMAPINFOHEADER", 108: "BITMAPV4HEADER", 124: "BITMAPV5HEADER"}
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x03E0, 0x001F)
_MASKS_565 = (0xF800, 0x07E0, 0x001F)
_RLE_ERRORS = {1: "a run passes its row's end", 2: "premature end of the run-length data"}
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_library = []


def _rle_decoder():
    """bmp_rle_decode of csrc/bmp_rle.cpp, built by g++ into build/host/ at
    first use. A failed build raises."""
    with _lock:
        if not _library:
            fn = hostlib.load("bmp_rle", _CXX_FLAGS).bmp_rle_decode
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_long,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _library.append(fn)
        return _library[0]


def read_bmp(path: str, mode: str) -> np.ndarray:
    """Decode a BMP file as cv2.imread does: mode "color" -> BGR uint8
    [H, W, 3]; "anydepth" -> uint8 [H, W]."""
    with open(path, "rb") as f:
        blob = f.read()
    return decode_bmp(blob, mode, path)


def _unpack_indices(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Rows of packed 1-, 4- or 8-bit indices [h, stride] -> [h, w]."""
    if bpp == 8:
        return rows[:, :w]
    if bpp == 4:
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(rows.shape[0], -1)[:, :w]
    return np.unpackbits(rows, axis=1)[:, :w]


def _pixels(blob: bytes, name: str) -> tuple:
    """The file's pixels as BGR uint8 [H, W, 3], top row first, and whether
    they came through a V4 / V5 header's 32-bit bitfields (whose gray is
    OpenCV's float one)."""
    if len(blob) < 54 or blob[:2] != SIGNATURE:
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack_from("<I", blob, 10)
    size, w, h, _, bpp, compression, _, _, _, colors_used = struct.unpack_from("<IiiHHIIiiI", blob, 14)
    if size not in _HEADERS:
        raise ValueError(f"{name}: a BMP header of {size} bytes is not decoded ({', '.join(_HEADERS.values())} only)")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: BMP size {w}x{h}")
    allowed = {1: (_RGB,), 4: (_RGB, _RLE4), 8: (_RGB, _RLE8), 16: (_RGB, _BITFIELDS), 24: (_RGB,),
               32: (_RGB, _BITFIELDS)}
    if compression not in allowed.get(bpp, ()):
        raise ValueError(f"{name}: BMP of {bpp} bits with compression {compression} is not decoded")
    if top_down and compression in (_RLE8, _RLE4):
        raise ValueError(f"{name}: a top-down run-length BMP is not decoded")
    masks = struct.unpack_from("<4I", blob, 54) if len(blob) >= 70 else (0, 0, 0, 0)
    if bpp <= 8:
        n_colors = min(colors_used or 1 << bpp, 256)
        if len(blob) < 14 + size + 4 * n_colors:
            raise ValueError(f"{name}: premature end of the BMP palette")
        palette = np.zeros((256, 3), np.uint8)
        palette[:n_colors] = np.frombuffer(blob, np.uint8, 4 * n_colors, 14 + size).reshape(-1, 4)[:, :3]
    stride = (w * bpp + 31) // 32 * 4
    if compression in (_RGB, _BITFIELDS):
        if len(blob) < offset + stride * h:
            raise ValueError(f"{name}: premature end of the BMP data")
        rows = np.frombuffer(blob, np.uint8, stride * h, offset).reshape(h, stride)
        if not top_down:
            rows = rows[::-1]
    if bpp <= 8:
        if compression == _RGB:
            return palette[_unpack_indices(rows, w, bpp)], False
        indices = np.empty((h, w), np.uint8)
        data = blob[offset:]
        err = _rle_decoder()(data, len(data), 8 if compression == _RLE8 else 4, w, h, indices.ctypes.data)
        if err:
            raise ValueError(f"{name}: {_RLE_ERRORS[err]} (BI_RLE{8 if compression == _RLE8 else 4})")
        return palette[indices[::-1]], False
    if bpp == 16:
        if compression == _BITFIELDS and (size != 40 or masks[:3] not in (_MASKS_555, _MASKS_565)):
            raise ValueError(f"{name}: 16-bit BMP masks {tuple(hex(m) for m in masks[:3])} in a "
                             f"{_HEADERS[size]} are not decoded")
        v = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        if compression == _BITFIELDS and masks[:3] == _MASKS_565:
            bgr = (v << 3) & 0xF8, (v >> 3) & 0xFC, (v >> 8) & 0xF8
        else:
            bgr = (v << 3) & 0xF8, (v >> 2) & 0xF8, (v >> 7) & 0xF8
        return np.stack(bgr, axis=2).astype(np.uint8), False
    px = rows[:, : w * bpp // 8].reshape(h, w, bpp // 8)
    if bpp == 32 and compression == _BITFIELDS and size != 40:
        lanes = []
        for mask in masks[2::-1]:  # blue, green, red
            if mask not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
                raise ValueError(f"{name}: 32-bit BMP mask {hex(mask)} in a {_HEADERS[size]} is not decoded "
                                 "(one whole byte a color only)")
            lanes.append(mask.bit_length() // 8 - 1)
        return np.ascontiguousarray(px[:, :, lanes]), True
    return np.ascontiguousarray(px[:, :, :3]), False


def bitfields_gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's gray of a V4 / V5 32-bit BI_BITFIELDS file: float32
    (0.299 R + 0.587 G) + 0.114 B, truncated (held to cv2 over all 2^24
    triples)."""
    b, g, r = (bgr[:, :, i].astype(np.float32) for i in range(3))
    return ((np.float32(0.299) * r + np.float32(0.587) * g) + np.float32(0.114) * b).astype(np.uint8)


def decode_bmp(blob: bytes, mode: str, name: str = "<bytes>") -> np.ndarray:
    """`read_bmp` on a file's bytes; `name` goes into the errors."""
    imconvert.check_mode(mode)
    px, bitfields = _pixels(blob, name)
    if mode == "anydepth" and bitfields:
        return bitfields_gray(px)
    return imconvert.convert(px, mode)
