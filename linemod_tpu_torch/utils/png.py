"""PNG reading and writing with the standard library's zlib and numpy.

Reads frames without OpenCV: every non-interlaced PNG that `cv2.imread`
reads on the command line's path (gray, gray+alpha, RGB, RGBA and palette
images, 1, 2, 4, 8 and 16 bits), converted as OpenCV converts them: a
color frame (`mode="color"`, `cv2.IMREAD_COLOR`) becomes BGR uint8 with
alpha and `tRNS` dropped, gray replicated, 16-bit samples cut to their high
byte and 1/2/4-bit gray scaled to 0..255; a depth frame
(`mode="anydepth"`, `cv2.IMREAD_ANYDEPTH`) is a gray image at its own
depth, uint16 or uint8. The scanlines are unfiltered by the port's host
C++ (`csrc/png_unfilter.cpp`, built with g++ at first use into `build/`
and bound with ctypes); `_unfilter` is its plain numpy version, which the
tests hold it to. `encode_png` writes any format with one chosen filter
on every row; `write_png` writes 8-bit RGB, 8-bit gray and 16-bit gray
with filter 0. Color is in **BGR** order on both sides, as `cv2.imread`
returns it and `cv2.imwrite` takes it: the HSV color check reads BGR
(ops/postprocess.py) and the gradient quantizer breaks exact channel ties
by the first maximum, so the channel order is part of the result.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from . import hostlib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel; the bit depths each color type allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# gray of 1, 2 or 4 bits -> 0..255, as libpng's expand_gray_1_2_4_to_8
_GRAY_SCALE = {1: 255, 2: 85, 4: 17}

_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_library = []


def _load_unfilter():
    """The C++ unfilter (csrc/png_unfilter.cpp), built by g++ into
    build/host/ at first use (utils/hostlib). A failed build raises."""
    with _lock:
        if not _library:
            fn = hostlib.load("png_unfilter", _CXX_FLAGS).png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _library.append(fn)
        return _library[0]


def _check_raw(raw: bytes, h: int, row_bytes: int) -> None:
    if len(raw) < h * (row_bytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {h} rows of {row_bytes + 1} need more")


def unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> [h, row_bytes] u8, in C++.
    bpp: bytes a complete pixel, at least 1."""
    _check_raw(raw, h, row_bytes)
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, row_bytes), np.uint8)
    bad = _load_unfilter()(src.ctypes.data, h, row_bytes, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"bad PNG filter type {src[(bad - 1) * (row_bytes + 1)]} in row {bad - 1}")
    return out


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The plain numpy version of `unfilter` (PNG spec section 9)."""
    _check_raw(raw, h, row_bytes)
    data = np.frombuffer(raw, np.uint8)[: h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ftype = data[y, 0]
        cur = data[y, 1:]
        if ftype == 0:  # None
            row = cur.copy()
        elif ftype == 1:  # Sub: running sum mod 256 along each byte lane
            lanes = cur.reshape(-1, bpp).astype(np.int64)
            row = (np.cumsum(lanes, axis=0) & 255).astype(np.uint8).ravel()
        elif ftype == 2:  # Up
            row = cur + prev
        elif ftype in (3, 4):  # Average, Paeth: left-to-right recurrence
            row = np.zeros(row_bytes, np.int64)
            c = cur.astype(np.int64)
            up = prev.astype(np.int64)
            for i in range(row_bytes):
                left = row[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
                row[i] = (c[i] + pred) & 255
            row = row.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = row
        prev = row
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, row_bytes] -> samples [h, w, channels], uint8 for
    1-8 bits (sub-byte samples unpacked, most significant bits first) or
    uint16 for 16 bits."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # first sample in the high bits
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, :w].reshape(h, w, 1)


def read_png(path: str, mode: str) -> np.ndarray:
    """Decode a non-interlaced PNG as cv2.imread does.

    mode "color" (cv2.IMREAD_COLOR): BGR uint8 [H, W, 3] from any format;
    "anydepth" (cv2.IMREAD_ANYDEPTH): a gray image as [H, W] uint16 (16
    bits) or uint8 (the others; gray+alpha drops the alpha), and a
    ValueError for a color or palette image."""
    if mode not in ("color", "anydepth"):
        raise ValueError(f"unknown PNG read mode {mode!r}")
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    header = palette = None
    idat = []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{path}: unsupported color type {ctype} at {depth} bits")
    gray = ctype in (0, 4)
    if mode == "anydepth" and not gray:
        raise ValueError(f"{path}: a depth frame must be a gray PNG, got color type {ctype}")
    channels = _CHANNELS[ctype]
    row_bytes = -(-w * channels * depth // 8)
    rows = unfilter(zlib.decompress(b"".join(idat)), h, row_bytes, max(1, channels * depth // 8))
    px = _samples(rows, w, channels, depth)
    if ctype == 3:  # palette indices -> RGB; indices past the palette read black, as libpng's
        if palette is None:
            raise ValueError(f"{path}: a palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        px = full[px[:, :, 0]]
    elif gray and depth < 8:
        px = px * np.uint8(_GRAY_SCALE[depth])
    if mode == "anydepth":
        return np.ascontiguousarray(px[:, :, 0])
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if gray:
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(rows, w: int, ctype: int, depth: int, ftype: int = 0, chunks=(), interlace: int = 0) -> bytes:
    """A PNG of w pixels a row whose scanlines' packed bytes are `rows`
    [H, row_bytes], with filter type `ftype` (0-4) on every scanline;
    `chunks` are (kind, body) pairs written before the data (PLTE, tRNS).
    `interlace` goes into the header only: the data stays in row order (a
    file that readers of non-interlaced PNGs must refuse)."""
    h = rows.shape[0]
    raw = np.asarray(rows).reshape(h, -1).astype(np.uint8, copy=False)
    if ftype:
        bpp = max(1, _CHANNELS[ctype] * depth // 8)
        raw = raw.astype(np.int64)
        left = np.pad(raw[:, :-bpp], ((0, 0), (bpp, 0)))
        up = np.pad(raw[:-1], ((1, 0), (0, 0)))
        pred = [left, up, (left + up) >> 1, _paeth(left, up, np.pad(up[:, :-bpp], ((0, 0), (bpp, 0))))][ftype - 1]
        raw = ((raw - pred) & 255).astype(np.uint8)
    scanlines = np.concatenate([np.full((h, 1), ftype, np.uint8), raw], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (
        _SIGNATURE + _chunk(b"IHDR", ihdr) + b"".join(_chunk(k, b) for k, b in chunks)
        + _chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6)) + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Encode BGR uint8 [H, W, 3] as 8-bit RGB, uint8 [H, W] as 8-bit gray
    or uint16 [H, W] as 16-bit gray, with filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, rows = 2, 8, img[:, :, ::-1]
    elif img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, rows = 0, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, rows = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes BGR uint8 [H, W, 3], uint8 [H, W] or uint16 [H, W], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1), w, ctype, depth))
