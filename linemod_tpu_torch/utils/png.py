"""PNG reading and writing with the standard library's zlib and numpy.

Reads the fixture frames without OpenCV: non-interlaced PNGs with filters
0-4, 8-bit RGB color and 16-bit grayscale depth. `write_png` writes the same
two formats (filter 0 on every row). Color is in **BGR** order on both
sides, as `cv2.imread` returns it and `cv2.imwrite` takes it: the HSV color
check reads BGR (linemod_tpu/ops/postprocess.py) and the gradient quantizer
breaks exact channel ties by the first maximum, so the channel order is part
of the result.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> (channels, dtype)
_FORMATS = {(2, 8): (3, np.uint8), (0, 16): (1, np.dtype(">u2"))}


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9) -> [h, row_bytes] u8."""
    data = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
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


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: 8-bit RGB -> BGR uint8 [H, W, 3]; 16-bit gray -> uint16 [H, W]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (the port decodes PNG images only)")
    pos = 8
    header = None
    idat = []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if (ctype, depth) not in _FORMATS:
        raise ValueError(f"{path}: unsupported color type {ctype} at {depth} bits")
    channels, dtype = _FORMATS[(ctype, depth)]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = rows.view(dtype).reshape(h, w, channels)
    if channels == 1:
        return img[:, :, 0].astype(np.uint16)
    return np.ascontiguousarray(img[:, :, ::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode BGR uint8 [H, W, 3] as 8-bit RGB, or uint16 [H, W] as 16-bit
    gray, with filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, rows = 2, 8, img[:, :, ::-1]
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, rows = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes BGR uint8 [H, W, 3] or uint16 [H, W], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    scanlines = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
