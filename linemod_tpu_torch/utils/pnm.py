"""PNM and PAM reading (P1-P7) with numpy, as `cv2.imread` reads them.

`read_pnm(path, mode)` takes the bitmaps (P1 ASCII, P4 binary), graymaps
(P2, P5) and pixmaps (P3, P6) and PAM (P7) files of tuple type GRAYSCALE
or RGB (or none, by DEPTH 1 or 3). A header's numbers may be separated by
comments (`#` to the end of the line); binary samples are one byte up to
maxval 255 and two big-endian bytes above it. What OpenCV's PxM and PAM
decoders do, and so this reader:

- a bitmap's 1 is black (0) and its 0 white (255);
- binary samples are taken as they are, whatever the maxval;
- ASCII samples above maxval are cut to it, and below 256 scaled to 0..255
  as `v * 255 // maxval` (at 16 bits they stay as they are);
- a PAM RGB file's color frame keeps the file's channel order as B, G, R
  (its gray reads them as R, G, B, as the pixmaps' both do).

Conversions are `utils/imconvert`'s. PAM files with an alpha channel or of
tuple type BLACKANDWHITE, a PAM MAXVAL of 1, a PAM without TUPLTYPE above
MAXVAL 255 (which cv2.imread refuses too), and a file whose data ends
early raise a ValueError that names the file.
"""

from __future__ import annotations

import re

import numpy as np

from . import imconvert

_SPACE = b" \t\r\n\v\f"
_DIGITS = b"0123456789"
_PAM_TUPLES = {b"GRAYSCALE": 1, b"RGB": 3}


class _Reader:
    """Numbers of a PNM header or ASCII body, comments skipped."""

    def __init__(self, blob: bytes, pos: int, name: str):
        self.blob, self.pos, self.name = blob, pos, name

    def number(self) -> int:
        """The next decimal number."""
        blob, n = self.blob, len(self.blob)
        while self.pos < n and (blob[self.pos] in _SPACE or blob[self.pos] == ord("#")):
            if blob[self.pos] == ord("#"):
                while self.pos < n and blob[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                self.pos += 1
        start = self.pos
        while self.pos < n and blob[self.pos] in _DIGITS:
            self.pos += 1
        if self.pos == start:
            raise ValueError(f"{self.name}: premature end of data or a bad number in the PNM file")
        return int(blob[start:self.pos])


def _ascii_body(blob: bytes, pos: int) -> bytes:
    """The ASCII samples from `pos` on, comments blanked."""
    return re.sub(rb"#[^\r\n]*", b" ", blob[pos:])


def _pam_header(blob: bytes, name: str) -> tuple:
    """(width, height, depth, maxval, data offset) of a P7 file."""
    fields = {}
    pos = 2
    while True:
        end = blob.find(b"\n", pos)
        if end < 0:
            raise ValueError(f"{name}: PAM header without ENDHDR")
        line = blob[pos:end].split(b"#")[0].strip()
        pos = end + 1
        if not line:
            continue
        key, _, value = line.partition(b" ")
        if key == b"ENDHDR":
            break
        fields[key] = value.strip()
    try:
        w, h, depth, maxval = (int(fields[k]) for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    except (KeyError, ValueError) as e:
        raise ValueError(f"{name}: PAM header lacks WIDTH, HEIGHT, DEPTH or MAXVAL") from e
    tuple_type = fields.get(b"TUPLTYPE")
    if tuple_type is not None and _PAM_TUPLES.get(tuple_type) != depth:
        raise ValueError(f"{name}: PAM TUPLTYPE {tuple_type.decode(errors='replace')} at DEPTH {depth} is not "
                         "decoded (GRAYSCALE at 1 and RGB at 3 only)")
    if tuple_type is None and maxval > 255:
        raise ValueError(f"{name}: PAM without TUPLTYPE at MAXVAL {maxval} is not decoded (nor by cv2.imread)")
    if depth not in (1, 3):
        raise ValueError(f"{name}: PAM DEPTH {depth} is not decoded (1 and 3 only)")
    if maxval < 2:
        raise ValueError(f"{name}: PAM MAXVAL {maxval} is not decoded")
    return w, h, depth, maxval, pos


def read_pnm(path: str, mode: str) -> np.ndarray:
    """Decode a P1-P7 file as cv2.imread does: mode "color" -> BGR uint8
    [H, W, 3]; "anydepth" -> gray [H, W], uint16 when maxval > 255."""
    with open(path, "rb") as f:
        blob = f.read()
    return decode_pnm(blob, mode, path)


def decode_pnm(blob: bytes, mode: str, name: str = "<bytes>") -> np.ndarray:
    """`read_pnm` on a file's bytes; `name` goes into the errors."""
    imconvert.check_mode(mode)
    if len(blob) < 3 or blob[0] != ord("P") or blob[1] not in b"1234567":
        raise ValueError(f"{name}: not a PNM file")
    kind = blob[1] - ord("0")
    order = "rgb"
    if kind == 7:
        w, h, channels, maxval, pos = _pam_header(blob, name)
        order = "bgr"  # OpenCV's PAM decoder keeps the file's order in a color frame
    else:
        head = _Reader(blob, 2, name)
        w, h = head.number(), head.number()
        maxval = 1 if kind in (1, 4) else head.number()
        pos = head.pos + 1 if kind in (4, 5, 6) else head.pos
        channels = 3 if kind in (3, 6) else 1
    if w <= 0 or h <= 0 or not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM size {w}x{h} or maxval {maxval} out of range")
    count = w * h * channels
    if kind == 1:
        bits = b"".join(_ascii_body(blob, pos).split())
        if len(bits) < count or bits[:count].strip(b"01"):
            raise ValueError(f"{name}: premature end of data or a bad digit in the PNM bitmap")
        px = np.where(np.frombuffer(bits, np.uint8, count) == ord("0"), 255, 0).astype(np.uint8)
    elif kind == 4:
        stride = -(-w // 8)
        if len(blob) < pos + stride * h:
            raise ValueError(f"{name}: premature end of the PNM data")
        bits = np.unpackbits(np.frombuffer(blob, np.uint8, stride * h, pos).reshape(h, stride), axis=1)[:, :w]
        px = np.where(bits == 0, 255, 0).astype(np.uint8)
    elif kind in (2, 3):
        words = _ascii_body(blob, pos).split()
        if len(words) < count or not all(word.isdigit() for word in words[:count]):
            raise ValueError(f"{name}: premature end of data or a bad number in the PNM file")
        px = np.minimum(np.array(words[:count]).astype(np.int64), maxval)
        px = (px * 255 // maxval).astype(np.uint8) if maxval < 256 else px.astype(np.uint16)
    else:
        dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        if len(blob) < pos + count * dtype.itemsize:
            raise ValueError(f"{name}: premature end of the PNM data")
        px = np.frombuffer(blob, dtype, count, pos).astype(dtype.newbyteorder("="))
    px = px.reshape(h, w, channels)
    if mode == "color" or channels == 1:
        return imconvert.convert(px, mode, order)
    return imconvert.gray(px, "rgb")
