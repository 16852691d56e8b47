"""JPEG reading without OpenCV.

`read_jpeg(path, mode)` returns what `cv2.imread` returns for a baseline,
extended sequential or progressive Huffman JPEG, bit for bit: mode "color"
(`cv2.IMREAD_COLOR`) gives BGR uint8 [H, W, 3] (a gray file replicated),
mode "anydepth" (`cv2.IMREAD_ANYDEPTH`) gives uint8 [H, W] (the Y plane of
a color file). The EXIF orientation is applied as OpenCV's imread applies
it. The decode is host C++ (`csrc/jpeg_decode.cpp`, built by g++ at first
use into `build/host/`, utils/hostlib): Huffman decoding is sequential, so
it stays on the host as `cv2.imread` keeps it. A file the decoder does not
take (arithmetic-coded, lossless, hierarchical, 12-bit, CMYK/YCCK or
RGB-coded; a progressive file whose scans leave low AC coefficients
unrefined, which libjpeg-turbo smooths; a scan that breaks the JPEG rules)
or whose data ends early raises a ValueError that names the file and the
reason; no call returns an image that differs from OpenCV's.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from . import hostlib

SOI = b"\xff\xd8"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ERR_LEN = 256
_lock = threading.Lock()
_library = []


def _load():
    """(jpeg_header, jpeg_decode) of csrc/jpeg_decode.cpp, built by g++
    into build/host/ at first use. A failed build raises."""
    with _lock:
        if not _library:
            lib = hostlib.load("jpeg_decode", _CXX_FLAGS)
            lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_header.restype = lib.jpeg_decode.restype = ctypes.c_int
            _library.append((lib.jpeg_header, lib.jpeg_decode))
        return _library[0]


def exif_orientation(blob: bytes) -> int:
    """The orientation tag (0x0112) of the first EXIF APP1 segment's IFD0,
    1 when there is none (as OpenCV's ExifReader reads it)."""
    pos = 2
    while pos + 4 <= len(blob) and blob[pos] == 0xFF:
        marker = blob[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        (n,) = struct.unpack(">H", blob[pos + 2 : pos + 4])
        body = blob[pos + 4 : pos + 2 + n]
        pos += 2 + n
        if marker != 0xE1 or body[:6] != b"Exif\0\0":
            continue
        tiff = body[6:]
        if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
            return 1
        end = "<" if tiff[:2] == b"II" else ">"
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        if ifd + 2 > len(tiff):
            return 1
        (count,) = struct.unpack(end + "H", tiff[ifd : ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i : ifd + 14 + 12 * i]
            if len(entry) < 12:
                break
            tag, kind = struct.unpack(end + "HH", entry[:4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(end + "H", entry[8:10])[0]
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: 2 flips left-right, 3 turns by 180
    degrees, 4 flips up-down, 5 transposes, 6 transposes and flips
    left-right, 7 transposes and turns by 180, 8 transposes and flips
    up-down; any other value leaves the image."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(blob: bytes, mode: str, name: str = "<bytes>") -> np.ndarray:
    """`read_jpeg` on the bytes of a file; `name` goes into the errors."""
    if mode not in ("color", "anydepth"):
        raise ValueError(f"unknown JPEG read mode {mode!r}")
    if blob[:2] != SOI:
        raise ValueError(f"{name}: not a JPEG file")
    header, decode = _load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    info = np.zeros(3, np.int32)
    if header(blob, len(blob), info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, _ = (int(v) for v in info)
    gray = mode == "anydepth"
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if decode(blob, len(blob), int(gray), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return apply_orientation(out, exif_orientation(blob))


def read_jpeg(path: str, mode: str) -> np.ndarray:
    """Decode a JPEG file as cv2.imread does: mode "color"
    (cv2.IMREAD_COLOR) -> BGR uint8 [H, W, 3]; "anydepth"
    (cv2.IMREAD_ANYDEPTH) -> uint8 [H, W]."""
    with open(path, "rb") as f:
        blob = f.read()
    return decode_jpeg(blob, mode, path)
