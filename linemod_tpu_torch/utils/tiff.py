"""TIFF reading, as `cv2.imread` reads TIFF files through libtiff.

`read_tiff(path, mode)` takes the first image of a little-endian (`II*\\0`)
or big-endian (`MM\\0*`) file, in strips (PlanarConfiguration 1), of
PhotometricInterpretation MinIsBlack or RGB with at most one extra sample
(an alpha, named by ExtraSamples or not), BitsPerSample 8 or 16
(unsigned) or 32-bit IEEE float gray, Compression 1 (none), 5 (LZW), 8 or
32946 (Deflate) or 32773 (PackBits), Predictor 1, 2 (horizontal, at 8 and
16 bits) or 3 (floating point, on float files).

What OpenCV does with those samples, and so this reader:

- mode "color" (`cv2.IMREAD_COLOR`) goes through libtiff's RGBA reader
  (`TIFFReadRGBAStrip`): 16-bit gray keeps its high byte, 16-bit color is
  rounded to 8 bits as `(v + 128) // 257`, an unassociated alpha
  (ExtraSamples 2) premultiplies the color as `(v a + 127) // 255`, and
  the alpha is then dropped; a float file gives nothing there (cv2.imread
  returns None), so it raises;
- mode "anydepth" (`cv2.IMREAD_ANYDEPTH`): 8-bit files and 16-bit gray +
  alpha take that same RGBA route and then imread's gray
  (`utils/imconvert.gray`); other 16-bit and float files are read as they
  are, a color one turned gray by imread's formula at 16 bits, its alpha
  ignored.

libtiff applies the Predictor tag only with the codecs that take one (LZW
and Deflate); an uncompressed or PackBits file's Predictor is ignored, as
libtiff ignores it. Predictor 3 (floating point) is read on float files.

Deflate strips are inflated by Python's zlib; LZW, PackBits and the
predictor are host C++ (`csrc/tiff_decode.cpp`, built by g++ at first use
into `build/host/`, utils/hostlib). Everything else raises a ValueError
that names the file, the tag and its value: BigTIFF, tiles, planar
configuration 2, palette, MinIsWhite, CMYK, YCbCr and CIELab images, JPEG,
old JPEG, CCITT, LZMA, ZSTD, WebP and other compressions, other bit depths
and sample formats, a predictor on other bit depths than its own, a
FillOrder or an Orientation other than 1, and strips that end early.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from . import hostlib, imconvert

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF_SIGNATURES = (b"II+\x00", b"MM\x00+")
# tag number -> name, for the tags this reader reads or refuses
TAGS = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
        262: "PhotometricInterpretation", 266: "FillOrder", 273: "StripOffsets", 274: "Orientation", 277: "SamplesPerPixel", 278: "RowsPerStrip",
        279: "StripByteCounts", 284: "PlanarConfiguration", 317: "Predictor", 322: "TileWidth", 338: "ExtraSamples",
        339: "SampleFormat"}
_TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_PREDICTED = (5, 8, 32946)  # the codecs libtiff applies a Predictor to
_COLORS = {1: 1, 2: 3}  # PhotometricInterpretation MinIsBlack, RGB -> color samples
_LZW_ERRORS = {1: "LZW data ends before the strip's rows", 2: "corrupt LZW code", 3: "old-style LZW is not decoded"}
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_library = []


def _load():
    """csrc/tiff_decode.cpp, built by g++ into build/host/ at first use. A
    failed build raises."""
    with _lock:
        if not _library:
            lib = hostlib.load("tiff_decode", _CXX_FLAGS)
            for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
                fn.restype = ctypes.c_int
            lib.tiff_unpredict.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.tiff_unpredict.restype = None
            lib.tiff_unpredict_float.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int]
            lib.tiff_unpredict_float.restype = None
            _library.append(lib)
        return _library[0]


def read_tiff(path: str, mode: str) -> np.ndarray:
    """Decode a TIFF file as cv2.imread does: mode "color" -> BGR uint8
    [H, W, 3]; "anydepth" -> gray [H, W] at the file's depth (uint8,
    uint16 or float32)."""
    with open(path, "rb") as f:
        blob = f.read()
    return decode_tiff(blob, mode, path)


def _tags(blob: bytes, name: str) -> tuple:
    """(byte order, {tag: tuple of values}) of the first IFD."""
    if blob[:4] in BIGTIFF_SIGNATURES:
        raise ValueError(f"{name}: BigTIFF is not decoded")
    if blob[:4] not in SIGNATURES or len(blob) < 8:
        raise ValueError(f"{name}: not a TIFF file")
    end = "<" if blob[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(end + "I", blob, 4)
    if ifd + 2 > len(blob):
        raise ValueError(f"{name}: TIFF directory past the end of the file")
    (count,) = struct.unpack_from(end + "H", blob, ifd)
    tags = {}
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(blob):
            raise ValueError(f"{name}: TIFF directory past the end of the file")
        tag, kind, n = struct.unpack_from(end + "HHI", blob, at)
        if kind not in _TYPE_FORMATS:
            continue
        size = _TYPE_SIZES[kind] * n
        offset = at + 8 if size <= 4 else struct.unpack_from(end + "I", blob, at + 8)[0]
        if offset + size > len(blob):
            raise ValueError(f"{name}: TIFF tag {TAGS.get(tag, tag)} past the end of the file")
        tags[tag] = struct.unpack_from(f"{end}{n}{_TYPE_FORMATS[kind]}", blob, offset)
    return end, tags


def _refuse(name: str, tag: int, value) -> ValueError:
    return ValueError(f"{name}: TIFF {TAGS[tag]} {value} is not decoded")


def _strips(blob: bytes, tags: dict, compression: int, h: int, row_bytes: int, name: str) -> bytes:
    """The image's h rows of row_bytes bytes, every strip decompressed."""
    offsets, counts = tags.get(273), tags.get(279)
    if not offsets or not counts or len(offsets) != len(counts):
        raise ValueError(f"{name}: TIFF StripOffsets / StripByteCounts missing or of different lengths")
    per = min(tags.get(278, (h,))[0] or h, h)
    if len(offsets) < -(-h // per):
        raise ValueError(f"{name}: TIFF has {len(offsets)} strips, {h} rows of {per} a strip need more")
    lib = _load()
    out = bytearray()
    for i in range(-(-h // per)):
        want = min(per, h - i * per) * row_bytes
        data = blob[offsets[i] : offsets[i] + counts[i]]
        if compression == 1:
            strip = data[:want]
            err = 0 if len(strip) == want else 1
        elif compression in (8, 32946):
            try:
                strip = zlib.decompressobj().decompress(data, want)
            except zlib.error as e:
                raise ValueError(f"{name}: corrupt Deflate data in strip {i}: {e}") from e
            err = 0 if len(strip) == want else 1
        else:
            buf = ctypes.create_string_buffer(want)
            decode = lib.tiff_lzw_decode if compression == 5 else lib.tiff_packbits_decode
            err = decode(data, len(data), buf, want)
            strip = buf.raw
        if err:
            reason = _LZW_ERRORS[err] if compression == 5 else "strip data ends before its rows"
            raise ValueError(f"{name}: {reason} (strip {i}, {_COMPRESSIONS[compression]})")
        out += strip
    return bytes(out)


def decode_tiff(blob: bytes, mode: str, name: str = "<bytes>") -> np.ndarray:
    """`read_tiff` on a file's bytes; `name` goes into the errors."""
    imconvert.check_mode(mode)
    end, tags = _tags(blob, name)

    def one(tag, default=None):
        values = tags.get(tag)
        if values is None:
            if default is None:
                raise ValueError(f"{name}: TIFF {TAGS[tag]} missing")
            return default
        return values[0]

    w, h = one(256), one(257)
    if 322 in tags:
        raise _refuse(name, 322, one(322))
    photometric = one(262)
    if photometric not in _COLORS:
        raise _refuse(name, 262, photometric)
    compression = one(259, 1)
    if compression not in _COMPRESSIONS:
        raise _refuse(name, 259, compression)
    for tag in (266, 274, 284):
        if one(tag, 1) != 1:
            raise _refuse(name, tag, one(tag))
    spp = one(277, 1)
    extras = tags.get(338, ())
    colors = _COLORS[photometric]
    if spp - colors not in (0, 1) or (extras and len(extras) != spp - colors):
        raise _refuse(name, 277, f"{spp} with ExtraSamples {extras}")
    bits = tags.get(258, (1,))
    if len(set(bits)) != 1:
        raise _refuse(name, 258, bits)
    bits = bits[0]
    sample_format = one(339, 1)
    if (bits, sample_format) not in ((8, 1), (16, 1)) and not (bits == 32 and sample_format == 3 and spp == 1):
        raise _refuse(name, 258, f"{bits} (SampleFormat {sample_format}, SamplesPerPixel {spp})")
    # libtiff applies a predictor only with the codecs that take one
    predictor = one(317, 1) if compression in _PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and bits == 32) or (predictor == 3 and bits != 32):
        raise _refuse(name, 317, f"{predictor} at {bits} bits")
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: TIFF size {w}x{h}")
    if bits == 32 and mode == "color":
        raise ValueError(f"{name}: a float TIFF read as color (cv2.imread returns nothing there)")

    data = _strips(blob, tags, compression, h, w * spp * bits // 8, name)
    dtype = np.dtype({8: "u1", 16: "u2", 32: "f4"}[bits]).newbyteorder(end)
    px = np.frombuffer(data, dtype).astype(dtype.newbyteorder("=")).reshape(h, w, spp)
    if predictor == 2:
        _load().tiff_unpredict(px.ctypes.data, h, w * spp, spp, bits // 8)
    elif predictor == 3:  # on the bytes as stored, whatever the byte order
        raw = np.frombuffer(data, np.uint8).copy()
        _load().tiff_unpredict_float(raw.ctypes.data, h, w * spp, spp)
        px = raw.view(">f4").astype(np.float32).reshape(h, w, spp)
    gray_alpha = colors == 1 and spp == 2  # OpenCV reads it through the RGBA route at any depth
    if bits == 32 or (bits == 16 and mode == "anydepth" and not gray_alpha):  # read as they are
        return imconvert.convert(px[:, :, :colors], "anydepth", "rgb")
    # libtiff's RGBA route
    if colors == 1:  # the gray's high byte; a gray alpha is ignored
        return imconvert.convert(imconvert.high_byte(px[:, :, :1]), mode)
    rgb, a = px[:, :, :3].astype(np.int64), px[:, :, 3:].astype(np.int64)
    if bits == 16:  # libtiff's Bitdepth16To8
        rgb, a = (rgb + 128) // 257, (a + 128) // 257
    if extras[:1] == (2,):  # an unassociated alpha premultiplies the color
        rgb = (rgb * a + 127) // 255
    return imconvert.convert(rgb.astype(np.uint8), mode, "rgb")
