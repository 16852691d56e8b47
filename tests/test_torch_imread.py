"""The port's frame readers for TIFF (`utils/tiff.py`, host C++
`csrc/tiff_decode.cpp`), PNM/PAM (`utils/pnm.py`) and BMP (`utils/bmp.py`,
host C++ `csrc/bmp_rle.cpp`), their shared conversions
(`utils/imconvert.py`) and the dispatch by leading bytes
(`pipeline/sensors.read_image`) against `cv2.imread` on the CPU, bit for bit.

Files are made from numpy seeds by `cv2.imwrite`, by PIL and by the small
writers below (big-endian TIFF, LZW and PackBits strips, ExtraSamples,
BMP headers, bitfields and run-length streams, PNM headers with comments)
across every compression, predictor, byte order, bit depth, photometric,
header and run kind the readers take. Each must decode under
`IMREAD_COLOR` and `IMREAD_ANYDEPTH` to exactly cv2's dtype, shape and
bytes; where cv2 returns nothing, the reader raises. Every refused kind
raises a ValueError that names the file and the format or the tag.

The gray of a color file is checked over all 2^24 8-bit triples for BMP,
PPM and TIFF (imread's `(1868 B + 9617 G + 4899 R + 2^13) >> 14`) and PNG
(libpng's), and at 16 bits on a seeded sample of 10^6 triples.

`tests/goldens/imread/` and `tests/goldens/imread_ref.npz` (cv2's digest
of each golden in both modes, each refused file with the words its error
must carry, and JAX's `cli detect` / `cli evaluate` lines over the
progressive-JPEG + TIFF sequence and the PPM / BMP + PGM sequence) are
what `chip_smoke.py` holds the card's host to; `make_imread_goldens`
writes them (run `env JAX_PLATFORMS=cpu python tests/test_torch_imread.py`).
"""

import hashlib
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
IMREAD_DIR = os.path.join(REPO, "tests", "goldens", "imread")
IMREAD_REF = os.path.join(REPO, "tests", "goldens", "imread_ref.npz")
JPEG_DIR = os.path.join(REPO, "tests", "goldens", "jpeg")
MODES = (("color", 1), ("anydepth", 2))  # cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH


# -- writers ---------------------------------------------------------------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, ClearCode first, EndOfInformation last),
    each code at the width the decoder reads it with."""
    out = bytearray()
    acc = nbits = 0

    def put(code, width):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 255)

    def width_of(j):  # the j-th code since a clear: the decoder has added max(j - 1, 0) entries
        entries = 258 + max(j - 1, 0)
        return 9 if entries < 511 else 10 if entries < 1023 else 11 if entries < 2047 else 12

    table = {bytes([i]): i for i in range(256)}
    put(256, 9)
    j, nxt, w = 0, 258, b""
    for c in data:
        wc = w + bytes((c,))
        if wc in table:
            w = wc
            continue
        put(table[w], width_of(j))
        j += 1
        table[wc] = nxt
        nxt += 1
        w = bytes((c,))
        if nxt == 4093:
            put(256, width_of(j))
            table = {bytes([i]): i for i in range(256)}
            j, nxt = 0, 258
    if w:
        put(table[w], width_of(j))
        j += 1
    put(257, width_of(j))
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes repeated, the rest literal."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes((257 - run, data[i]))
            i += run
            continue
        start = i
        while i < n and i - start < 128 and not (i + 2 < n and data[i] == data[i + 1] == data[i + 2]):
            i += 1
        out.append(i - start - 1)
        out += data[start:i]
    return bytes(out)


def write_tiff(px, order="<", compression=1, predictor=1, photometric=None, extra=None, rows_per_strip=None,
               tags=(), magic=None) -> bytes:
    """A one-image strip TIFF of samples px [H, W, S] (uint8, uint16 or
    float32) in byte order `order`, each strip compressed as `compression`
    says (1, 5 LZW, 8 / 32946 Deflate, 32773 PackBits; other values store
    the data as is), after the horizontal predictor when `predictor` is 2.
    `tags` adds or replaces (tag, type, values) entries."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, spp = px.shape
    bits = px.dtype.itemsize * 8
    rows_per_strip = rows_per_strip or h
    strips = []
    for y in range(0, h, rows_per_strip):
        chunk = np.array(px[y:y + rows_per_strip])
        if predictor == 2:
            ints = chunk.astype(np.int64)
            ints[:, 1:] = ints[:, 1:] - ints[:, :-1]
            chunk = (ints & ((1 << bits) - 1)).astype(px.dtype)
        raw = chunk.astype(chunk.dtype.newbyteorder(order)).tobytes() if bits > 8 else chunk.tobytes()
        strips.append({5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
                       32773: packbits_encode}.get(compression, lambda b: b)(raw))
    photometric = photometric if photometric is not None else (2 if spp >= 3 else 1)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               273: (4, [0] * len(strips)), 277: (3, [spp]), 278: (4, [rows_per_strip]),
               279: (4, [len(s) for s in strips]), 284: (3, [1])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if px.dtype == np.float32:
        entries[339] = (3, [3] * spp)
    if extra is not None:
        entries[338] = (3, [extra])
    for tag, kind, values in tags:
        if values is None:
            entries.pop(tag, None)
        else:
            entries[tag] = (kind, list(values))
    fmt = {3: "H", 4: "I", 16: "Q"}
    header = (b"II*\x00" if order == "<" else b"MM\x00*") if magic is None else magic
    body = bytearray(header + b"\0\0\0\0")
    offsets = []
    for s in strips:
        offsets.append(len(body))
        body += s + bytes(len(s) % 2)
    entries[273] = (4, offsets)
    blobs = {}
    for tag, (kind, values) in entries.items():
        raw = struct.pack(f"{order}{len(values)}{fmt[kind]}", *values)
        if len(raw) > 4:
            blobs[tag] = len(body)
            body += raw + bytes(len(raw) % 2)
    ifd = len(body)
    body[4:8] = struct.pack(order + "I", ifd)
    body += struct.pack(order + "H", len(entries))
    for tag in sorted(entries):
        kind, values = entries[tag]
        raw = struct.pack(f"{order}{len(values)}{fmt[kind]}", *values)
        value = struct.pack(order + "I", blobs[tag]) if tag in blobs else raw + bytes(4 - len(raw))
        body += struct.pack(order + "HHI", tag, kind, len(values)) + value
    body += b"\0\0\0\0"
    return bytes(body)


def write_bmp(w, h, bpp, data=None, rows=None, palette=None, compression=0, masks=None, header=40, top_down=False):
    """A BMP of `rows` (file order, unpadded bytes) or raw `data`, with a
    BITMAPINFOHEADER (masks after it for BI_BITFIELDS) or a V4 / V5 header
    (masks inside it); `palette` is (b, g, r) entries."""
    if data is None:
        stride = (w * bpp + 31) // 32 * 4
        data = b"".join(r + bytes(stride - len(r)) for r in rows)
    pal = b"".join(bytes((b, g, r, 0)) for (b, g, r) in palette) if palette is not None else b""
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, compression, len(data), 2835,
                       2835, 0 if palette is None else len(palette), 0)
    after = b""
    if header > 40:
        m = tuple(masks or ()) + (0,) * (4 - len(masks or ()))
        info += struct.pack("<4I", *m) + b"sRGB" + bytes(48) + (bytes(16) if header == 124 else b"")
    elif compression == 3 and masks:
        after = struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(after) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + after + pal + data


def rle_stream(rng, w: int, h: int, bits: int, end: bool = True) -> bytes:
    """A seeded BI_RLE8 / BI_RLE4 stream of runs, absolute blocks,
    end-of-lines, deltas and (when `end`) an end-of-bitmap."""
    out = bytearray()
    x = y = 0
    while y < h:
        r, room = rng.random(), w - x
        if r < 0.4 and room > 0:
            n = int(rng.integers(1, min(room, 255) + 1))
            out += bytes((n, int(rng.integers(0, 256))))
            x += n
            if bits == 8 and x == w:
                x, y = 0, y + 1
        elif r < 0.7 and room >= 3:
            n = int(rng.integers(3, min(room, 255) + 1))
            vals = rng.integers(0, 256 if bits == 8 else 16, n)
            if bits == 4:
                vals = np.pad(vals, (0, n % 2))
                vals = (vals[0::2] << 4) | vals[1::2]
            body = bytes(vals.astype(np.uint8))
            out += bytes((0, n)) + body + bytes(len(body) % 2)
            x += n
        elif r < 0.85:
            out += b"\0\0"
            x, y = 0, y + 1
        elif r < 0.95:
            dx, dy = int(rng.integers(0, max(1, w - x))), int(rng.integers(0, 2))
            out += bytes((0, 2, dx, dy))
            x, y = (x + dx) % w, y + dy
        else:
            break
    return bytes(out) + (b"\0\1" if end else b"")


def bmp_rle_file(rng, w, h, bits, end=True) -> bytes:
    palette = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256 if bits == 8 else 16)]
    return write_bmp(w, h, bits, data=rle_stream(rng, w, h, bits, end), palette=palette,
                     compression=1 if bits == 8 else 2)


# -- comparing with cv2 --------------------------------------------------------------


def cv2_decode(blob: bytes, flag: int):
    import cv2

    return cv2.imdecode(np.frombuffer(blob, np.uint8), flag)


def assert_equals_cv2(tmp_path, blob: bytes, name: str = "frame", reader=None):
    """Both modes of the reader (read_image by default) on the file equal
    cv2.imread's dtype, shape and bytes; where cv2 gives nothing, the
    reader raises naming the file."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import read_image

    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    for mode, flag in MODES:
        want = cv2.imread(path, flag)
        if want is None:
            with pytest.raises(ValueError, match=re.escape(path)):
                (reader or read_image)(path, mode)
            continue
        got = (reader or read_image)(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, (mode, got.dtype, got.shape, want.dtype, want.shape)
        assert np.array_equal(got, want), (mode, int((got != want).sum()))


def seeded(kind: str, seed: int = 0, h: int = 37, w: int = 29) -> np.ndarray:
    """Seeded samples of a kind: g8 / g16 gray, c8 / c16 BGR, a8 / a16 BGRA,
    f32 float gray."""
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return rng.normal(0, 300, (h, w)).astype(np.float32)
    dtype = np.uint8 if kind.endswith("8") else np.uint16
    shape = (h, w) + ({"g": (), "c": (3,), "a": (4,)}[kind[0]])
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


# -- the gray of a color file ----------------------------------------------------------


def all_triples() -> np.ndarray:
    """Every 8-bit BGR triple once, as a 4096 x 4096 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("ext", ["bmp", "ppm", "tiff"])
def test_gray_all_triples(tmp_path, ext):
    """imread's gray of a color BMP, PPM and TIFF over all 2^24 triples
    equals imconvert.gray and the reader's; it is not cvtColor's (which
    differs on 43,864 of them)."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import read_image
    from linemod_tpu_torch.utils import imconvert

    img = all_triples()
    path = str(tmp_path / f"all.{ext}")
    assert cv2.imwrite(path, img)
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    assert np.array_equal(imconvert.gray(img), want)
    assert np.array_equal(read_image(path, "anydepth"), want)
    assert np.array_equal(read_image(path, "color"), img)
    assert int((cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) != want).sum()) == 43864


def test_png_gray_all_triples(tmp_path):
    """libpng's gray of a color PNG over all 2^24 triples: truncated, and
    not imread's gray of the other formats."""
    import cv2

    from linemod_tpu_torch.utils import imconvert
    from linemod_tpu_torch.utils.png import encode_png, libpng_gray, read_png

    img = all_triples()
    path = str(tmp_path / "all.png")
    with open(path, "wb") as f:
        f.write(encode_png(img[:, :, ::-1].reshape(4096, -1), 4096, 2, 8))
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    assert np.array_equal(libpng_gray(img[:, :, ::-1]), want)
    assert np.array_equal(read_png(path, "anydepth"), want)
    assert not np.array_equal(imconvert.gray(img), want)
    assert int(want.reshape(-1)[10 + 200 * 256 + 30 * 65536]) == 127  # BGR (10, 200, 30); imread's gray is 128


def sample_16bit(n: int = 1000) -> np.ndarray:
    """n x n seeded uint16 triples, the first rows drawn from 0, 0xFFFF and
    values with low bytes 0x80 and 0xFF."""
    rng = np.random.default_rng(16)
    x = rng.integers(0, 1 << 16, (n, n, 3)).astype(np.uint16)
    special = np.array([0, 0xFFFF, 0x80, 0xFF, 0x1280, 0x12FF, 0xFF80, 0x7FFF], np.uint16)
    x[: n // 10] = rng.choice(special, (n // 10, n, 3))
    x[n // 10 : n // 5] = (x[n // 10 : n // 5] & 0xFF00) | rng.choice(np.array([0x80, 0xFF], np.uint16), (n // 10, n, 3))
    return x


@pytest.mark.parametrize("ext", ["png", "ppm", "tiff"])
def test_gray_16bit_sample(tmp_path, ext):
    """At 16 bits on 10^6 seeded triples: libpng's rounded gray for a PNG,
    imread's 14-bit gray for a PPM and a TIFF; color keeps the high byte
    (PNG, PPM) or rounds by 257 (TIFF, libtiff's RGBA reader)."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import read_image

    x = sample_16bit()
    path = str(tmp_path / f"c16.{ext}")
    assert cv2.imwrite(path, x)
    for mode, flag in MODES:
        want = cv2.imread(path, flag)
        got = read_image(path, mode)
        assert got.dtype == want.dtype and np.array_equal(got, want), (mode, int((got != want).sum()))
    color = cv2.imread(path)
    cut = (x >> 8).astype(np.uint8) if ext != "tiff" else ((x.astype(np.int64) + 128) // 257).astype(np.uint8)
    assert np.array_equal(color, cut)


# -- TIFF ------------------------------------------------------------------------------

TIFF_KINDS = ("g8", "g16", "c8", "c16", "a8", "a16", "f32")
TIFF_COMPRESSIONS = ("NONE", "LZW", "DEFLATE", "ADOBE_DEFLATE", "PACKBITS")


@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS)
@pytest.mark.parametrize("kind", TIFF_KINDS)
def test_tiff_written_by_cv2(tmp_path, kind, compression):
    """cv2.imwrite's TIFFs, every compression, with and without the
    horizontal predictor (the floating-point one for float files; libtiff
    applies either only with LZW and Deflate), strips of 5 rows."""
    import cv2

    img = seeded(kind, TIFF_KINDS.index(kind))
    for predictor in ("NONE", "FLOATINGPOINT") if kind == "f32" else ("NONE", "HORIZONTAL"):
        path = str(tmp_path / f"{kind}.tif")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION, getattr(cv2, "IMWRITE_TIFF_COMPRESSION_" + compression),
                                       cv2.IMWRITE_TIFF_PREDICTOR, getattr(cv2, "IMWRITE_TIFF_PREDICTOR_" + predictor),
                                       cv2.IMWRITE_TIFF_ROWSPERSTRIP, 5])
        with open(path, "rb") as f:
            assert_equals_cv2(tmp_path, f.read(), f"{kind}_{compression}_{predictor}.tif")


PIL_MODES = {"L": "g8", "I;16": "g16", "RGB": "c8", "RGBA": "a8", "LA": "a8", "F": "f32"}


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"])
@pytest.mark.parametrize("mode", sorted(PIL_MODES))
def test_tiff_written_by_pil(tmp_path, mode, compression):
    """PIL's TIFFs: RGBA and LA carry an unassociated alpha (ExtraSamples
    2), which libtiff's RGBA reader premultiplies into the color."""
    from PIL import Image

    img = seeded(PIL_MODES[mode], 7)
    if mode in ("RGB", "RGBA"):
        img = img[:, :, [2, 1, 0, 3][: img.shape[2]]]
    if mode == "LA":
        img = img[:, :, :2]
    path = str(tmp_path / "pil.tif")
    if mode == "I;16":
        Image.frombytes("I;16", img.shape[::-1], img.astype("<u2").tobytes()).save(path, compression=compression)
    else:
        Image.fromarray(img, mode if mode == "LA" else None).save(path, compression=compression)
    with open(path, "rb") as f:
        assert_equals_cv2(tmp_path, f.read(), f"pil_{mode.replace(';', '')}_{compression}.tif")


TIFF_WRITER_CASES = {
    # name: (kind, byte order, compression, predictor, extra sample, rows a strip)
    "g16_mm_lzw_pred": ("g16", ">", 5, 2, None, 7),
    "g16_mm_deflate": ("g16", ">", 32946, 1, None, 16),
    "g16_ii_packbits_pred": ("g16", "<", 32773, 2, None, 4),
    "g8_mm_lzw": ("g8", ">", 5, 1, None, 9),
    "c8_mm_lzw_pred": ("c8", ">", 5, 2, None, 6),
    "c16_mm_deflate_pred": ("c16", ">", 8, 2, None, 37),
    "c16_ii_none": ("c16", "<", 1, 1, None, 3),
    "a8_unassociated": ("a8", "<", 5, 1, 2, 10),
    "a8_associated": ("a8", ">", 1, 1, 1, 10),
    "a8_unspecified": ("a8", "<", 32773, 2, 0, 10),
    "a16_unassociated_mm": ("a16", ">", 32946, 2, 2, 8),
    "a16_associated": ("a16", "<", 5, 1, 1, 8),
    "ga8_unassociated": ("ga8", "<", 8, 1, 2, 11),
    "ga16_mm": ("ga16", ">", 5, 2, 2, 11),
    "f32_mm_deflate": ("f32", ">", 8, 1, None, 5),
    "f32_ii_lzw": ("f32", "<", 5, 1, None, 37),
    "lzw_long": ("c8", "<", 5, 1, None, 0),
}


@pytest.mark.parametrize("name", sorted(TIFF_WRITER_CASES))
def test_tiff_byte_orders_and_extra_samples(tmp_path, name):
    """The writer above: both byte orders, LZW / Deflate / PackBits strips
    of any height, the predictor at 8 and 16 bits, associated, unassociated
    and unspecified alpha, 8- and 16-bit gray + alpha, float gray; and an
    LZW strip long enough to grow its codes to 12 bits and clear its
    table."""
    kind, order, compression, predictor, extra, per = TIFF_WRITER_CASES[name]
    if kind.startswith("ga"):
        img = seeded("a" + kind[2:], 3)[:, :, :2]
    elif name == "lzw_long":
        img = seeded("c8", 4, 96, 160)
    else:
        img = seeded(kind, 3)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[:, :, [2, 1, 0, 3][: img.shape[2]]]  # the file's RGB order
    blob = write_tiff(img, order, compression, predictor, extra=extra, rows_per_strip=per or None)
    assert_equals_cv2(tmp_path, blob, f"{name}.tif")


def test_tiff_lzw_decoder_against_its_encoder():
    """The C++ LZW decoder gives back what the encoder above was given, on
    data long enough to reach 12-bit codes and clear the table; a strip
    whose codes end early or start with an undefined code raises."""
    from linemod_tpu_torch.utils import tiff

    lib = tiff._load()
    rng = np.random.default_rng(5)
    for data in (rng.integers(0, 256, 40000).astype(np.uint8).tobytes(), bytes(70000),
                 rng.integers(0, 4, 60000).astype(np.uint8).tobytes()):
        code = lzw_encode(data)
        import ctypes

        buf = ctypes.create_string_buffer(len(data))
        assert lib.tiff_lzw_decode(code, len(code), buf, len(data)) == 0
        assert buf.raw == data
        assert lib.tiff_lzw_decode(code[: len(code) // 2], len(code) // 2, buf, len(data)) == 1
    bad = bytes([0x80, 0x5F, 0xF0])  # Clear, then code 383 with nothing defined
    assert lib.tiff_lzw_decode(bad, len(bad), ctypes.create_string_buffer(4), 4) == 2


def test_tiff_packbits_decoder_against_its_encoder():
    import ctypes

    from linemod_tpu_torch.utils import tiff

    lib = tiff._load()
    rng = np.random.default_rng(6)
    data = np.repeat(rng.integers(0, 256, 3000), rng.integers(1, 9, 3000)).astype(np.uint8).tobytes()
    code = packbits_encode(data)
    buf = ctypes.create_string_buffer(len(data))
    assert lib.tiff_packbits_decode(code, len(code), buf, len(data)) == 0 and buf.raw == data
    assert lib.tiff_packbits_decode(code[:100], 100, buf, len(data)) == 1


def tiff_refusals() -> dict:
    """{file name: (bytes, words its error names)}: one file a refused TIFF
    kind."""
    g8, c8 = seeded("g8", 1, 12, 16), seeded("c8", 1, 12, 16)[:, :, ::-1]
    return {
        "tiff_tiled.tif": (write_tiff(g8, tags=[(322, 3, [16]), (323, 3, [16])]), "TileWidth 16"),
        "tiff_bigtiff.tif": (b"II+\x00\x08\x00\x00\x00" + bytes(16), "BigTIFF"),
        "tiff_palette.tif": (write_tiff(g8, photometric=3), "PhotometricInterpretation 3"),
        "tiff_miniswhite.tif": (write_tiff(g8, photometric=0), "PhotometricInterpretation 0"),
        "tiff_cmyk.tif": (write_tiff(seeded("a8", 1, 12, 16), photometric=5), "PhotometricInterpretation 5"),
        "tiff_ycbcr.tif": (write_tiff(c8, photometric=6), "PhotometricInterpretation 6"),
        "tiff_cielab.tif": (write_tiff(c8, photometric=8), "PhotometricInterpretation 8"),
        "tiff_jpeg.tif": (write_tiff(c8, compression=7), "Compression 7"),
        "tiff_ojpeg.tif": (write_tiff(c8, compression=6), "Compression 6"),
        "tiff_ccitt.tif": (write_tiff(g8, compression=4), "Compression 4"),
        "tiff_lzma.tif": (write_tiff(g8, compression=34925), "Compression 34925"),
        "tiff_zstd.tif": (write_tiff(g8, compression=50000), "Compression 50000"),
        "tiff_webp.tif": (write_tiff(c8, compression=50001), "Compression 50001"),
        "tiff_planar2.tif": (write_tiff(c8, tags=[(284, 3, [2])]), "PlanarConfiguration 2"),
        "tiff_4bit.tif": (write_tiff(g8, tags=[(258, 3, [4])]), "BitsPerSample 4"),
        "tiff_int16.tif": (write_tiff(seeded("g16", 1, 12, 16), tags=[(339, 3, [2])]), "BitsPerSample 16 .SampleFormat 2"),
        "tiff_float_rgb.tif": (write_tiff(np.zeros((12, 16, 3), np.float32)), "BitsPerSample 32"),
        "tiff_int_float_predictor.tif": (write_tiff(g8, compression=5, tags=[(317, 3, [3])]), "Predictor 3 at 8 bits"),
        "tiff_float_horizontal.tif": (write_tiff(np.zeros((12, 16), np.float32), compression=5, predictor=2),
                                      "Predictor 2 at 32 bits"),
        "tiff_orientation.tif": (write_tiff(g8, tags=[(274, 3, [3])]), "Orientation 3"),
        "tiff_fillorder.tif": (write_tiff(g8, tags=[(266, 3, [2])]), "FillOrder 2"),
        "tiff_two_extra.tif": (write_tiff(seeded("a8", 1, 12, 16)[:, :, :3], photometric=1), "SamplesPerPixel 3"),
        "tiff_short_strip.tif": (write_tiff(g8)[:40], "past the end|ends before"),
    }


@pytest.mark.parametrize("name", sorted(tiff_refusals()))
def test_tiff_refused(tmp_path, name):
    from linemod_tpu_torch.pipeline.sensors import read_image

    blob, words = tiff_refusals()[name]
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    for mode, _ in MODES:
        with pytest.raises(ValueError, match=re.escape(path) + ".*(" + words + ")"):
            read_image(path, mode)


def test_tiff_float_color_raises_where_cv2_gives_nothing(tmp_path):
    import cv2

    from linemod_tpu_torch.utils.tiff import read_tiff

    path = str(tmp_path / "depth.tif")
    assert cv2.imwrite(path, seeded("f32", 2))
    assert cv2.imread(path) is None
    with pytest.raises(ValueError, match=r"depth\.tif: a float TIFF read as color"):
        read_tiff(path, "color")
    assert np.array_equal(read_tiff(path, "anydepth"), cv2.imread(path, cv2.IMREAD_ANYDEPTH))


# -- PNM -------------------------------------------------------------------------------


def pnm_cases() -> dict:
    """{name: file bytes}: P1-P7 at several maxvals, comments in the header."""
    rng = np.random.default_rng(8)
    g, c = rng.integers(0, 256, (9, 13)), rng.integers(0, 256, (9, 13, 3))
    g16, c16 = rng.integers(0, 65536, (9, 13)), rng.integers(0, 65536, (9, 13, 3))
    bits = rng.integers(0, 2, (9, 13))

    def ascii(v):
        return "\n".join(" ".join(str(int(x)) for x in row.ravel()) for row in v).encode() + b"\n"

    out = {
        "p1.pbm": b"P1\n# a comment\n13 9\n" + ascii(bits),
        "p1_packed.pbm": b"P1\n13 9\n" + b"\n".join(b"".join(b"%d" % x for x in row) for row in bits) + b"\n",
        "p4.pbm": b"P4 13 9\n" + np.packbits(bits, axis=1).tobytes(),
        "p2.pgm": b"P2\n13 9\n255\n" + ascii(g),
        "p2_maxval100.pgm": b"P2\n13 9 # w h\n100\n" + ascii(np.minimum(g, 120)),
        "p2_16.pgm": b"P2\n13 9\n1000\n" + ascii(np.minimum(g16, 1200)),
        "p3.ppm": b"P3\n13 9\n255\n" + ascii(c),
        "p3_maxval7.ppm": b"P3 13 9 7\n" + ascii(c % 9),
        "p5.pgm": b"P5\n13 9\n255\n" + g.astype(np.uint8).tobytes(),
        "p5_maxval100.pgm": b"P5\n# maker\n13 9\n100\n" + g.astype(np.uint8).tobytes(),
        "p5_16.pgm": b"P5\n13 9\n65535\n" + g16.astype(">u2").tobytes(),
        "p5_maxval1000.pgm": b"P5 13 9 1000\n" + g16.astype(">u2").tobytes(),
        "p6.ppm": b"P6\n13 9\n255\n" + c.astype(np.uint8).tobytes(),
        "p6_16.ppm": b"P6\n13 9\n65535\n" + c16.astype(">u2").tobytes(),
        "p7_gray.pam": b"P7\nWIDTH 13\nHEIGHT 9\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n"
                       + g.astype(np.uint8).tobytes(),
        "p7_gray16.pam": b"P7\nWIDTH 13\nHEIGHT 9\nDEPTH 1\nMAXVAL 65535\nTUPLTYPE GRAYSCALE\nENDHDR\n"
                         + g16.astype(">u2").tobytes(),
        "p7_rgb.pam": b"P7\n# a comment\nWIDTH 13\nHEIGHT 9\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n"
                      + c.astype(np.uint8).tobytes(),
        "p7_rgb16.pam": b"P7\nWIDTH 13\nHEIGHT 9\nDEPTH 3\nMAXVAL 65535\nTUPLTYPE RGB\nENDHDR\n"
                        + c16.astype(">u2").tobytes(),
        "p7_no_tupltype.pam": b"P7\nWIDTH 13\nHEIGHT 9\nDEPTH 3\nMAXVAL 200\nENDHDR\n" + c.astype(np.uint8).tobytes(),
    }
    return out


@pytest.mark.parametrize("name", sorted(pnm_cases()))
def test_pnm_equals_cv2(tmp_path, name):
    assert_equals_cv2(tmp_path, pnm_cases()[name], name)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "bgr8", "bgr16"])
def test_pnm_written_by_cv2(tmp_path, kind):
    import cv2

    img = seeded({"gray8": "g8", "gray16": "g16", "bgr8": "c8", "bgr16": "c16"}[kind], 9)
    for ext, binary in (("pgm" if kind.startswith("gray") else "ppm", 1), ("pnm", 0), ("pam", 1)):
        path = str(tmp_path / f"{kind}.{ext}")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PXM_BINARY, binary])
        with open(path, "rb") as f:
            assert_equals_cv2(tmp_path, f.read(), f"{kind}_{binary}.{ext}")


def pnm_refusals() -> dict:
    head = b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n"
    return {
        "pam_rgba.pam": (head % (4, 255, b"RGB_ALPHA") + bytes(8), "TUPLTYPE RGB_ALPHA"),
        "pam_gray_alpha.pam": (head % (2, 255, b"GRAYSCALE_ALPHA") + bytes(4), "TUPLTYPE GRAYSCALE_ALPHA"),
        "pam_bw.pam": (head % (1, 1, b"BLACKANDWHITE") + bytes(2), "TUPLTYPE BLACKANDWHITE"),
        "pam_maxval1.pam": (head % (1, 1, b"GRAYSCALE") + bytes(2), "MAXVAL 1"),
        "pgm_short.pgm": (b"P5\n4 4\n255\n" + bytes(10), "premature end"),
        "ppm_ascii_short.ppm": (b"P3\n2 2\n255\n1 2 3\n", "premature end"),
    }


@pytest.mark.parametrize("name", sorted(pnm_refusals()))
def test_pnm_refused(tmp_path, name):
    from linemod_tpu_torch.pipeline.sensors import read_image

    blob, words = pnm_refusals()[name]
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    for mode, _ in MODES:
        with pytest.raises(ValueError, match=re.escape(path) + ".*" + words):
            read_image(path, mode)


# -- BMP -------------------------------------------------------------------------------


def bmp_cases() -> dict:
    """{name: file bytes} across the headers, bit depths, compressions and
    row orders the reader takes."""
    rng = np.random.default_rng(10)
    h, w = 9, 13
    x = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    v16 = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    palette = [tuple(int(c) for c in rng.integers(0, 256, 3)) for _ in range(256)]
    i8, i4, i1 = rng.integers(0, 256, (h, w)), rng.integers(0, 16, (h, w)), rng.integers(0, 2, (h, w))

    def rows(a):
        return [a[y].tobytes() for y in range(h - 1, -1, -1)]

    def nibbles(a):
        a = np.pad(a, ((0, 0), (0, a.shape[1] % 2)))
        return ((a[:, 0::2] << 4) | a[:, 1::2]).astype(np.uint8)

    out = {
        "bgr24.bmp": write_bmp(w, h, 24, rows=rows(x[:, :, :3])),
        "bgr24_topdown.bmp": write_bmp(w, h, 24, rows=[x[y, :, :3].tobytes() for y in range(h)], top_down=True),
        "bgr24_v4.bmp": write_bmp(w, h, 24, rows=rows(x[:, :, :3]), header=108),
        "bgrx32.bmp": write_bmp(w, h, 32, rows=rows(x)),
        "bgrx32_bitfields_ignored.bmp": write_bmp(w, h, 32, rows=rows(x), compression=3, masks=(0xFF, 0xFF00, 0xFF0000)),
        "bgra32_v5.bmp": write_bmp(w, h, 32, rows=rows(x), compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                   header=124),
        "rgba32_v4_masks.bmp": write_bmp(w, h, 32, rows=rows(x), compression=3,
                                         masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=108),
        "xbgr32_v5_masks.bmp": write_bmp(w, h, 32, rows=rows(x), compression=3,
                                         masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF), header=124, top_down=True),
        "rgb555.bmp": write_bmp(w, h, 16, rows=rows(v16)),
        "rgb555_v5.bmp": write_bmp(w, h, 16, rows=rows(v16), header=124),
        "rgb555_bitfields.bmp": write_bmp(w, h, 16, rows=rows(v16), compression=3, masks=(0x7C00, 0x3E0, 0x1F)),
        "rgb565.bmp": write_bmp(w, h, 16, rows=rows(v16), compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "pal8.bmp": write_bmp(w, h, 8, rows=rows(i8.astype(np.uint8)), palette=palette),
        "pal8_short_palette.bmp": write_bmp(w, h, 8, rows=rows(i8.astype(np.uint8)), palette=palette[:100]),
        "pal8_gray_topdown.bmp": write_bmp(w, h, 8, rows=[i8[y].astype(np.uint8).tobytes() for y in range(h)],
                                           palette=[(i, i, i) for i in range(256)], top_down=True),
        "pal4.bmp": write_bmp(w, h, 4, rows=rows(nibbles(i4)), palette=palette[:16]),
        "pal4_v5.bmp": write_bmp(w, h, 4, rows=rows(nibbles(i4)), palette=palette[:16], header=124),
        "pal1.bmp": write_bmp(w, h, 1, rows=rows(np.packbits(i1, axis=1)), palette=palette[:2]),
    }
    for k in range(4):
        for bits in (8, 4):
            out[f"rle{bits}_{k}.bmp"] = bmp_rle_file(rng, int(rng.integers(5, 40)), int(rng.integers(2, 12)), bits)
    return out


@pytest.mark.parametrize("name", sorted(bmp_cases()))
def test_bmp_equals_cv2(tmp_path, name):
    assert_equals_cv2(tmp_path, bmp_cases()[name], name)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil_and_cv2(tmp_path, mode):
    import cv2
    from PIL import Image

    img = seeded("c8", 12)
    path = str(tmp_path / "pil.bmp")
    Image.fromarray(img[:, :, ::-1]).convert(mode).save(path)
    with open(path, "rb") as f:
        assert_equals_cv2(tmp_path, f.read(), f"pil_{mode}.bmp")
    if mode in ("L", "RGB"):
        assert cv2.imwrite(path, img if mode == "RGB" else img[:, :, 0])
        with open(path, "rb") as f:
            assert_equals_cv2(tmp_path, f.read(), f"cv2_{mode}.bmp")


@pytest.mark.parametrize("bits", [8, 4])
def test_bmp_rle_streams_equal_cv2(tmp_path, bits):
    """400 seeded run-length streams (runs, absolute blocks, end-of-lines,
    deltas, with and without the end-of-bitmap, some cut short): where cv2
    decodes one the reader gives its image, where cv2 gives nothing the
    reader raises. OpenCV's RLE4 ends only the row at an end-of-bitmap
    and ignores a delta's rows; its RLE8 follows the format."""
    import cv2

    from linemod_tpu_torch.utils.bmp import decode_bmp

    rng = np.random.default_rng(bits)
    decoded = refused = 0
    for _ in range(400):
        blob = bmp_rle_file(rng, int(rng.integers(1, 20)), int(rng.integers(1, 8)), bits, end=rng.random() < 0.8)
        if rng.random() < 0.1:  # cut inside the run-length data
            offset = struct.unpack_from("<I", blob, 10)[0]
            blob = blob[: int(rng.integers(offset, len(blob) + 1))]
        for mode, flag in MODES:
            want = cv2_decode(blob, flag)
            if want is None:
                with pytest.raises(ValueError, match="BI_RLE|premature"):
                    decode_bmp(blob, mode)
                refused += 1
            else:
                assert np.array_equal(decode_bmp(blob, mode), want)
                decoded += 1
    assert decoded > 200 and refused > 50, (decoded, refused)


def bmp_refusals() -> dict:
    rng = np.random.default_rng(11)
    v16 = rng.integers(0, 1 << 16, (4, 6)).astype("<u2")
    os2 = b"BM" + struct.pack("<IHHI", 26 + 72, 0, 0, 26) + struct.pack("<IHHHH", 12, 6, 4, 1, 24) + bytes(72)
    return {
        "bmp_os2.bmp": (os2, "header of 12 bytes"),
        "bmp_v5_bitfields16.bmp": (write_bmp(6, 4, 16, rows=[r.tobytes() for r in v16], compression=3,
                                             masks=(0xF800, 0x7E0, 0x1F), header=124), "16-bit BMP masks"),
        "bmp_bitfields444.bmp": (write_bmp(6, 4, 16, rows=[r.tobytes() for r in v16], compression=3,
                                           masks=(0xF00, 0xF0, 0xF)), "16-bit BMP masks"),
        "bmp_mask10.bmp": (write_bmp(6, 4, 32, rows=[bytes(24)] * 4, compression=3,
                                     masks=(0x3FF00000, 0xFFC00, 0x3FF, 0), header=124), "32-bit BMP mask"),
        "bmp_jpeg.bmp": (write_bmp(6, 4, 24, rows=[bytes(18)] * 4, compression=4), "compression 4"),
        "bmp_rle_topdown.bmp": (write_bmp(6, 4, 8, data=b"\x06\x01\x00\x01", palette=[(0, 0, 0)] * 256,
                                          compression=1, top_down=True), "top-down run-length"),
        "bmp_rle_past_row.bmp": (write_bmp(6, 4, 8, data=b"\x08\x01\x00\x01", palette=[(0, 0, 0)] * 256,
                                           compression=1), "passes its row"),
        "bmp_short.bmp": (write_bmp(6, 4, 24, rows=[bytes(18)] * 4)[:80], "premature end"),
        "bmp_short_palette.bmp": (write_bmp(6, 4, 8, rows=[bytes(6)] * 4, palette=[(1, 2, 3)] * 256)[:300],
                                  "premature end of the BMP palette"),
    }


@pytest.mark.parametrize("name", sorted(bmp_refusals()))
def test_bmp_refused(tmp_path, name):
    from linemod_tpu_torch.pipeline.sensors import read_image

    blob, words = bmp_refusals()[name]
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    for mode, _ in MODES:
        with pytest.raises(ValueError, match=re.escape(path) + ".*" + words):
            read_image(path, mode)


# -- dispatch and the formats the port refuses ------------------------------------------


def format_refusals() -> dict:
    """{file name: (bytes, format name)}: a file of each format cv2.imread
    reads and the port refuses; cv2 writes the ones it can."""
    import cv2
    from PIL import Image

    img = seeded("c8", 13, 12, 16)
    out = {}
    for ext, name, data in (("webp", "WebP", img), ("avif", "AVIF", img), ("hdr", "Radiance HDR", img / 255.0),
                            ("ras", "Sun raster", img), ("pfm", "PFM", img / 255.0)):
        ok, buf = cv2.imencode("." + ext, data.astype(np.float32) if ext in ("hdr", "pfm") else data)
        assert ok, ext
        out[f"refused.{ext}"] = (buf.tobytes(), name)
    gif = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"refused-{os.getpid()}.gif")
    Image.fromarray(img).save(gif)
    with open(gif, "rb") as f:
        out["refused.gif"] = (f.read(), "GIF")
    os.remove(gif)
    out["refused.jp2"] = (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(32), "JPEG 2000")
    out["refused.j2k"] = (b"\xff\x4f\xff\x51" + bytes(32), "JPEG 2000")
    out["refused.exr"] = (b"\x76\x2f\x31\x01" + bytes(32), "OpenEXR")
    return out


@pytest.mark.parametrize("name", ["refused.webp", "refused.avif", "refused.hdr", "refused.ras", "refused.pfm",
                                  "refused.gif", "refused.jp2", "refused.j2k", "refused.exr"])
def test_formats_the_port_refuses(tmp_path, name):
    """Each raises naming the file and its format; cv2 reads the ones it
    could write here."""
    from linemod_tpu_torch.pipeline.sensors import read_image

    blob, fmt = format_refusals()[name]
    if name.split(".")[1] not in ("jp2", "j2k", "exr"):
        assert cv2_decode(blob, 1) is not None
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError, match=re.escape(path) + f": a {fmt} file"):
        read_image(path, "color")


def test_dispatch_by_leading_bytes_not_names(tmp_path):
    """Each reader is picked by the file's leading bytes: a TIFF named
    .png, a BMP named .jpg and a PGM named .tif read as cv2 reads them."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import load_frame

    depth = seeded("g16", 14, 30, 40)
    color = seeded("c8", 14, 30, 40)
    for color_ext, depth_ext, color_name, depth_name in ((".tiff", ".pgm", "c.png", "d.tif"),
                                                        (".bmp", ".tiff", "c.jpg", "d.png"),
                                                        (".ppm", ".png", "c.bmp", "d.pgm")):
        for img, ext, name in ((color, color_ext, color_name), (depth, depth_ext, depth_name)):
            ok, buf = cv2.imencode(ext, img)
            assert ok
            with open(str(tmp_path / name), "wb") as f:
                f.write(buf.tobytes())
        got_color, got_depth = load_frame(str(tmp_path / color_name), str(tmp_path / depth_name))
        assert np.array_equal(got_color, cv2.imread(str(tmp_path / color_name)))
        assert got_depth.dtype == np.uint16 and np.array_equal(got_depth, depth)


def test_imconvert_rules():
    """The shared conversions on hand-picked samples: the high byte, gray
    replicated, imread's gray at 8 and 16 bits in both channel orders."""
    from linemod_tpu_torch.utils import imconvert

    px16 = np.array([[[0x1280], [0x12FF], [0xFFFF]]], np.uint16)
    assert imconvert.convert(px16, "color").tolist() == [[[18] * 3, [18] * 3, [255] * 3]]
    assert imconvert.convert(px16, "anydepth").dtype == np.uint16
    bgr = np.array([[[10, 200, 30]]], np.uint8)
    assert imconvert.convert(bgr, "anydepth").tolist() == [[128]]
    assert imconvert.convert(bgr[:, :, ::-1], "anydepth", "rgb").tolist() == [[128]]
    assert imconvert.convert(bgr[:, :, ::-1], "color", "rgb").tolist() == bgr.tolist()
    with pytest.raises(ValueError, match="unknown read mode"):
        imconvert.convert(bgr, "gray")


# -- the goldens -----------------------------------------------------------------------


def test_goldens_equal_cv2():
    """Every committed golden decodes to cv2's digest in both modes (an
    empty digest: cv2 gives nothing and the reader raises), and each
    refused golden raises naming the file and its kind."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import read_image

    ref = np.load(IMREAD_REF)
    names = [str(n) for n in ref["names"]]
    refused = [str(n) for n in ref["refused_names"]]
    assert sorted(names + [os.path.join("refused", n) for n in refused]) == sorted(
        [n for n in os.listdir(IMREAD_DIR) if n != "refused"] + [os.path.join("refused", n) for n in
                                                                  os.listdir(os.path.join(IMREAD_DIR, "refused"))])
    total = sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(IMREAD_DIR) for f in files)
    assert total < 600_000, total
    for name, color_sha, gray_sha in zip(names, ref["color_sha256"], ref["gray_sha256"]):
        path = os.path.join(IMREAD_DIR, name)
        for mode, flag, sha in (("color", 1, color_sha), ("anydepth", 2, gray_sha)):
            want = cv2.imread(path, flag)
            assert (hashlib.sha256(want.tobytes()).hexdigest() if want is not None else "") == sha, (name, mode)
            if sha:
                assert hashlib.sha256(read_image(path, mode).tobytes()).hexdigest() == sha, (name, mode)
            else:
                with pytest.raises(ValueError, match=re.escape(path)):
                    read_image(path, mode)
    for name, words in zip(refused, ref["refused_words"]):
        path = os.path.join(IMREAD_DIR, "refused", name)
        with pytest.raises(ValueError, match=re.escape(path) + ".*(" + str(words) + ")"):
            read_image(path, "color")


def golden_files() -> dict:
    """{name: bytes} of tests/goldens/imread/ (cut from the fixture frame
    and depth, 160x120 at most) and {name: (bytes, words)} of its refused/
    files."""
    import cv2
    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_jpeg import encode, refused_jpegs, with_dqt_between_scans

    color = cv2.imread(os.path.join(EXAMPLE, "benchmark", "img0.png"))
    depth = cv2.imread(os.path.join(EXAMPLE, "benchmark", "depth0.png"), cv2.IMREAD_ANYDEPTH)
    crop = (slice(200, 320), slice(260, 420))
    c, d = color[crop], depth[crop]
    q = c[30:90, 40:120]  # 80 x 60 for the larger formats
    files = {}

    def cv2_bytes(ext, img, params=()):
        ok, buf = cv2.imencode(ext, img, list(params))
        assert ok
        return buf.tobytes()

    files["prog_420_rst.jpg"] = encode(c, sampling="420", quality=90, progressive=True, restart=4)
    files["prog_444_opt.jpg"] = encode(c, sampling="444", quality=60, progressive=True, optimize=True)
    files["prog_gray.jpg"] = encode(cv2.cvtColor(c, cv2.COLOR_BGR2GRAY), quality=85, progressive=True)
    files["prog_dqt_between_scans.jpg"] = with_dqt_between_scans(encode(c, quality=75, progressive=True))
    lzw = [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW, cv2.IMWRITE_TIFF_PREDICTOR,
           cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]
    deflate = [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE]
    files["fixture_depth_lzw.tif"] = cv2_bytes(".tif", depth, lzw)
    files["fixture_depth_deflate.tif"] = cv2_bytes(".tif", depth, deflate)
    files["depth_mm_deflate_pred.tif"] = write_tiff(d, ">", 32946, 2, rows_per_strip=16)
    files["color_packbits.tif"] = cv2_bytes(".tif", q, [cv2.IMWRITE_TIFF_COMPRESSION,
                                                        cv2.IMWRITE_TIFF_COMPRESSION_PACKBITS])
    files["color_mm_lzw.tif"] = write_tiff(q[:, :, ::-1], ">", 5, 1, rows_per_strip=13)
    files["color16_lzw_pred.tif"] = write_tiff((c.astype(np.uint16) * 257 + 3)[:60, :80, ::-1], "<", 5, 2,
                                               rows_per_strip=8)
    rgba = np.dstack([c[:60, :80, ::-1], (d[:60, :80] >> 4).astype(np.uint8)])
    with_alpha = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"golden-{os.getpid()}.tif")
    Image.fromarray(rgba, "RGBA").save(with_alpha, compression="tiff_adobe_deflate")
    with open(with_alpha, "rb") as f:
        files["rgba_unassociated.tif"] = f.read()
    os.remove(with_alpha)
    files["depth_float.tif"] = cv2_bytes(".tif", d.astype(np.float32) / 1000.0, deflate)
    files["depth16.pgm"] = cv2_bytes(".pgm", d[30:90, 40:120])
    files["color.ppm"] = cv2_bytes(".ppm", q)
    files["gray_ascii_maxval100.pgm"] = pnm_cases()["p2_maxval100.pgm"]
    files["color_ascii.ppm"] = cv2_bytes(".ppm", c[:30, :40], [cv2.IMWRITE_PXM_BINARY, 0])
    files["bitmap.pbm"] = b"P4\n160 120\n" + np.packbits(c[:, :, 1] > 100, axis=1).tobytes()
    files["gray.pam"] = cv2_bytes(".pam", cv2.cvtColor(q, cv2.COLOR_BGR2GRAY))
    files["rgb.pam"] = b"P7\nWIDTH 80\nHEIGHT 60\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n" + c[:60, :80].tobytes()
    files["bgr24.bmp"] = cv2_bytes(".bmp", q)
    files["bgra32_v5.bmp"] = write_bmp(80, 60, 32, rows=[np.concatenate([c[y, :80], c[y, :80, :1]], axis=1).tobytes()
                                                          for y in range(59, -1, -1)], compression=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124)
    v565 = ((c[:60, :80, 2].astype(np.uint16) >> 3) << 11) | ((c[:60, :80, 1].astype(np.uint16) >> 2) << 5) \
        | (c[:60, :80, 0] >> 3)
    files["rgb565.bmp"] = write_bmp(80, 60, 16, rows=[v565[y].astype("<u2").tobytes() for y in range(59, -1, -1)],
                                    compression=3, masks=(0xF800, 0x7E0, 0x1F))
    pal = Image.fromarray(q[:, :, ::-1]).quantize(colors=200)
    pal_path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"golden-{os.getpid()}.bmp")
    pal.save(pal_path)
    with open(pal_path, "rb") as f:
        files["pal8.bmp"] = f.read()
    pal.convert("1").save(pal_path)
    with open(pal_path, "rb") as f:
        files["mono1.bmp"] = f.read()
    os.remove(pal_path)
    rng = np.random.default_rng(20)
    for bits in (8, 4):  # the first seeded stream cv2 decodes
        while cv2_decode(files.setdefault(f"rle{bits}.bmp", bmp_rle_file(rng, 120, 40, bits)), 1) is None:
            files[f"rle{bits}.bmp"] = bmp_rle_file(rng, 120, 40, bits)
    from linemod_tpu_torch.utils.png import encode_png

    files["color_as_depth.png"] = encode_png(q[:, :, ::-1].reshape(60, -1), 80, 2, 8)
    files["color16_as_depth.png"] = encode_png((c[:60, :80, ::-1].astype(np.uint16) * 257 + 5).astype(">u2")
                                               .view(np.uint8).reshape(60, -1), 80, 2, 16)
    refused = dict(refused_jpegs(c[:24, :32]))
    refused.update({k: v for k, v in tiff_refusals().items() if k != "tiff_short_strip.tif"})
    refused.update(pnm_refusals())
    refused.update(bmp_refusals())
    refused.update({k: (b, f"a {fmt} file") for k, (b, fmt) in format_refusals().items()})
    return files, refused


def make_imread_goldens(tmp_dir: str) -> dict:
    """Write tests/goldens/imread/ and tests/goldens/imread_ref.npz: cv2's
    digests of each golden in both modes, the refused files with their
    words, and JAX's CLI lines over the progressive-JPEG + TIFF sequence and
    the PPM / BMP + PGM sequence (which must be the PNG fixture's)."""
    import contextlib
    import io
    import shutil

    import cv2

    from linemod_tpu.cli import main as jax_main

    files, refused = golden_files()
    shutil.rmtree(IMREAD_DIR, ignore_errors=True)
    os.makedirs(os.path.join(IMREAD_DIR, "refused"))
    names, color_sha, gray_sha = [], [], []
    for name, blob in files.items():
        with open(os.path.join(IMREAD_DIR, name), "wb") as f:
            f.write(blob)
        names.append(name)
        digests = []
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH):
            img = cv2.imread(os.path.join(IMREAD_DIR, name), flag)
            digests.append("" if img is None else hashlib.sha256(img.tobytes()).hexdigest())
        color_sha.append(digests[0])
        gray_sha.append(digests[1])
    for name, (blob, _) in refused.items():
        with open(os.path.join(IMREAD_DIR, "refused", name), "wb") as f:
            f.write(blob)
    lines = {}
    for seq_name, frames in sequences(tmp_dir).items():
        for command in ("detect", "evaluate"):
            out = io.StringIO()
            here = os.getcwd()
            os.chdir(EXAMPLE)
            try:
                with contextlib.redirect_stdout(out):
                    assert jax_main(cli_argv(command, frames)) == 0
            finally:
                os.chdir(here)
            lines[f"{seq_name}_{command}_lines"] = np.array(masked(out.getvalue()))
    for command in ("detect", "evaluate"):
        out = io.StringIO()
        here = os.getcwd()
        os.chdir(EXAMPLE)
        try:
            with contextlib.redirect_stdout(out):
                png = sequences(tmp_dir, png=True)["lossless"]
                assert jax_main(cli_argv(command, png)) == 0
        finally:
            os.chdir(here)
        assert np.array_equal(lines[f"lossless_{command}_lines"], np.array(masked(out.getvalue()))), command
    arrays = {"names": np.array(names), "color_sha256": np.array(color_sha), "gray_sha256": np.array(gray_sha),
              "refused_names": np.array(list(refused)), "refused_words": np.array([w for _, w in refused.values()]),
              **lines}
    np.savez_compressed(IMREAD_REF, **arrays)
    return arrays


def masked(text: str) -> list:
    """The printed lines with the wall-clock numbers masked."""
    text = re.sub(r"in \d+\.\d ms", "in <t> ms", text)
    return re.sub(r"mean \d+\.\d ms \(\d+\.\d+ fps\)", "mean <t> ms (<f> fps)", text).splitlines()


def sequences(tmp_dir: str, png: bool = False) -> dict:
    """The two CLI sequences, written into tmp_dir from the goldens:
    "progressive" (the fixture frame as tests/goldens/jpeg/
    fixture_progressive.jpg, its depth as the LZW + predictor TIFF, then
    as the Deflate TIFF) and "lossless" (the fixture frame as a PPM, then a
    24-bit BMP, its depth as a 16-bit PGM; with png=True the same frames
    as PNGs). Each frame has pose<i>.yml beside it. Returns {name: folder
    with its (color, depth) extensions}."""
    import cv2

    from linemod_tpu_torch.utils.png import write_png

    color = cv2.imread(os.path.join(EXAMPLE, "benchmark", "img0.png"))
    depth = cv2.imread(os.path.join(EXAMPLE, "benchmark", "depth0.png"), cv2.IMREAD_ANYDEPTH)
    with open(os.path.join(EXAMPLE, "benchmark", "pose0.yml"), "rb") as f:
        pose = f.read()
    out = {}
    prog = os.path.join(tmp_dir, "progressive")
    os.makedirs(prog, exist_ok=True)
    for i, depth_name in enumerate(("fixture_depth_lzw.tif", "fixture_depth_deflate.tif")):
        with open(os.path.join(JPEG_DIR, "fixture_progressive.jpg"), "rb") as f:
            blob = f.read()
        with open(os.path.join(prog, f"color{i}.jpg"), "wb") as f:
            f.write(blob)
        with open(os.path.join(IMREAD_DIR, depth_name), "rb") as src, open(os.path.join(prog, f"depth{i}.tif"),
                                                                             "wb") as dst:
            dst.write(src.read())
        with open(os.path.join(prog, f"pose{i}.yml"), "wb") as f:
            f.write(pose)
    out["progressive"] = (prog, ".jpg", ".tif")
    lossless = os.path.join(tmp_dir, "lossless_png" if png else "lossless")
    os.makedirs(lossless, exist_ok=True)
    for i, ext in enumerate((".ppm", ".bmp")):
        if png:
            write_png(os.path.join(lossless, f"color{i}.img"), color)
            write_png(os.path.join(lossless, f"depth{i}.img"), depth)
        else:
            assert cv2.imwrite(os.path.join(lossless, f"color{i}{ext}"), color)
            os.replace(os.path.join(lossless, f"color{i}{ext}"), os.path.join(lossless, f"color{i}.img"))
            assert cv2.imwrite(os.path.join(lossless, f"depth{i}.pgm"), depth)
            os.replace(os.path.join(lossless, f"depth{i}.pgm"), os.path.join(lossless, f"depth{i}.img"))
        with open(os.path.join(lossless, f"pose{i}.yml"), "wb") as f:
            f.write(pose)
    out["lossless"] = (lossless, ".img", ".img")
    return out


def cli_argv(command: str, seq: tuple) -> list:
    folder, color_ext, depth_ext = seq
    return [command, "--model", "lagergehaeuse.ply", "--images", os.path.join(folder, f"color%d{color_ext}"),
            "--depths", os.path.join(folder, f"depth%d{depth_ext}")] + (["--gt", "yml"] if command == "evaluate" else [])


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as tmp:
        ref = make_imread_goldens(tmp)
    print(f"wrote {len(ref['names'])} goldens, {len(ref['refused_names'])} refused files and {IMREAD_REF}")
