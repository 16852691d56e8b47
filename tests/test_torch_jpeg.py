"""The port's JPEG reader (`linemod_tpu_torch/utils/jpeg.py`, host C++
`csrc/jpeg_decode.cpp`) against `cv2.imread` on the CPU, bit for bit.

Files are written by `cv2.imencode` from seeded frames and the fixture
frame: every sampling factor (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), quality
50 and 95, optimized Huffman tables, restart intervals, gray, odd sizes
(641x479, 17x9, 3x5, 3x33) and the eight EXIF orientations, baseline and
progressive (with a DQT redefined between scans, which libjpeg ignores for
components already scanned). Each must decode to exactly what
`cv2.imread` returns under `IMREAD_COLOR` and `IMREAD_ANYDEPTH`. A file
cut short, a file that is no JPEG and each refused kind (arithmetic-coded,
lossless, hierarchical, 12-bit, CMYK, Adobe transform 0, a progressive
file whose scans leave low AC coefficients unrefined, which libjpeg-turbo
smooths, and scans out of the JPEG rules) raise a ValueError that names
the file and the kind.

`tests/goldens/jpeg/*.jpg` and `tests/goldens/jpeg_ref.npz` (the sha256 of
cv2's decode of each, and JAX's `cli evaluate --gt linemod` and `detect`
lines over a JPEG LINEMOD-layout sequence) are what `chip_smoke.py` holds
the card to; `make_jpeg_goldens` writes them (run
`env JAX_PLATFORMS=cpu python tests/test_torch_aruco.py`).
"""

import hashlib
import os
import re
import struct

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
JPEG_DIR = os.path.join(REPO, "tests", "goldens", "jpeg")
JPEG_REF = os.path.join(REPO, "tests", "goldens", "jpeg_ref.npz")
SAMPLING = ("444", "422", "420", "440", "411")
# the LINEMOD-layout sequence chip_smoke.py builds from the golden files:
# colorN.jpg for N = 0, 1, 2, each with the fixture's depth and pose
SEQUENCE = ("fixture_420.jpg", "fixture_444_q75.jpg", "fixture_422_rst.jpg")


def _cv2_flags(sampling=None, quality=95, optimize=False, restart=0, progressive=False):
    import cv2

    flags = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if optimize:
        flags += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if restart:
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        flags += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    return flags


def encode(img, **kw) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img, _cv2_flags(**kw))
    assert ok
    return buf.tobytes()


def fixture_frame() -> np.ndarray:
    import cv2

    return cv2.imread(os.path.join(EXAMPLE, "benchmark", "img0.png"))


def seeded_frames() -> dict:
    """Frames of odd sizes: uniform noise (every coefficient busy), a smooth
    field (long zero runs), and tiny ones (one MCU, chroma two samples
    wide or less)."""
    import cv2

    rng = np.random.default_rng(11)

    def smooth(h, w):
        coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
        return cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)

    return {"noise_641x479": rng.integers(0, 256, (479, 641, 3), dtype=np.uint8),
            "smooth_641x479": smooth(479, 641), "smooth_17x9": smooth(9, 17),
            "noise_3x5": rng.integers(0, 256, (5, 3, 3), dtype=np.uint8), "smooth_3x33": smooth(33, 3)}


def assert_equals_cv2(blob: bytes):
    import cv2

    from linemod_tpu_torch.utils.jpeg import decode_jpeg

    buf = np.frombuffer(blob, np.uint8)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("anydepth", cv2.IMREAD_ANYDEPTH)):
        want = cv2.imdecode(buf, flag)
        got = decode_jpeg(blob, mode)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape, want.shape)
        assert np.array_equal(got, want), (mode, int((got != want).sum()))


@pytest.fixture(scope="module")
def frames():
    out = seeded_frames()
    out["fixture"] = fixture_frame()
    return out


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("source", ["fixture", "noise_641x479", "smooth_641x479", "smooth_17x9", "noise_3x5",
                                    "smooth_3x33"])
def test_sampling_quality_tables_restart(frames, source, sampling):
    """Quality 50 and 95, standard and optimized Huffman tables, with and
    without a restart interval of 3 MCUs."""
    for quality in (50, 95):
        for extra in ({}, {"optimize": True}, {"restart": 3}):
            assert_equals_cv2(encode(frames[source], sampling=sampling, quality=quality, **extra))


@pytest.mark.parametrize("source", ["fixture", "noise_641x479", "smooth_17x9"])
def test_gray_file(frames, source):
    import cv2

    gray = cv2.cvtColor(frames[source], cv2.COLOR_BGR2GRAY)
    for quality in (50, 90):
        assert_equals_cv2(encode(gray, quality=quality))
        assert_equals_cv2(encode(gray, quality=quality, restart=2, optimize=True))


def with_orientation(blob: bytes, orientation: int, order: str = "II") -> bytes:
    """The file with an EXIF APP1 segment (IFD0 holding one orientation tag)
    after its SOI marker."""
    end = "<" if order == "II" else ">"
    ifd = struct.pack(end + "H", 1) + struct.pack(end + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(end + "I", 0)
    tiff = order.encode() + struct.pack(end + "HI", 42, 8) + ifd
    body = b"Exif\0\0" + tiff
    return blob[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + blob[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(frames, orientation):
    """OpenCV's imread turns and flips the image as its EXIF orientation
    says, under IMREAD_COLOR and IMREAD_ANYDEPTH alike."""
    from linemod_tpu_torch.utils.jpeg import exif_orientation

    blob = with_orientation(encode(frames["smooth_17x9"], sampling="420"), orientation,
                            "MM" if orientation % 2 else "II")
    assert exif_orientation(blob) == orientation
    assert_equals_cv2(blob)


def test_golden_files_equal_cv2():
    """Every committed golden JPEG, the progressive one too, decodes to
    cv2's digest in both modes."""
    from linemod_tpu_torch.utils.jpeg import read_jpeg

    ref = np.load(JPEG_REF)
    names = list(ref["names"])
    assert sorted(names) == sorted(os.listdir(JPEG_DIR))
    assert sum(os.path.getsize(os.path.join(JPEG_DIR, n)) for n in names) < 1 << 20
    for name, color_sha, gray_sha in zip(names, ref["color_sha256"], ref["gray_sha256"]):
        path = os.path.join(JPEG_DIR, name)
        assert hashlib.sha256(read_jpeg(path, "color").tobytes()).hexdigest() == color_sha, name
        assert hashlib.sha256(read_jpeg(path, "anydepth").tobytes()).hexdigest() == gray_sha, name


def test_progressive_raises_naming_the_file(frames, tmp_path):
    """The fixture as a progressive file decodes to cv2's image; the same
    file with its frame marker patched to SOF9 (arithmetic-coded) raises
    naming the file and the frame type."""
    import cv2

    from linemod_tpu_torch.utils.jpeg import read_jpeg

    path = str(tmp_path / "prog.jpg")
    blob = encode(frames["fixture"], progressive=True)
    with open(path, "wb") as f:
        f.write(blob)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("anydepth", cv2.IMREAD_ANYDEPTH)):
        assert np.array_equal(read_jpeg(path, mode), cv2.imread(path, flag))
    path = str(tmp_path / "sof9.jpg")
    with open(path, "wb") as f:
        f.write(with_frame_marker(encode(frames["fixture"]), 0xC9))
    for mode in ("color", "anydepth"):
        with pytest.raises(ValueError, match=r"sof9\.jpg: arithmetic-coded sequential \(SOF9\) JPEG is not decoded"):
            read_jpeg(path, mode)


@pytest.mark.parametrize("cut", ["half", "no_eoi", "cut_data_with_eoi", "header_only"])
def test_truncated_raises_naming_the_file(frames, tmp_path, cut):
    """A file cut inside its scan or its headers, or missing its EOI marker,
    raises (cv2.imread returns a partly gray image for the first and
    nothing for the last)."""
    import cv2

    from linemod_tpu_torch.utils.jpeg import read_jpeg

    blob = encode(frames["fixture"], sampling="420")
    assert blob[-2:] == b"\xff\xd9"
    blob = {"half": blob[: len(blob) // 2], "no_eoi": blob[:-2],
            "cut_data_with_eoi": blob[: len(blob) * 3 // 4] + b"\xff\xd9", "header_only": blob[:300]}[cut]
    if cut == "no_eoi":
        assert cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR) is None
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError, match=r"cut\.jpg: premature end"):
        read_jpeg(path, "color")


def test_frame_dispatch_by_leading_bytes(frames, tmp_path):
    """load_frame decodes by content, not by name: a JPEG named .png and a
    PNG named .jpg read as cv2 reads them; anything else raises naming the
    file."""
    import cv2

    from linemod_tpu_torch.pipeline.sensors import load_frame
    from linemod_tpu_torch.utils.png import write_png

    jpeg = str(tmp_path / "color.png")
    with open(jpeg, "wb") as f:
        f.write(encode(frames["fixture"]))
    png = str(tmp_path / "color.jpg")
    write_png(png, frames["fixture"])
    depth = str(tmp_path / "depth.png")
    write_png(depth, np.full((480, 640), 600, np.uint16))
    for path in (jpeg, png):
        color, d = load_frame(path, depth)
        assert np.array_equal(color, cv2.imread(path)) and d.dtype == np.uint16
    bogus = str(tmp_path / "color.bmp")
    with open(bogus, "wb") as f:
        f.write(b"BM" + bytes(100))
    with pytest.raises(ValueError, match=r"color\.bmp: a BMP header of 0 bytes is not decoded"):
        load_frame(bogus, depth)
    with open(bogus, "wb") as f:
        f.write(b"XY" + bytes(100))
    with pytest.raises(ValueError, match=r"color\.bmp: not a PNG, JPEG, TIFF, BMP or PNM file"):
        load_frame(bogus, depth)


# -- progressive files and refused kinds ---------------------------------------------------


def segments(blob: bytes) -> list:
    """[(marker, the segment's bytes)] after SOI; a scan's bytes run to the
    marker that ends its entropy-coded data."""
    out, pos = [], 2
    while pos < len(blob):
        marker = blob[pos + 1]
        if marker == 0xD9:
            out.append((marker, blob[pos:pos + 2]))
            break
        end = pos + 2 + struct.unpack(">H", blob[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            while not (blob[end] == 0xFF and blob[end + 1] != 0 and not 0xD0 <= blob[end + 1] <= 0xD7):
                end += 1
        out.append((marker, blob[pos:end]))
        pos = end
    return out


def join(parts) -> bytes:
    return b"\xff\xd8" + b"".join(seg for _, seg in parts)


def with_frame_marker(blob: bytes, marker: int) -> bytes:
    """The file with its SOFn marker replaced by `marker`."""
    return join([(m, bytes((0xFF, marker)) + seg[2:] if 0xC0 <= m <= 0xC2 else seg) for m, seg in segments(blob)])


def with_dqt_between_scans(blob: bytes) -> bytes:
    """A progressive file with both quantization tables redefined (all 1s)
    before its second scan: libjpeg latches each component's table at its
    first scan, so the image is the original's."""
    parts = segments(blob)
    second = [i for i, (m, _) in enumerate(parts) if m == 0xDA][1]
    dqt = b"\xff\xdb" + struct.pack(">H", 2 + 2 * 65) + bytes([0]) + bytes([1] * 64) + bytes([1]) + bytes([1] * 64)
    return join(parts[:second] + [(0xDB, dqt)] + parts[second:])


def refused_jpegs(img: np.ndarray) -> dict:
    """{file name: (bytes, the words its error names)}: a file of each JPEG
    kind the reader refuses, made from cv2's files of `img` (BGR) by
    patching headers and scans; no writer here makes them whole."""
    base, prog = encode(img, sampling="420"), encode(img, progressive=True)
    parts = segments(base)
    sof = next(i for i, (m, _) in enumerate(parts) if m == 0xC0)
    twelve = parts[sof][1][:4] + bytes([12]) + parts[sof][1][5:]
    body = parts[sof][1][4:]
    cmyk = b"\xff\xc0" + struct.pack(">H", len(body) + 5) + body[:5] + bytes([4]) + body[6:] + bytes([4, 0x11, 0])
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    pparts = segments(prog)
    scans = [i for i, (m, _) in enumerate(pparts) if m == 0xDA]
    last = pparts[scans[-1]]
    bad = pparts[scans[1]][1]
    n_comp = bad[4]
    bad = bad[:5 + 2 * n_comp + 1] + bytes([64]) + bad[5 + 2 * n_comp + 2:]  # Se = 64
    return {
        "jpeg_sof9.jpg": (with_frame_marker(base, 0xC9), r"arithmetic-coded sequential \(SOF9\)"),
        "jpeg_sof10.jpg": (with_frame_marker(prog, 0xCA), r"arithmetic-coded progressive \(SOF10\)"),
        "jpeg_sof3.jpg": (with_frame_marker(base, 0xC3), r"lossless \(SOF3\)"),
        "jpeg_sof5.jpg": (with_frame_marker(base, 0xC5), r"differential sequential \(SOF5\)"),
        "jpeg_12bit.jpg": (join(parts[:sof] + [(0xC0, twelve)] + parts[sof + 1:]), "12-bit JPEG"),
        "jpeg_cmyk.jpg": (join(parts[:sof] + [(0xC0, cmyk)] + parts[sof + 1:]), "4-component JPEG"),
        "jpeg_adobe_rgb.jpg": (join([(0xEE, adobe)] + parts), r"Adobe transform 0"),
        "prog_incomplete.jpg": (join(pparts[:scans[-1]] + pparts[scans[-1] + 1:]), "block smoothing"),
        "prog_refined_twice.jpg": (join(pparts[:-1] + [last] + pparts[-1:]), "bogus progression"),
        "prog_band_past_63.jpg": (join(pparts[:scans[1]] + [(0xDA, bad)] + pparts[scans[1] + 1:]),
                                  "invalid progressive scan"),
    }


@pytest.mark.parametrize("sampling", SAMPLING + (None,))
@pytest.mark.parametrize("source", ["fixture", "noise_641x479", "smooth_641x479", "smooth_17x9", "noise_3x5",
                                    "smooth_3x33"])
def test_progressive_sampling_quality_tables_restart(frames, source, sampling):
    """Progressive files (libjpeg's default scan script: DC first and
    refine scans, spectral selection, successive approximation, end-of-band
    runs), quality 50 and 95, optimized tables, a restart interval of 3."""
    for quality in (50, 95):
        for extra in ({}, {"optimize": True}, {"restart": 3}):
            assert_equals_cv2(encode(frames[source], sampling=sampling, quality=quality, progressive=True, **extra))


@pytest.mark.parametrize("source", ["fixture", "noise_641x479", "smooth_17x9"])
def test_progressive_gray_file(frames, source):
    import cv2

    gray = cv2.cvtColor(frames[source], cv2.COLOR_BGR2GRAY)
    for quality in (50, 90):
        assert_equals_cv2(encode(gray, quality=quality, progressive=True))
        assert_equals_cv2(encode(gray, quality=quality, progressive=True, restart=2))


def test_progressive_dqt_between_scans(frames):
    """A DQT between scans changes no component already scanned: cv2's
    image is the original file's, and so is the reader's."""
    blob = encode(frames["smooth_641x479"], quality=75, progressive=True)
    patched = with_dqt_between_scans(blob)
    assert_equals_cv2(patched)
    assert np.array_equal(cv2_decode(patched), cv2_decode(blob))


def cv2_decode(blob: bytes):
    import cv2

    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("name", ["jpeg_sof9.jpg", "jpeg_sof10.jpg", "jpeg_sof3.jpg", "jpeg_sof5.jpg",
                                  "jpeg_12bit.jpg", "jpeg_cmyk.jpg", "jpeg_adobe_rgb.jpg", "prog_incomplete.jpg",
                                  "prog_refined_twice.jpg", "prog_band_past_63.jpg"])
def test_refused_kinds_raise_naming_the_file(frames, tmp_path, name):
    """Each refused kind raises naming the file and the kind. cv2 decodes
    the incomplete progressive file (smoothing its blocks) and the one
    refined twice (libjpeg only warns) and refuses the band past 63; the
    reader never returns another image."""
    from linemod_tpu_torch.utils.jpeg import read_jpeg

    blob, words = refused_jpegs(frames["smooth_641x479"][:120, :160])[name]
    if name.startswith("prog_"):
        assert (cv2_decode(blob) is None) == (name == "prog_band_past_63.jpg")
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    for mode in ("color", "anydepth"):
        with pytest.raises(ValueError, match=re.escape(path) + ": .*" + words):
            read_jpeg(path, mode)


# -- the goldens ---------------------------------------------------------------------


def golden_sources() -> dict:
    """{file name: (frame, encode kwargs)}: the fixture frame and two frames
    of JAX's synthetic protocol (shiny frame 0, clutter frame 1), across
    the subsamplings, with a restart-interval file and a progressive one."""
    from linemod_tpu.config import load_settings
    from linemod_tpu.models.template_bank import TemplateBank
    from linemod_tpu.pipeline.synth_eval import SyntheticEvalSet
    from linemod_tpu.utils.ply import load_ply

    cam, _ = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    gen = SyntheticEvalSet(load_ply(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")), bank, cam, seed=0)
    shiny = np.asarray(gen.make_frame(0, "shiny")[0], np.uint8)
    clutter = np.asarray(gen.make_frame(1, "clutter")[0], np.uint8)
    fixture = fixture_frame()
    return {
        "fixture_420.jpg": (fixture, {"sampling": "420", "quality": 95}),
        "fixture_444_q75.jpg": (fixture, {"sampling": "444", "quality": 75}),
        "fixture_422_rst.jpg": (fixture, {"sampling": "422", "quality": 90, "restart": 5}),
        "synth_shiny0_440.jpg": (shiny, {"sampling": "440", "quality": 90}),
        "synth_clutter1_411_opt.jpg": (clutter, {"sampling": "411", "quality": 85, "optimize": True}),
        "fixture_progressive.jpg": (fixture, {"quality": 80, "progressive": True}),
    }


def make_jpeg_goldens(tmp_dir: str) -> dict:
    """Write tests/goldens/jpeg/*.jpg and tests/goldens/jpeg_ref.npz (JAX's
    CLI run over the LINEMOD-layout sequence built in tmp_dir)."""
    import contextlib
    import io
    import re

    import cv2

    from linemod_tpu.cli import main as jax_main
    from linemod_tpu.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu.utils.io import save_depth_linemod_dataset

    os.makedirs(JPEG_DIR, exist_ok=True)
    names, color_sha, gray_sha = [], [], []
    for name, (frame, kw) in golden_sources().items():
        blob = encode(frame, **kw)
        with open(os.path.join(JPEG_DIR, name), "wb") as f:
            f.write(blob)
        buf = np.frombuffer(blob, np.uint8)
        names.append(name)
        color_sha.append(hashlib.sha256(cv2.imdecode(buf, cv2.IMREAD_COLOR).tobytes()).hexdigest())
        gray_sha.append(hashlib.sha256(cv2.imdecode(buf, cv2.IMREAD_ANYDEPTH).tobytes()).hexdigest())
    seq = os.path.join(tmp_dir, "benchmarkLINEMOD")
    os.makedirs(seq, exist_ok=True)
    depth = cv2.imread(os.path.join(EXAMPLE, "benchmark", "depth0.png"), cv2.IMREAD_ANYDEPTH)
    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    for i, name in enumerate(SEQUENCE):
        with open(os.path.join(JPEG_DIR, name), "rb") as src, open(os.path.join(seq, f"color{i}.jpg"), "wb") as dst:
            dst.write(src.read())
        save_depth_linemod_dataset(os.path.join(seq, f"depth{i}.dpt"), depth)
        write_linemod_pose(seq, i, gt)
    lines = {}
    here = os.getcwd()
    os.chdir(EXAMPLE)
    try:
        for command in ("evaluate", "detect"):
            argv = [command, "--model", "lagergehaeuse.ply", "--images", os.path.join(seq, "color%d.jpg"),
                    "--depths", os.path.join(seq, "depth%d.dpt")] + (["--gt", "linemod"] if command == "evaluate" else [])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert jax_main(argv) == 0
            text = re.sub(r"mean \d+\.\d ms \(\d+\.\d+ fps\)", "mean <t> ms (<f> fps)",
                          re.sub(r"in \d+\.\d ms", "in <t> ms", out.getvalue()))
            lines[command] = np.array(text.splitlines())
    finally:
        os.chdir(here)
    arrays = {"names": np.array(names), "color_sha256": np.array(color_sha), "gray_sha256": np.array(gray_sha),
              "sequence": np.array(SEQUENCE), "evaluate_lines": lines["evaluate"], "detect_lines": lines["detect"]}
    np.savez_compressed(JPEG_REF, **arrays)
    return arrays


def write_linemod_pose(seq: str, i: int, gt) -> None:
    """tra{i}.tra / rot{i}.rot of a pipeline-frame pose, in the dataset's cm
    and unfixed frame (as tests/test_cli.py writes them)."""
    from linemod_tpu_torch.utils.geometry import quat_to_mat, rotation_about_axis

    rot_raw = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0).T @ quat_to_mat(np.asarray(gt.quaternion))
    with open(os.path.join(seq, f"tra{i}.tra"), "w") as f:
        f.write("1 3\n" + " ".join(f"{v / 10.0:.6f}" for v in gt.translation) + "\n")
    with open(os.path.join(seq, f"rot{i}.rot"), "w") as f:
        f.write("3 3\n" + "\n".join(" ".join(f"{v:.8f}" for v in row) for row in rot_raw) + "\n")
