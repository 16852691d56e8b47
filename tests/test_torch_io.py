"""The port's file readers against the JAX package's: PNG decoding against
OpenCV (every format in both read modes, a color file read as depth as
libpng's gray), FileStorage YAML against the PyYAML-based reader, and the config
dataclasses and ground-truth pose built from them. All comparisons exact."""

import dataclasses
import os
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
YAML_FILES = [
    os.path.join(EXAMPLE, "linemod_settings.yml"),
    os.path.join(EXAMPLE, "models", "lagergehaeuse.yml"),
    os.path.join(EXAMPLE, "benchmark", "pose0.yml"),
]


def test_png_color_equals_cv2_imread():
    import cv2

    from linemod_tpu_torch.utils.png import read_png

    path = os.path.join(EXAMPLE, "benchmark", "img0.png")
    got = read_png(path, "color")
    assert got.dtype == np.uint8 and got.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, cv2.imread(path))  # BGR, as OpenCV


def test_png_depth_equals_cv2_imread_anydepth():
    import cv2

    from linemod_tpu_torch.utils.png import read_png

    path = os.path.join(EXAMPLE, "benchmark", "depth0.png")
    got = read_png(path, "anydepth")
    assert got.dtype == np.uint16 and got.shape == (480, 640)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_ANYDEPTH))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_scanline_filters(tmp_path, ftype):
    """Every PNG filter type decodes to the encoded pixels (the fixture
    frames use only Sub): 8-bit RGB comes back BGR, 16-bit gray as uint16."""
    import cv2

    from linemod_tpu_torch.utils.png import encode_png, read_png

    rng = np.random.default_rng(ftype)
    rgb = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    path = tmp_path / "rgb.png"
    path.write_bytes(encode_png(rgb, 13, 2, 8, ftype))
    np.testing.assert_array_equal(read_png(str(path), "color"), rgb[:, :, ::-1])
    np.testing.assert_array_equal(read_png(str(path), "color"), cv2.imread(str(path)))

    gray = rng.integers(0, 65536, (7, 11)).astype(np.uint16)
    path = tmp_path / "gray.png"
    path.write_bytes(encode_png(gray.astype(">u2").view(np.uint8), 11, 0, 16, ftype))
    np.testing.assert_array_equal(read_png(str(path), "anydepth"), gray)


def _pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row_bytes] PNG scanline bytes (big-endian
    16-bit samples; 1/2/4-bit samples packed most significant first)."""
    h, w = samples.shape[:2]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per_byte = 8 // depth
    padded = np.zeros((h, -(-w // per_byte) * per_byte), np.int64)
    padded[:, :w] = samples[:, :, 0]
    groups = padded.reshape(h, -1, per_byte) << np.arange(8 - depth, -1, -depth)
    return groups.sum(axis=2).astype(np.uint8)


# (name, color type, bit depth): every format cv2.imread reads on the CLI's path
PNG_FORMATS = [
    ("gray1", 0, 1), ("gray2", 0, 2), ("gray4", 0, 4), ("gray8", 0, 8), ("gray16", 0, 16),
    ("graya8", 4, 8), ("graya16", 4, 16), ("rgb8", 2, 8), ("rgb16", 2, 16), ("rgba8", 6, 8),
    ("rgba16", 6, 16), ("palette1", 3, 1), ("palette2", 3, 2), ("palette4", 3, 4), ("palette8", 3, 8),
]


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name, ctype, depth", PNG_FORMATS, ids=[f[0] for f in PNG_FORMATS])
def test_png_format_equals_cv2(tmp_path, name, ctype, depth, ftype):
    """Each format under each filter type: read as a color frame equal to
    cv2.imread, as a depth frame equal to cv2.imread with IMREAD_ANYDEPTH
    (a color or palette file as libpng's gray); palettes carry a tRNS chunk, which both ignore; the
    C++ unfilter equals the plain one on the scanlines."""
    import cv2

    from linemod_tpu_torch.utils.png import _unfilter, encode_png, read_png, unfilter

    rng = np.random.default_rng(100 * ctype + depth + ftype)
    h, w = 9, 13
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (h, w, channels))
    chunks = []
    if ctype == 3:
        n_colors = min(1 << depth, 200)
        samples = rng.integers(0, n_colors, (h, w, 1))
        chunks = [(b"PLTE", rng.integers(0, 256, (n_colors, 3)).astype(np.uint8).tobytes()),
                  (b"tRNS", rng.integers(0, 256, n_colors).astype(np.uint8).tobytes())]
    rows = _pack_samples(samples, depth)
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(encode_png(rows, w, ctype, depth, ftype, chunks))
    want = cv2.imread(path)
    got = read_png(path, "color")
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    got = read_png(path, "anydepth")
    assert got.dtype == want.dtype and got.shape == want.shape == (h, w)
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        blob = f.read()
    raw = zlib.decompress(blob[blob.index(b"IDAT") + 4 : blob.rindex(b"IEND") - 8])
    bpp = max(1, channels * depth // 8)
    np.testing.assert_array_equal(unfilter(raw, h, rows.shape[1], bpp), _unfilter(raw, h, rows.shape[1], bpp))
    np.testing.assert_array_equal(unfilter(raw, h, rows.shape[1], bpp), rows)


CV2_WRITTEN = {
    "gray8": (np.uint8, (), []), "gray16": (np.uint16, (), []), "bgr8": (np.uint8, (3,), []),
    "bgr16": (np.uint16, (3,), []), "bgra8": (np.uint8, (4,), []), "bgra16": (np.uint16, (4,), []),
    "bilevel": (np.uint8, (), ["IMWRITE_PNG_BILEVEL", 1]),
}


@pytest.mark.parametrize("name", sorted(CV2_WRITTEN))
def test_png_written_by_cv2_equals_cv2(tmp_path, name):
    """PNGs as cv2.imwrite writes them (its own filter choice) read back as
    cv2.imread reads them, in both modes."""
    import cv2

    from linemod_tpu_torch.utils.png import read_png

    dtype, extra, params = CV2_WRITTEN[name]
    rng = np.random.default_rng(len(name))
    img = rng.integers(0, np.iinfo(dtype).max + 1, (31, 45) + extra).astype(dtype)
    if name == "bilevel":
        img = (img > 127).astype(np.uint8) * 255
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, img, [getattr(cv2, params[0]), params[1]] if params else [])
    np.testing.assert_array_equal(read_png(path, "color"), cv2.imread(path))
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    got = read_png(path, "anydepth")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


GAMMA_CHUNKS = {
    "gAMA_045455": ([(b"gAMA", (45455).to_bytes(4, "big"))], True),
    "sRGB": ([(b"sRGB", b"\0")], True),
    "iCCP": ([(b"iCCP", b"profile\0\0" + zlib.compress(bytes(64)))], True),
    "gAMA_1": ([(b"gAMA", (100000).to_bytes(4, "big"))], False),
    "gAMA_0_96": ([(b"gAMA", (96000).to_bytes(4, "big"))], False),
    "cHRM": ([(b"cHRM", bytes(32))], False),
}


@pytest.mark.parametrize("name", sorted(GAMMA_CHUNKS))
def test_png_color_as_depth_with_gamma_chunks(tmp_path, name):
    """A color PNG read as depth: libpng gamma-corrects its gray when the
    file's gamma is significant (gAMA away from 1.0, sRGB), so that file
    raises (iCCP too, which may carry one); a gamma within 0.05 of 1.0 and a
    cHRM chunk leave libpng's plain gray, equal to cv2's. Read as color
    every file equals cv2.imread."""
    import cv2

    from linemod_tpu_torch.utils.png import encode_png, libpng_gray, read_png

    chunks, refused = GAMMA_CHUNKS[name]
    rgb = np.random.default_rng(3).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(encode_png(rgb.reshape(9, -1), 13, 2, 8, 0, chunks))
    np.testing.assert_array_equal(read_png(path, "color"), cv2.imread(path))
    if refused:
        if name != "iCCP":  # cv2's gray is gamma-corrected here
            assert not np.array_equal(cv2.imread(path, cv2.IMREAD_ANYDEPTH), libpng_gray(rgb))
        with pytest.raises(ValueError, match=f"{name}\\.png: a color PNG with an? {name[:4]} chunk read as depth"):
            read_png(path, "anydepth")
    else:
        np.testing.assert_array_equal(read_png(path, "anydepth"), cv2.imread(path, cv2.IMREAD_ANYDEPTH))


def test_png_interlaced_raises(tmp_path):
    from linemod_tpu_torch.utils.png import encode_png, read_png

    path = tmp_path / "interlaced.png"
    path.write_bytes(encode_png(np.zeros((4, 6, 3), np.uint8), 6, 2, 8, 0, interlace=1))
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        read_png(str(path), "color")


def test_png_bad_filter_raises():
    from linemod_tpu_torch.utils.png import _unfilter, unfilter

    raw = bytes([0, 1, 2, 3, 7, 4, 5, 6])  # row 1 has filter type 7
    for fn in (unfilter, _unfilter):
        with pytest.raises(ValueError, match="filter type 7 in row 1"):
            fn(raw, 2, 3, 3)


def test_png_paeth_frame_decodes_fast(tmp_path):
    """A 640x480 color frame with the Paeth filter on every row decodes
    equal to cv2.imread in well under 50 ms (best of 5)."""
    import time

    import cv2

    from linemod_tpu_torch.utils.png import encode_png, read_png

    rgb = np.random.default_rng(7).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    path = str(tmp_path / "paeth.png")
    with open(path, "wb") as f:
        f.write(encode_png(rgb, 640, 2, 8, 4))
    np.testing.assert_array_equal(read_png(path, "color"), cv2.imread(path))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        read_png(path, "color")
        times.append(time.perf_counter() - t0)
    assert min(times) < 0.05, times


@pytest.mark.parametrize("path", YAML_FILES, ids=os.path.basename)
def test_cvyaml_equals_yamlcv(path):
    from linemod_tpu.utils.yamlcv import read_yamlcv as jax_read
    from linemod_tpu_torch.utils.yamlcv import read_yamlcv

    got = read_yamlcv(path)
    want = jax_read(path)
    assert got.keys() == want.keys()
    for key in want:
        assert type(got[key]) is type(want[key]), key
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_config_equals_jax_config():
    from linemod_tpu import config as jax_config
    from linemod_tpu_torch import config

    settings = os.path.join(EXAMPLE, "linemod_settings.yml")
    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    for got, want in zip(config.load_settings(settings), jax_config.load_settings(settings)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = config.load_model_properties(model)
    want = jax_config.load_model_properties(model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # a model without a sidecar gets the defaults
    missing = os.path.join(EXAMPLE, "models", "no_such_model.ply")
    assert config.load_model_properties(missing) == config.ModelProperties()


def test_ground_truth_pose_equals_jax():
    from linemod_tpu.pipeline.benchmark import read_ground_truth_pose as jax_read
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose

    path = os.path.join(EXAMPLE, "benchmark", "pose0.yml")
    got, want = read_ground_truth_pose(path), jax_read(path)
    np.testing.assert_array_equal(got.translation, want.translation)
    np.testing.assert_array_equal(got.quaternion, want.quaternion)


@pytest.mark.parametrize("normals", [True, False])
def test_save_ply_equals_jax(tmp_path, normals):
    """The port's save_ply writes the JAX package's bytes, and the file
    loads back to the same mesh."""
    from linemod_tpu.utils.ply import Mesh as JaxMesh
    from linemod_tpu.utils.ply import load_ply as jax_load
    from linemod_tpu.utils.ply import save_ply as jax_save
    from linemod_tpu_torch.utils.ply import Mesh, load_ply, save_ply

    src = jax_load(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    kw = dict(vertices=src.vertices, colors=src.colors, indices=src.indices,
              normals=src.normals if normals else None)
    save_ply(str(tmp_path / "port.ply"), Mesh(**kw))
    jax_save(str(tmp_path / "jax.ply"), JaxMesh(**kw))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = load_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(back.indices, src.indices)
    np.testing.assert_allclose(back.vertices, src.vertices, rtol=0, atol=5e-7 * np.abs(src.vertices).max())
    assert (back.normals is not None) == normals


def test_camera_matrix_and_fov_equal_jax():
    from linemod_tpu import config as jax_config
    from linemod_tpu_torch import config

    settings = os.path.join(EXAMPLE, "linemod_settings.yml")
    cams = [(config.load_settings(settings)[0], jax_config.load_settings(settings)[0]),
            (config.CameraParameters(), jax_config.CameraParameters())]
    for got, want in cams:
        assert got.matrix.dtype == want.matrix.dtype == np.float64
        np.testing.assert_array_equal(got.matrix, want.matrix)
        assert got.fov_y_deg == want.fov_y_deg

