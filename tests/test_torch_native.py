"""The port's host ingest (`linemod_tpu_torch/utils/native.py`) against the
JAX package's native runtime (`linemod_tpu/utils/native.py`) on the CPU.

- `quantize_frame`, the port's own copy of `native/quantize.cpp` built by
  g++ into `build/host/` at first use, equals the reference's
  `native.quantize_frame` bit for bit: on the fixture frame (whose maps are
  also the golden's, JAX's device quantizer) and on frames drawn by
  hypothesis from a seed (uniform noise, blurred noise, binary edges and
  noisy stripes, even sizes). The port's device quantizer,
  `ops/gradients.quantize_color_gradients`, equals XLA's on the same
  frames, so the port's two quantizers agree at both pyramid levels
  wherever the reference's two agree; on the fixture and on fixed seeds
  all four agree. The reference's two disagree at a few pixels of some
  drawn frames (about one 48x64 frame in 90): a reference defect, pinned
  by `test_reference_quantizers_disagree_on_a_drawn_frame`, where the port
  reproduces both sides.
- `decode_png`, `NativeFrameLoader` and the garbage error: the counterparts
  of `tests/test_native.py`, on `example/` (the reference's tests read a
  `fixture_paths` tree that does not exist here).
- `cli._frame_source`: a `%d` PNG sequence goes through the loader, a
  `.dpt` depth through FileSequenceSource, and a frame that does not decode
  raises.

Tolerance: 0 everywhere (orientation maps and pixels are integers).
"""

import os
import shutil
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
IMG0 = os.path.join(EXAMPLE, "benchmark", "img0.png")
DEPTH0 = os.path.join(EXAMPLE, "benchmark", "depth0.png")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")


def drawn_frame(seed: int, h: int, w: int, kind: str) -> np.ndarray:
    """A BGR uint8 [h, w, 3] test frame from a seed."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "blurred":
        return np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    if kind == "edges":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    a, f = rng.uniform(0, 2 * np.pi), rng.uniform(0.05, 1.0)
    base = 127.5 + 127.5 * np.sin(f * (np.cos(a) * xx + np.sin(a) * yy))
    return np.clip(base[..., None] + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)


def _port_device_maps(color: np.ndarray):
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients

    colorf = torch.from_numpy(color).float()
    return (quantize_color_gradients(colorf)[0].numpy(),
            quantize_color_gradients(downsample2(colorf))[0].numpy())


def _assert_maps_equal(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w, err_msg=f"level {level}")


def test_quantize_frame_fixture_equals_jax_native_and_golden():
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import quantize_frame
    from linemod_tpu_torch.utils.png import read_png

    ref = np.load(TORCH_REF)
    color = read_png(IMG0, "color")  # the fixture's camera centres it already
    got = quantize_frame(color)
    _assert_maps_equal(got, jax_native.quantize_frame(color))
    _assert_maps_equal(got, (ref["quant0"], ref["quant1"]))
    _assert_maps_equal(got, _port_device_maps(color))
    assert int((got[0] > 0).sum()) > 10000


def _jax_device_maps(color: np.ndarray):
    from linemod_tpu.ops.extract import downsample2
    from linemod_tpu.ops.gradients import quantize_color_gradients

    colorf = jnp.asarray(color.astype(np.float32))
    return (np.asarray(quantize_color_gradients(colorf)[0]),
            np.asarray(quantize_color_gradients(downsample2(colorf))[0]))


@settings(max_examples=6, deadline=60000, derandomize=True)
@given(
    seed=st.integers(0, 2**31 - 1),
    h=st.integers(3, 32).map(lambda v: 2 * v),
    w=st.integers(3, 32).map(lambda v: 2 * v),
    kind=st.sampled_from(["noise", "blurred", "edges", "stripes"]),
)
def test_quantize_frame_drawn_equals_jax_native_and_device_quantizer(seed, h, w, kind):
    """The host quantizer equals the reference's bit for bit, the port's
    device quantizer equals XLA's, and so the port's two quantizers agree
    wherever the reference's two agree and differ exactly where they
    differ (a reference defect, pinned below)."""
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import quantize_frame

    color = drawn_frame(seed, h, w, kind)
    host, jax_host = quantize_frame(color), jax_native.quantize_frame(color)
    device, jax_device = _port_device_maps(color), _jax_device_maps(color)
    _assert_maps_equal(host, jax_host)
    _assert_maps_equal(device, jax_device)
    for level in (0, 1):
        np.testing.assert_array_equal(host[level] != device[level], jax_host[level] != jax_device[level])


@pytest.mark.parametrize("seed,h,w,kind", [(0, 48, 64, "noise"), (1, 36, 50, "stripes"), (3, 40, 40, "edges")])
def test_quantize_frame_equals_device_quantizers(seed, h, w, kind):
    """On these frames the reference's two quantizers agree, and the port's
    host quantizer equals both device quantizers at both levels."""
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import quantize_frame

    color = drawn_frame(seed, h, w, kind)
    xla = _jax_device_maps(color)
    _assert_maps_equal(jax_native.quantize_frame(color), xla)
    _assert_maps_equal(quantize_frame(color), xla)
    _assert_maps_equal(quantize_frame(color), _port_device_maps(color))


# a reference defect: on this drawn frame the reference's host quantizer
# (native/quantize.cpp) and its device quantizer (XLA) disagree at two
# pixels of each level, as (level, row, column, host value, device value).
# The two float32 programs do not round alike (XLA's CPU program fuses
# multiply-adds, the C++ does not; building the C++ with FMA contraction does
# not make them agree, so the pixels' exact cause is not traced); about one
# drawn 48x64 frame in 90 has such pixels. The fixture frame has none.
DISAGREEING_FRAME = (249, 48, 64, "blurred")
DISAGREEING_PIXELS = [(0, 44, 19, 0, 64), (0, 44, 20, 0, 64), (1, 6, 9, 128, 0), (1, 6, 10, 128, 0)]


def test_reference_quantizers_disagree_on_a_drawn_frame():
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import quantize_frame

    color = drawn_frame(*DISAGREEING_FRAME)
    sides = {
        "reference": (jax_native.quantize_frame(color), _jax_device_maps(color)),
        "port": (quantize_frame(color), _port_device_maps(color)),
    }
    for name, (host, device) in sides.items():
        got = [(level, int(y), int(x), int(host[level][y, x]), int(device[level][y, x]))
               for level in (0, 1) for y, x in np.argwhere(host[level] != device[level])]
        assert got == DISAGREEING_PIXELS, name
    _assert_maps_equal(sides["port"][0], sides["reference"][0])
    _assert_maps_equal(sides["port"][1], sides["reference"][1])


def test_quantize_frame_builds_into_build_host():
    from linemod_tpu_torch.utils import hostlib
    from linemod_tpu_torch.utils.native import QUANTIZE_FLAGS, quantize_frame

    quantize_frame(drawn_frame(0, 8, 8, "noise"))
    path = hostlib.library_path("quantize", QUANTIZE_FLAGS)
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "host")
    assert not {"-march=native", "-ffast-math"} & set(QUANTIZE_FLAGS)
    with pytest.raises(ValueError):
        quantize_frame(np.zeros((8, 8), np.uint8))


def test_png_decode_equals_jax_and_cv2():
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import decode_png

    img = decode_png(IMG0)
    depth = decode_png(DEPTH0)
    np.testing.assert_array_equal(img, jax_native.decode_png(IMG0))
    np.testing.assert_array_equal(depth, jax_native.decode_png(DEPTH0))
    np.testing.assert_array_equal(img[..., ::-1], cv2.imread(IMG0))
    np.testing.assert_array_equal(depth, cv2.imread(DEPTH0, cv2.IMREAD_ANYDEPTH))
    assert img.dtype == np.uint8 and depth.dtype == np.uint16


def _sequence(tmp_path, n=3):
    for i in range(n):
        shutil.copy(IMG0, tmp_path / f"img{i}.png")
        shutil.copy(DEPTH0, tmp_path / f"depth{i}.png")
    return str(tmp_path / "img%d.png"), str(tmp_path / "depth%d.png")


def test_prefetch_loader_sequence(tmp_path):
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import NativeFrameLoader

    imgs, depths = _sequence(tmp_path)
    ld = NativeFrameLoader(imgs, depths)
    frames = list(ld)
    ld.close()
    ld.close()  # idempotent
    jax_ld = jax_native.NativeFrameLoader(imgs, depths)
    want = list(jax_ld)
    jax_ld.close()
    assert len(frames) == len(want) == 3
    ref = cv2.imread(IMG0)
    for (color, depth), (jcolor, jdepth) in zip(frames, want):
        np.testing.assert_array_equal(color, ref)
        np.testing.assert_array_equal(color, jcolor)
        np.testing.assert_array_equal(depth, jdepth)
        assert depth.dtype == np.uint16 and depth.max() == 983


def test_prefetch_loader_decodes_one_frame_ahead(tmp_path):
    """Frame i+1 is decoded on the loader's thread once frame i is handed
    out, before the caller asks for it, and no further."""
    from linemod_tpu_torch.utils.native import NativeFrameLoader

    imgs, depths = _sequence(tmp_path)
    with NativeFrameLoader(imgs, depths) as ld:
        next(ld)
        t0 = time.monotonic()
        while not ld._next.done() and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert ld._next.done() and ld._next.result() is not None
        os.remove(tmp_path / "img1.png")  # already decoded: still handed out
        color, _ = next(ld)
        np.testing.assert_array_equal(color, cv2.imread(IMG0))
        assert ld._index == 2
    assert ld._pool is None and ld._next is None


def test_prefetch_loader_stops_at_first_missing_frame(tmp_path):
    from linemod_tpu_torch.utils.native import NativeFrameLoader

    imgs, depths = _sequence(tmp_path)
    os.remove(tmp_path / "depth1.png")
    with NativeFrameLoader(imgs, depths) as ld:
        assert len(list(ld)) == 1
    with NativeFrameLoader(str(tmp_path / "none%d.png"), depths) as ld:
        assert list(ld) == []


def test_prefetch_loader_raises_on_a_bad_frame(tmp_path):
    from linemod_tpu_torch.utils.native import NativeFrameLoader

    imgs, depths = _sequence(tmp_path)
    (tmp_path / "img1.png").write_bytes(b"not a png at all")
    with NativeFrameLoader(imgs, depths) as ld:
        next(ld)
        with pytest.raises(ValueError, match="not a PNG"):
            next(ld)
    with NativeFrameLoader(imgs, depths, width=320, height=240) as ld:
        with pytest.raises(ValueError, match="240x320"):
            next(ld)


def _bad_files(tmp_path):
    from linemod_tpu_torch.utils.png import encode_png

    good = open(IMG0, "rb").read()
    rgba = encode_png(np.zeros((4, 16), np.uint8), 4, 6, 8)
    return {
        "garbage": b"not a png at all",
        "truncated": good[: len(good) // 2],
        "rgba": rgba,
        "empty": b"",
    }


@pytest.mark.parametrize("kind", ["garbage", "truncated", "rgba", "empty"])
def test_decode_error_on_garbage(tmp_path, kind):
    from linemod_tpu.utils import native as jax_native
    from linemod_tpu_torch.utils.native import decode_png

    p = tmp_path / "bad.png"
    p.write_bytes(_bad_files(tmp_path)[kind])
    with pytest.raises(IOError):
        jax_native.decode_png(str(p))
    with pytest.raises(IOError):
        decode_png(str(p))
    with pytest.raises(IOError):
        decode_png(str(tmp_path / "missing.png"))


def test_cli_frame_source_routes(tmp_path):
    """`%d` PNG pairs go through the prefetching loader; a `.dpt` depth
    through FileSequenceSource; the frames equal FileSequenceSource's; a
    frame that does not decode raises from the loader, with no fallback."""
    from linemod_tpu_torch.cli import _frame_source
    from linemod_tpu_torch.pipeline.sensors import FileSequenceSource
    from linemod_tpu_torch.utils import native
    from linemod_tpu_torch.utils.io import save_depth_linemod_dataset

    imgs, depths = _sequence(tmp_path, 2)
    opened = []
    real = native.NativeFrameLoader

    class Spy(real):
        def __init__(self, *args):
            opened.append(args)
            super().__init__(*args)

    native.NativeFrameLoader = Spy
    try:
        got = list(_frame_source(imgs, depths, 640, 480))
        assert opened == [(imgs, depths, 640, 480)]
        want = list(FileSequenceSource(imgs, depths))
        assert len(got) == len(want) == 2
        for (c, d), (wc, wd) in zip(got, want):
            np.testing.assert_array_equal(c, wc)
            np.testing.assert_array_equal(d, wd)
        one = tmp_path / "dpt"
        one.mkdir()
        shutil.copy(IMG0, one / "img0.png")
        save_depth_linemod_dataset(str(one / "depth0.dpt"), want[0][1])
        dpt = list(_frame_source(str(one / "img%d.png"), str(one / "depth%d.dpt"), 640, 480))
        assert len(opened) == 1 and len(dpt) == 1
        np.testing.assert_array_equal(dpt[0][1], want[0][1])
        (tmp_path / "img1.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
        with pytest.raises(ValueError):
            list(_frame_source(imgs, depths, 640, 480))
    finally:
        native.NativeFrameLoader = real
