"""The color-gradient quantizer's CUDA kernel (`csrc/quantize.cu`) against
the plain PyTorch chain it replaces (`ops/gradients.quantize_color_gradients_plain`),
bit for bit on both outputs.

On the card (`python -m pytest tests/test_torch_gradients_cuda.py -m cuda`)
the `cuda`-marked test launches the kernel through the wrapper at the main
path's shapes and at the edges. Here, without a card, the kernel's own
source is compiled by g++ with its CUDA intrinsics mapped to the host's
IEEE float operations and run one block at a time as one thread a block
(each stage strides by blockDim.x), which checks its indexing, halos,
clamping and arithmetic order on the same cases; the wrapper given CPU
tensors must take the plain route and launch nothing. The plain chain
itself is held to JAX by tests/test_torch_response.py and the fixture
tests."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from linemod_tpu_torch.ops import cuda_lib, gradients
from linemod_tpu_torch.ops.extract import downsample2

torch.set_num_threads(2)

# (name, (batch or None, H, W), frame kind, half): the card's cases
CARD_CASES = [
    ("640x480", (None, 480, 640), "blocks", False),
    ("1280x960", (None, 960, 1280), "integer", False),
    ("320x240", (None, 240, 320), "blocks", False),
    ("481x643", (None, 643, 481), "integer", False),
    ("7x9", (None, 9, 7), "blocks", False),
    ("batch4", (4, 240, 320), "blocks", False),
    ("flat", (None, 480, 640), "flat", False),
    ("ties", (None, 480, 640), "ties", False),
    ("half-640x480", (None, 480, 640), "blocks", True),
    ("half-1280x960", (None, 960, 1280), "integer", True),
    ("half-481x643", (None, 643, 481), "integer", True),
    ("half-7x9", (None, 9, 7), "blocks", True),
    ("half-batch4-odd", (4, 241, 323), "ties", True),
]
# the host's cases: the same kinds at sizes the plain chain runs quickly on
# the CPU, tiles cut by the image's edges in both directions
HOST_CASES = [
    ("64x48", (None, 48, 64), "blocks", False),
    ("67x37", (None, 37, 67), "integer", False),
    ("7x9", (None, 9, 7), "blocks", False),
    ("1x1", (None, 1, 1), "blocks", False),
    ("batch3", (3, 20, 33), "integer", False),
    ("flat", (None, 24, 40), "flat", False),
    ("ties", (None, 40, 70), "ties", False),
    ("half-64x48", (None, 48, 64), "blocks", True),
    ("half-67x37", (None, 37, 67), "integer", True),
    ("half-3x2", (None, 2, 3), "blocks", True),
    ("half-batch3-odd", (3, 35, 41), "ties", True),
]


def frame(shape, kind: str, seed: int = 7) -> np.ndarray:
    """A seeded float32 BGR frame [*batch, H, W, 3], 0..255: 8x8 blocks of
    random color (edges in every direction and flat patches) with Gaussian
    noise ("blocks"), the same rounded to whole numbers as a camera gives
    them ("integer"), gray in the top half and two equal channels below
    ("ties": the channel pick's ties), or one value everywhere ("flat":
    every gradient 0)."""
    batch, h, w = shape
    lead = () if batch is None else (batch,)
    if kind == "flat":
        return np.full(lead + (h, w, 3), 128.0, np.float32)
    rng = np.random.default_rng([seed, h, w])
    cells = rng.integers(0, 256, lead + (h // 8 + 1, w // 8 + 1, 3)).astype(np.float64)
    img = np.repeat(np.repeat(cells, 8, axis=-3), 8, axis=-2)[..., :h, :w, :]
    img = img + rng.normal(0.0, 3.0, img.shape)
    if kind == "integer":
        img = np.round(img)
    if kind == "ties":
        img[..., 2] = img[..., 1]
        img[..., : h // 2, :, 0] = img[..., : h // 2, :, 1]
    return np.clip(img, 0, 255).astype(np.float32)


def plain(img: torch.Tensor, half: bool):
    """The plain chain at the level the kernel quantizes."""
    if half:
        if img.dim() == 4:
            return tuple(torch.stack(o) for o in zip(*(plain(v, True) for v in img)))
        img = downsample2(img)
    return gradients.quantize_color_gradients_plain(img)


def assert_bits_equal(got, want):
    (q, m), (wq, wm) = got, want
    assert q.dtype == torch.uint8 and m.dtype == torch.float32
    assert q.shape == wq.shape and m.shape == wm.shape
    assert torch.equal(q, wq), f"{int((q != wq).sum())} orientations differ"
    same = m.view(torch.int32) == wm.view(torch.int32)
    assert bool(same.all()), f"{int((~same).sum())} magnitudes differ in their bits"


def test_constants_equal_the_plain_versions():
    """The kernel's hexadecimal float32 literals are gradients.py's values."""
    with open(os.path.join(cuda_lib.CSRC, "quantize.cu")) as f:
        src = f.read()

    def array(name):
        body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src).group(1)
        return np.array([float.fromhex(v.strip().rstrip("f")) for v in body.split(",")], np.float32)

    def scalar(name):
        return np.float32(float.fromhex(re.search(rf"float {name} = ([-0-9a-fx.p+]+)f;", src).group(1)))

    np.testing.assert_array_equal(array("kGauss"), gradients._gaussian_kernel_1d(7))
    np.testing.assert_array_equal(array("kAtanHi"), gradients._ATAN_HI)
    np.testing.assert_array_equal(array("kAtanLo"), gradients._ATAN_LO)
    np.testing.assert_array_equal(array("kAtanOdd"), gradients._ATAN_ODD)
    np.testing.assert_array_equal(array("kAtanEven"), gradients._ATAN_EVEN)
    assert scalar("kPi") == gradients._PI and scalar("kPiO2") == gradients._PI_O_2
    assert scalar("kPiLo") == gradients._PI_LO
    assert scalar("kTiny") == np.float32(1e-30)
    assert scalar("kBinScale") == np.float32(16.0 / (2.0 * np.pi))
    assert scalar("kMinNormal") == np.float32(2.0**-126)
    assert int(re.search(r"kMinVotes = (\d+);", src).group(1)) == gradients.NEIGHBOR_VOTES


# the kernel's source on the host: CUDA's qualifiers and intrinsics as plain
# C++ (IEEE float32 operations, no contraction), one thread a block
_HOST_SHIM = r"""
#include <math.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
struct dim3 { unsigned x, y, z; };
static dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __constant__ static
#define __launch_bounds__(n)
#define __syncthreads()
using std::max;
using std::min;
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline int __float_as_int(float v) { int i; std::memcpy(&i, &v, 4); return i; }
"""
_HOST_DRIVER = r"""
extern "C" void run(const float* img, int batch, int src_h, int src_w, int half, float strong2,
                    uint8_t* quant, float* mag2) {
  const int h = half ? src_h / 2 : src_h;
  const int w = half ? src_w / 2 : src_w;
  for (int z = 0; z < batch; ++z)
    for (int by = 0; by < (h + kTileH - 1) / kTileH; ++by)
      for (int bx = 0; bx < (w + kTileW - 1) / kTileW; ++bx) {
        blockIdx = {unsigned(bx), unsigned(by), unsigned(z)};
        if (half) gradient_quant_kernel<true>(img, src_h, src_w, h, w, strong2, quant, mag2);
        else gradient_quant_kernel<false>(img, src_h, src_w, h, w, strong2, quant, mag2);
      }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's source for the host")
    with open(os.path.join(cuda_lib.CSRC, "quantize.cu")) as f:
        src = f.read()
    body = src[: src.index("}  // namespace") + len("}  // namespace")]
    body = body.replace("#include <cuda_runtime.h>", "")
    path = tmp_path_factory.mktemp("quantize_host")
    cpp, lib = path / "quantize_host.cpp", path / "quantize_host.so"
    cpp.write_text(_HOST_SHIM + body + _HOST_DRIVER)
    out = subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                          str(cpp)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_void_p]
    run.restype = None
    return run


@pytest.mark.parametrize("name,shape,kind,half", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_kernel_source_on_the_host_equals_plain(host_kernel, name, shape, kind, half):
    img = torch.from_numpy(frame(shape, kind))
    src_h, src_w = img.shape[-3:-1]
    h, w = (src_h // 2, src_w // 2) if half else (src_h, src_w)
    lead = img.shape[:-3]
    quant = torch.empty((*lead, h, w), dtype=torch.uint8)
    mag2 = torch.empty((*lead, h, w), dtype=torch.float32)
    batch = 1 if not lead else lead[0]
    strong2 = float(np.float32(gradients.WEAK_THRESHOLD**2))
    host_kernel(img.data_ptr(), batch, src_h, src_w, int(half), strong2, quant.data_ptr(), mag2.data_ptr())
    assert_bits_equal((quant, mag2), plain(img, half))


@pytest.mark.parametrize("name,shape,kind,half", HOST_CASES[:2] + HOST_CASES[7:],
                         ids=[c[0] for c in HOST_CASES[:2] + HOST_CASES[7:]])
def test_cpu_tensors_take_the_plain_route(name, shape, kind, half):
    img = torch.from_numpy(frame(shape, kind))
    launches = gradients.quantize_color_gradients.launches
    got = gradients.quantize_color_gradients(img, half=half)
    assert gradients.quantize_color_gradients.launches == launches
    assert_bits_equal(got, plain(img, half))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gradients.quantize_color_gradients(torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        gradients.quantize_color_gradients(torch.zeros((4, 4, 4)))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kind,half", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_equals_plain_on_the_card(name, shape, kind, half):
    """One launch a call, both outputs equal to the plain chain's on the
    card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = torch.from_numpy(frame(shape, kind)).cuda()
    launches = gradients.quantize_color_gradients.launches
    got = gradients.quantize_color_gradients(img, half=half)
    torch.cuda.synchronize()
    assert gradients.quantize_color_gradients.launches == launches + 1
    assert_bits_equal(got, plain(img, half))
