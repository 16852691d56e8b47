"""The port's response-plane stage against the JAX reference on the CPU:
downsample, gradient quantizer, spreading, response maps and the linearized
planes both pyramid levels scan.

Tolerances: planes, maps and offsets are integers and must be equal. The
quantizer must equal the golden map on the fixture exactly; on random frames
the precedent (native/quantize.cpp) is >= 99.9% of pixels, since float sums
may round differently at bin boundaries (they agree fully in practice: the
port reproduces XLA's fused multiply-adds)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
GOLDEN = os.path.join(REPO, "tests", "goldens", "img0_golden.npz")


@pytest.fixture(scope="module")
def fixture_color():
    from linemod_tpu_torch.utils.png import read_png

    # the fixture camera's principal point is the image centre: recentring
    # is the identity on this frame
    return read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")


@pytest.mark.parametrize("shape", [(120, 160, 3), (121, 163, 3), (60, 81)])
def test_downsample2_exact(shape):
    from linemod_tpu.ops.extract import downsample2 as jax_downsample2
    from linemod_tpu_torch.ops.extract import downsample2

    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_downsample2(jnp.asarray(img)))
    np.testing.assert_array_equal(downsample2(torch.from_numpy(img)).numpy(), want)


def test_quantizer_equals_golden_on_fixture(fixture_color):
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients

    quant, _ = quantize_color_gradients(torch.from_numpy(fixture_color).float())
    np.testing.assert_array_equal(quant.numpy(), np.load(GOLDEN)["quant"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_agrees_with_jax_on_random_frames(seed):
    from linemod_tpu.ops.gradients import quantize_color_gradients as jax_quantize
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients

    img = np.random.default_rng(seed).uniform(0, 255, (120, 160, 3)).astype(np.float32)
    want, want_mag = (np.asarray(a) for a in jax_quantize(jnp.asarray(img)))
    got, got_mag = (a.numpy() for a in quantize_color_gradients(torch.from_numpy(img)))
    assert (got == want).mean() >= 0.999
    # the strongest channel's squared magnitude is float: 1e-4 relative
    np.testing.assert_allclose(got_mag, want_mag, rtol=1e-4, atol=1e-3)


def test_fma_is_correctly_rounded():
    """_fma rounds a * b + c once: compared with exact rational arithmetic on
    float32 inputs, including cases where a plain float64 sum double-rounds."""
    from fractions import Fraction

    from linemod_tpu_torch.ops.gradients import _fma

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-8, 8, 2000)).astype(np.float32)
    # an exact tie, and a sum 2^-60 below a float32 midpoint that a plain
    # float64 sum rounds onto the midpoint and then to the wrong neighbour
    e = np.float32(2.0**-18)
    a[:2] = np.float32([1.0, 1.0 + e])
    b[:2] = np.float32([2.0**-24, 2.0**-24 * (1.0 - e)])
    c[:2] = np.float32([1.0, 1.0 + 2.0**-23])
    naive = np.float32(float(a[1]) * float(b[1]) + float(c[1]))
    assert naive == np.float32(1.0 + 2.0**-22)  # double rounding
    got = _fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest float32 to the exact value, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        want = ties[0] if len(ties) == 1 else next(v for v in ties if not v.view(np.int32) & 1)
        assert got[i] == want, (i, a[i], b[i], c[i])


@pytest.mark.parametrize("t", [2, 5, 8])
def test_spread_and_response_maps_equal_jax(t):
    from linemod_tpu.ops import spread as jax_spread
    from linemod_tpu_torch.ops import spread

    rng = np.random.default_rng(t)
    quant = (1 << rng.integers(0, 8, (48, 64))).astype(np.uint8)
    quant[rng.random((48, 64)) < 0.3] = 0
    want = np.asarray(jax_spread.spread_orientations(jnp.asarray(quant), t))
    got = spread.spread_orientations(torch.from_numpy(quant), t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        spread.response_maps(got).numpy(),
        np.asarray(jax_spread.response_maps(jnp.asarray(want))),
    )
    h, w = 48 - 48 % t, 64 - 64 % t
    q = quant[:h, :w]
    np.testing.assert_array_equal(
        spread.linearized_response_planes(torch.from_numpy(q), t, 7).numpy(),
        np.asarray(jax_spread.linearized_response_planes(jnp.asarray(q), t, 7)),
    )
    assert spread.linear_plane_shape(h, w, t, 7) == jax_spread.linear_plane_shape(h, w, t, 7)


def test_feature_flat_offsets_equal_jax():
    from linemod_tpu.ops.spread import feature_flat_offsets as jax_offsets
    from linemod_tpu_torch.ops.spread import feature_flat_offsets

    rng = np.random.default_rng(3)
    xs, ys, oris = rng.integers(0, 96, 500), rng.integers(0, 96, 500), rng.integers(0, 8, 500)
    for t in (2, 8):
        np.testing.assert_array_equal(
            feature_flat_offsets(xs, ys, oris, t, 304, 384),
            jax_offsets(xs, ys, oris, t, 304, 384),
        )


@pytest.mark.parametrize("level", ["fine", "coarse"])
def test_fixture_planes_byte_equal_jax(fixture_color, level):
    """Both pyramid levels' planes on the fixture frame, as the main path
    builds them (fixture bank extents: 58 fine / 9 coarse max cells)."""
    from linemod_tpu.ops.extract import downsample2 as jax_downsample2
    from linemod_tpu.ops.matching import _planes_3d as jax_planes_3d
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.matching import _planes_3d

    t, max_cells = (2, 58) if level == "fine" else (8, 9)
    color = fixture_color.astype(np.float32)
    jcolor = jnp.asarray(color)
    tcolor = torch.from_numpy(color)
    if level == "coarse":
        jcolor, tcolor = jax_downsample2(jcolor), downsample2(tcolor)
    want = np.asarray(jax_planes_3d(jcolor, jnp.zeros(jcolor.shape[:2]), t, max_cells, False))
    got = _planes_3d(tcolor, t, max_cells).numpy()
    assert got.shape == want.shape == ((33, 304, 384) if level == "fine" else (513, 48, 128))
    np.testing.assert_array_equal(got, want)
