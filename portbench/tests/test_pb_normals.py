"""The plain reference's depth-normal quantizer equals the port's
(`linemod_tpu_torch.ops.normals.quantize_normals`) bit for bit on seeded
depth frames with holes and discontinuities, and on the fixture scene."""

import os

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import normals


def _depth(seed: int, h: int, w: int) -> np.ndarray:
    """Slanted planes and a sphere cap in integer mm, with steps of 20-200 mm
    (some under the 50 mm rejection, some over), single-pixel and block holes,
    and sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 700 + rng.uniform(-3, 3) * xx + rng.uniform(-3, 3) * yy
    cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(h / 6, h / 2)
    cap = np.sqrt(np.maximum(r * r - (yy - cy) ** 2 - (xx - cx) ** 2, 0))
    d = d - cap
    for _ in range(6):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        d[y0:, x0:] += rng.choice([20, 45, 49, 50, 51, 120, 200]) * rng.choice([-1, 1])
    d = np.round(d + rng.integers(-2, 3, d.shape))
    d[rng.random(d.shape) < 0.03] = 0
    for _ in range(4):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        d[y0 : y0 + rng.integers(1, 12), x0 : x0 + rng.integers(1, 12)] = 0
    return np.clip(d, 0, 65535).astype(np.uint16)


def _port(depth: np.ndarray) -> np.ndarray:
    from linemod_tpu_torch.ops.normals import quantize_normals

    return quantize_normals(torch.as_tensor(depth.astype(np.float32)))[0].numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 2**31 + 5])
@pytest.mark.parametrize("shape", [(60, 80), (97, 131)])
def test_reference_equals_the_port_on_seeded_depths(seed, shape):
    depth = _depth(seed, *shape)
    want = _port(depth)
    got = normals.quantize_normals(torch.as_tensor(depth.astype(np.float32))).numpy()
    assert (want != 0).mean() > 0.2 and len(np.unique(want)) >= 6
    assert np.array_equal(got, want)


def test_reference_equals_the_port_on_the_fixture_scene():
    with np.load(os.path.join(inputs.ROOT, "data", "fixture.npz")) as z:
        depth = z["depth"]
    for d in (depth, depth[::2, ::2]):
        got = normals.quantize_normals(torch.as_tensor(d.astype(np.float32))).numpy()
        assert np.array_equal(got, _port(d))
