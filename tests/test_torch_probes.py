"""The port's probes (ops/probes.py) against the JAX package's Pallas probe
kernels in interpret mode on the CPU: P1, the u8 <-> i32 bitcast of
scripts/test_bitcast.py, and P2, the 2-D u8 roll of scripts/test_u8_roll.py.
The kernels are restated here as the scripts write them (importing a script
would set the JAX compilation cache for the whole test process). Outputs
are bytes and words, and must be equal.

On the CPU the wrappers run the plain twins; the `cuda`-marked test holds
the CUDA kernels against them on the card, as chip_smoke.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

SHIFTS = [(0, 0), (3, 17), (15, 255), (8, 128)]


def _bitcast_kernel(x_ref, o_ref, o2_ref):
    w = pltpu.bitcast(x_ref[...], jnp.int32)
    o_ref[...] = w
    o2_ref[...] = pltpu.bitcast(w, jnp.uint8)


def _roll_kernel(s_ref, x_ref, o_ref):
    blk = pltpu.roll(x_ref[...], s_ref[0], axis=0)
    o_ref[...] = pltpu.roll(blk, s_ref[1], axis=1)


def _probe_input():
    return np.random.default_rng(0).integers(0, 255, (16, 256), dtype=np.uint8)


def test_bitcast_plain_equals_pallas_probe():
    from linemod_tpu_torch.ops import probes

    x = _probe_input()
    words, back = pl.pallas_call(
        _bitcast_kernel,
        grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((4, 256), jnp.int32), jax.ShapeDtypeStruct((16, 256), jnp.uint8)],
        interpret=True,
    )(jnp.asarray(x))
    b = x.reshape(4, 4, 256).astype(np.uint32)
    lsb_first = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(words), lsb_first)
    np.testing.assert_array_equal(np.asarray(back), x)

    launches = probes.bitcast_u8_to_i32.launches
    got = probes.bitcast_u8_to_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32 and probes.bitcast_u8_to_i32.launches == launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(words))
    back_t = probes.bitcast_i32_to_u8(got)
    assert back_t.dtype == torch.uint8
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back))


@pytest.mark.parametrize("sy,sx", SHIFTS)
def test_roll_plain_equals_pallas_probe(sy, sx):
    from linemod_tpu_torch.ops import probes

    x = _probe_input()
    want = pl.pallas_call(
        _roll_kernel,
        grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((16, 256), jnp.uint8),
        interpret=True,
    )(jnp.asarray([sy, sx], jnp.int32), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want), np.roll(np.roll(x, sy, 0), sx, 1))
    got = probes.roll2d_u8(torch.from_numpy(x), sy, sx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_plain_twins_on_edge_values():
    """Words with the sign bit set survive the round trip, and rolls by
    negative and oversized shifts follow np.roll."""
    from linemod_tpu_torch.ops import probes

    x = np.full((8, 3), 255, np.uint8)
    x[1::4] = 0
    w = probes.bitcast_u8_to_i32(torch.from_numpy(x))
    assert (w.numpy() == 0xFFFF00FF - (1 << 32)).all()
    np.testing.assert_array_equal(probes.bitcast_i32_to_u8(w).numpy(), x)
    y = np.ascontiguousarray(_probe_input()[:5, :7])
    for sy, sx in ((-1, -3), (12, 20)):
        np.testing.assert_array_equal(
            probes.roll2d_u8(torch.from_numpy(y), sy, sx).numpy(), np.roll(np.roll(y, sy, 0), sx, 1)
        )
    with pytest.raises(ValueError):
        probes.bitcast_u8_to_i32(torch.from_numpy(x[:6]))
    with pytest.raises(ValueError):
        probes.roll2d_u8(torch.from_numpy(x).int(), 1, 1)


@pytest.mark.cuda
def test_cuda_probes_equal_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linemod_tpu_torch.ops import probes

    x = torch.from_numpy(_probe_input()).cuda()
    words = probes.bitcast_u8_to_i32(x)
    torch.testing.assert_close(words, probes.bitcast_u8_to_i32_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(probes.bitcast_i32_to_u8(words), x, rtol=0, atol=0)
    for sy, sx in SHIFTS:
        torch.testing.assert_close(probes.roll2d_u8(x, sy, sx), probes.roll2d_u8_plain(x, sy, sx),
                                   rtol=0, atol=0)
