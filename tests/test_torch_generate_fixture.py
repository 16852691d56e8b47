"""The fixture model's template banks generated by the port on the CPU,
held row for row to the JAX package's generation.

Narrowed to one in-plane angle (-45) at radius 500, generation gives 13
templates, which are rows 0:130:10 of a full radius. The port's dual bank
is held to the committed `example/banks_dual/lagergehaeuse.npz` (JAX's CPU
generation) and its color bank to `tests/goldens/gen_color_r500_ref.npz`
(JAX's CPU color generation of radius 500; the committed
`example/banks/lagergehaeuse.npz` is an older generation and is not a
golden), every array with `np.array_equal`. A drift test regenerates the
subset with the JAX package and holds it to the same golden rows.

The 13 renders are shared: the dual bank reuses the color bank's renders
of the same poses. On them, the port's feature extraction (per level and
modality: x, y, ori, valid) and its quantizers (quantized maps and squared
magnitudes) equal JAX's bit for bit.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_generate import COLOR_GOLDEN, DUAL_FIELDS, EXAMPLE, FIELDS, MODEL  # noqa: E402

torch.set_num_threads(2)

DUAL_BANK = os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")
ROWS = slice(0, 130, 10)  # the -45 degree view of each of the 13 viewpoints


def narrowed(settings, color: bool):
    return dataclasses.replace(settings, distance_stop=settings.distance_start, angle_start=-45,
                               angle_stop=-45, only_color_modality=color)


@pytest.fixture(scope="module")
def generated():
    """The port's color and dual banks of the 13-template subset, and the
    renders they share ((depth [13, 320, 320], color [13, 320, 320, 3]))."""
    import linemod_tpu_torch.models.template_bank as tb
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.utils.mesh_io import load_mesh

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    mesh, props = load_mesh(MODEL), load_model_properties(MODEL)
    renders = {}
    render = tb.render

    def memo(mesh_, rot, trans, *args, **kw):
        key = (rot.tobytes(), trans.tobytes())
        if key not in renders:
            renders[key] = render(mesh_, rot, trans, *args, **kw)
        return renders[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(tb, "render", memo)
    try:
        banks = {kind: tb.build_template_bank(mesh, "lagergehaeuse.ply", cam, narrowed(settings, kind == "color"),
                                              props, "cpu")
                 for kind in ("color", "dual")}
    finally:
        mp.undo()
    assert len(renders) == 13
    depth = torch.stack([d for d, _ in renders.values()])
    color = torch.stack([c for _, c in renders.values()]) * 255.0
    return banks, depth, color


def test_color_bank_equals_golden_rows(generated):
    banks, *_ = generated
    with np.load(COLOR_GOLDEN) as g:
        assert g["quat"].shape[0] == 130
        for f in FIELDS:
            want = g[f][ROWS]
            got = getattr(banks["color"], f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_dual_bank_equals_committed_rows(generated):
    banks, *_ = generated
    assert banks["dual"].dual_modality
    with np.load(DUAL_BANK) as g:
        assert g["quat"].shape[0] == 1950
        for f in FIELDS + DUAL_FIELDS:
            want = g[f][ROWS]
            got = getattr(banks["dual"], f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_jax_generation_still_equals_golden_rows():
    """The golden is still what the JAX package generates (a drift check of
    the reference, not of the port)."""
    from linemod_tpu.config import load_model_properties, load_settings
    from linemod_tpu.models.template_bank import build_template_bank
    from linemod_tpu.utils.mesh_io import load_mesh

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    bank = build_template_bank(load_mesh(MODEL), "lagergehaeuse.ply", cam, narrowed(settings, True),
                               load_model_properties(MODEL))
    with np.load(COLOR_GOLDEN) as g:
        for f in FIELDS:
            assert np.array_equal(getattr(bank, f), g[f][ROWS]), f


def test_extraction_equals_jax_on_fixture_renders(generated):
    """On the 13 renders: the port's extraction (both modalities, both
    levels) equals JAX's vmapped `extract_template`, and its quantizers'
    maps and squared magnitudes equal JAX's, at 320 x 320 and 160 x 160."""
    from linemod_tpu.ops.extract import downsample2 as j_down
    from linemod_tpu.ops.extract import extract_template as j_extract
    from linemod_tpu.ops.gradients import quantize_color_gradients as j_qcolor
    from linemod_tpu.ops.normals import quantize_normals as j_qnormals
    from linemod_tpu_torch.ops.extract import downsample2, extract_template
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.normals import quantize_normals

    _, depth, color = generated
    jc, jd = jnp.asarray(color.numpy()), jnp.asarray(depth.numpy())
    want = jax.jit(jax.vmap(lambda c, d: j_extract(c, d, dual_modality=True)))(jc, jd)
    got = extract_template(color, depth, dual_modality=True)
    assert set(got) == set(want) == {"grad0", "grad1", "norm0", "norm1"}
    for key in want:
        assert got[key][3].sum() > 13 * 8
        for name, a, b in zip(("x", "y", "ori", "valid"), got[key], want[key]):
            assert np.array_equal(a.numpy(), np.asarray(b)), (key, name)

    color1 = downsample2(color.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)
    jcolor1 = jax.vmap(j_down)(jc)
    assert np.array_equal(color1.numpy(), np.asarray(jcolor1))
    cases = [
        (quantize_color_gradients, j_qcolor, color, jc),
        (quantize_color_gradients, j_qcolor, color1, jcolor1),
        (quantize_normals, j_qnormals, depth, jd),
        (quantize_normals, j_qnormals, depth[:, ::2, ::2], jd[:, ::2, ::2]),
    ]
    for port_fn, jax_fn, x, jx in cases:
        quant, mag2 = port_fn(x)
        j_quant, j_mag2 = jax.jit(jax.vmap(jax_fn))(jx)
        assert (quant != 0).sum() > 1000
        assert np.array_equal(quant.numpy(), np.asarray(j_quant))
        assert np.array_equal(mag2.numpy(), np.asarray(j_mag2))
