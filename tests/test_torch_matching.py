"""The port's match program against the JAX reference on the CPU: the match
state built from a bank, the canonical candidate cut on ties, and the whole
per-frame program on a synthetic bank and random frames.

Tolerances: state tensors, template ids, cells, x, y and valid flags exact;
similarities atol 1e-4 (they agree bit for bit in practice: the percent
scale is computed in the same float32 order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _jax_state_parts(state):
    from linemod_tpu_torch.ops.matching import META_FIELDS, TENSOR_FIELDS

    arrays = {k: np.asarray(getattr(state, k)) for k in TENSOR_FIELDS}
    meta = {k: getattr(state, k) for k in META_FIELDS}
    meta["cfg"] = dataclasses.asdict(state.cfg)
    return arrays, meta


def _assert_states_equal(got, want):
    from linemod_tpu_torch.ops.matching import META_FIELDS, TENSOR_FIELDS

    for k in TENSOR_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == torch.int32, k
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    for k in META_FIELDS:
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("bank_kind", ["synthetic", "fixture"])
def test_build_match_state_equals_jax(bank_kind):
    """build_match_state == match_state_from_numpy(the JAX state), field by
    field, on a padded synthetic bank and on the padded fixture bank."""
    import os

    from linemod_tpu.models.template_bank import TemplateBank as JaxBank
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu.pipeline.pose_detection import _pad_bank as jax_pad
    from linemod_tpu_torch.models.template_bank import (
        TemplateBank,
        _pad_bank,
        make_synthetic_bank,
    )
    from linemod_tpu_torch.ops.matching import (
        MatchConfig,
        build_match_state,
        match_state_from_numpy,
    )

    if bank_kind == "synthetic":
        jbank = jax_synthetic(40, seed=8, bbox_wh=40)
        bank = make_synthetic_bank(40, seed=8, bbox_wh=40)
        bank.valid1[3, 20:] = jbank.valid1[3, 20:] = False
        kw = dict(width=320, height=240, template_chunk=16)
    else:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "example", "banks", "lagergehaeuse.npz",
        )
        jbank, bank = JaxBank.load(path), TemplateBank.load(path)
        kw = dict(template_chunk=256)
    jstate = jax_build(jax_pad(jbank, kw["template_chunk"]), JaxConfig(**kw))
    state = build_match_state(_pad_bank(bank, kw["template_chunk"]), MatchConfig(**kw), "cpu")
    assert state.n_templates % kw["template_chunk"] == 0
    _assert_states_equal(state, match_state_from_numpy(*_jax_state_parts(jstate), "cpu"))


def test_match_state_rejects_out_of_plane_triplets():
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state

    bank = make_synthetic_bank(4, seed=0, bbox_wh=32)
    bank.feat1[0, 0, 1] = 400  # y far below the bbox the planes are padded for
    with pytest.raises(ValueError):
        build_match_state(bank, MatchConfig(width=320, height=240, template_chunk=4), "cpu")


def test_candidate_cut_equals_jax_on_ties():
    """More than top_k equal similarities above threshold, spread over all
    blocks of the JAX blocked cut (cut_block_rows=256 -> 8 blocks of 128
    rows here): both cuts keep the lowest flat indices among the tied."""
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import candidate_cut as jax_cut
    from linemod_tpu_torch.ops.matching import candidate_cut

    n, cw, top_k = 1024, 40, 512
    rng = np.random.default_rng(0)
    sim = rng.choice(np.float32([-1.0, 60.0, 81.25, 97.2]), size=(n, 30 * cw), p=[0.2, 0.5, 0.2997, 0.0003])
    sim[rng.integers(0, n, 40), rng.integers(0, 30 * cw, 40)] = 100.0
    tied = int((sim == np.float32(97.2)).sum())
    assert int((sim >= np.float32(97.2)).sum()) < top_k < int((sim >= np.float32(81.25)).sum())
    assert tied > 0
    want = jax_cut(JaxConfig(cut_block_rows=256), jnp.asarray(sim), cw, top_k)
    got = candidate_cut(torch.from_numpy(sim), cw, top_k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # canonical order: similarity descending, flat index ascending in ties
    t, gy, gx = (a.numpy().astype(np.int64) for a in got[1:])
    flat = t * 30 * cw + gy * cw + gx
    s = got[0].numpy()
    assert np.all((s[:-1] > s[1:]) | ((s[:-1] == s[1:]) & (flat[:-1] < flat[1:])))


@pytest.fixture(scope="module")
def synthetic_detectors():
    """One 32-template synthetic bank as JAX and port match states at 160x120
    (coarse grid 7 x 10), with the production blocked cut on the JAX side.
    Random frames refine to 28-46% similarity with many ties, so the
    threshold sits at 33 to keep about half of the 64 candidates."""
    from linemod_tpu.models.template_bank import make_synthetic_bank as jax_synthetic
    from linemod_tpu.ops.matching import MatchConfig as JaxConfig
    from linemod_tpu.ops.matching import build_match_state as jax_build
    from linemod_tpu_torch.ops.matching import MatchConfig, match_state_from_numpy

    kw = dict(width=160, height=120, top_k=64, threshold=33.0, template_chunk=32)
    jstate = jax_build(jax_synthetic(32, seed=4, bbox_wh=48), JaxConfig(cut_block_rows=256, **kw))
    state = match_state_from_numpy(*_jax_state_parts(jstate), "cpu")
    assert state.cfg == MatchConfig(**kw)
    return jstate, state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_frame_equals_jax_on_random_frames(synthetic_detectors, seed):
    from linemod_tpu.ops.detect_core import detect_frame as jax_detect_frame
    from linemod_tpu_torch.ops.detect_core import detect_frame

    jstate, state = synthetic_detectors
    color = np.random.default_rng(seed).integers(0, 256, (120, 160, 3)).astype(np.uint8)
    want = np.asarray(jax_detect_frame(jstate, jnp.asarray(color)))
    got = detect_frame(state, torch.from_numpy(color)).numpy()
    assert got.shape == want.shape == (64, 5)
    assert 0 < want[:, 4].sum() < 64  # valid and invalid slots both occur
    np.testing.assert_array_equal(got[:, [0, 1, 2, 4]], want[:, [0, 1, 2, 4]])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-4)


def test_match_program_rejects_wrong_frame_size(synthetic_detectors):
    from linemod_tpu_torch.ops.detect_core import detect_frame

    _, state = synthetic_detectors
    with pytest.raises(ValueError):
        detect_frame(state, torch.zeros((240, 320, 3), dtype=torch.uint8))


def test_dual_modality_is_refused():
    """A dual-modality config on a color-only bank (no normal features) is
    refused; the dual path itself is tests/test_torch_dual.py's."""
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state

    with pytest.raises(ValueError):
        build_match_state(make_synthetic_bank(4), MatchConfig(dual_modality=True), "cpu")
