"""The port's similarity scans against the JAX reference's Pallas kernels (in
interpret mode on the CPU, as tests/test_pallas.py runs them) and its XLA
gather path. Scores are int32 sums and must be equal.

On the CPU the wrappers run the plain PyTorch versions. The CUDA kernels are
compared with those plain versions on the card by the `cuda`-marked test
below (`python -m pytest tests/test_torch_similarity.py -m cuda` on a GPU
machine) and by chip_smoke.py; here that test skips."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _jax_state_and_planes(n, seed, level):
    """A synthetic bank's JAX match state and one random 640x480 frame's
    planes at `level`."""
    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.matching import MatchConfig, _planes_3d, build_match_state

    bank = make_synthetic_bank(n, seed=seed, bbox_wh=48)
    cfg = MatchConfig(width=640, height=480, template_chunk=n)
    state = build_match_state(bank, cfg)
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    if level == "coarse":
        color = color[::2, ::2]
        t, max_cells = cfg.t_coarse, state.max_cells_coarse
    else:
        t, max_cells = cfg.t_fine, state.max_cells_fine
    planes = _planes_3d(jnp.asarray(color), jnp.zeros(color.shape[:2]), t, max_cells, False)
    return bank, state, planes


def test_feature_plane_triplets_equal_jax():
    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.similarity_pallas import feature_plane_triplets as jax_trip
    from linemod_tpu_torch.ops.similarity_cuda import feature_plane_triplets

    bank = make_synthetic_bank(16, seed=2, bbox_wh=48)
    bank.valid0[:, 40:] = False
    for feats, valid, t in ((bank.feat0, bank.valid0, 2), (bank.feat1, bank.valid1, 8)):
        np.testing.assert_array_equal(
            feature_plane_triplets(feats, valid, t, 8 * t * t),
            jax_trip(feats, valid, t, 8 * t * t),
        )


def test_coarse_scores_plain_equals_pallas_and_gather():
    from linemod_tpu.ops.similarity_pallas import coarse_scores_pallas
    from linemod_tpu_torch.ops.similarity_cuda import coarse_scores, coarse_scores_plain

    _, state, planes = _jax_state_and_planes(32, seed=3, level="coarse")
    ch, cw, _, stride = state.coarse_shape
    pallas = np.asarray(
        coarse_scores_pallas(planes, state.off3_coarse, state.max_cells_coarse, interpret=True)
    )[:, :ch, :cw]
    flat = np.asarray(planes).reshape(-1)
    grid = (np.arange(ch)[:, None] * stride + np.arange(cw)[None, :]).reshape(-1)
    gather = flat[np.asarray(state.off_coarse)[:, :, None] + grid].astype(np.int64).sum(1)

    tplanes = torch.from_numpy(np.array(planes))
    toff3 = torch.from_numpy(np.array(state.off3_coarse))
    got = coarse_scores_plain(tplanes, toff3, ch, cw)
    assert got.dtype == torch.int32 and got.shape == (32, ch, cw)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy().reshape(32, -1), gather)
    # on CPU tensors the wrapper is the plain version and launches nothing
    launches = coarse_scores.launches
    np.testing.assert_array_equal(coarse_scores(tplanes, toff3, ch, cw).numpy(), pallas)
    assert coarse_scores.launches == launches


def test_fine_scores_plain_equals_pallas():
    from linemod_tpu.ops.similarity_pallas import fine_scores_pallas
    from linemod_tpu_torch.ops.similarity_cuda import fine_scores, fine_scores_plain

    _, state, planes = _jax_state_and_planes(16, seed=5, level="fine")
    rng = np.random.default_rng(5)
    k, win = 24, 8
    cand_t = rng.integers(0, 16, k).astype(np.int32)
    lim = np.asarray(state.lim_coarse)
    gy = rng.integers(0, 10_000, k) % lim[cand_t, 0]
    gx = rng.integers(0, 10_000, k) % lim[cand_t, 1]
    base_yx = np.stack([gy * win, gx * win], axis=1).astype(np.int32)
    pallas = np.asarray(
        fine_scores_pallas(
            planes, state.off3_fine, jnp.asarray(cand_t), jnp.asarray(base_yx), interpret=True
        )
    )[:, :win, :win]

    args = (
        torch.from_numpy(np.array(planes)),
        torch.from_numpy(np.array(state.off3_fine)),
        torch.from_numpy(cand_t),
        torch.from_numpy(base_yx),
        win,
    )
    got = fine_scores_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (k, win, win)
    np.testing.assert_array_equal(got.numpy(), pallas)
    launches = fine_scores.launches
    np.testing.assert_array_equal(fine_scores(*args).numpy(), pallas)
    assert fine_scores.launches == launches


def test_plain_versions_chunk_the_gather(monkeypatch):
    """Chunking the gather (cap on the index tensor) does not change sums."""
    from linemod_tpu_torch.ops import similarity_cuda as sc

    _, state, planes = _jax_state_and_planes(8, seed=4, level="coarse")
    ch, cw = state.coarse_shape[:2]
    args = (torch.from_numpy(np.array(planes)), torch.from_numpy(np.array(state.off3_coarse)))
    whole = sc.coarse_scores_plain(*args, ch, cw)
    monkeypatch.setattr(sc, "_INDEX_BYTES", 64 * ch * cw * 8 * 3)  # 3 templates a chunk
    np.testing.assert_array_equal(sc.coarse_scores_plain(*args, ch, cw).numpy(), whole.numpy())


def test_wrappers_reject_bad_inputs():
    from linemod_tpu_torch.ops.similarity_cuda import coarse_scores, fine_scores

    planes = torch.zeros((3, 40, 128), dtype=torch.uint8)
    off3 = torch.zeros((4, 8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        coarse_scores(planes.float(), off3, 4, 4)
    with pytest.raises(ValueError):
        coarse_scores(planes, off3.long(), 4, 4)
    with pytest.raises(ValueError):
        coarse_scores(planes, off3[:, :, :2].contiguous(), 4, 4)
    with pytest.raises(ValueError):
        coarse_scores(planes, off3, 41, 4)
    cand = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        fine_scores(planes, off3, cand, torch.zeros((4, 2), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        fine_scores(planes, off3, cand.long(), torch.zeros((5, 2), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        fine_scores(planes, off3, cand, torch.zeros((5, 2), dtype=torch.int32), 33)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain():
    """Both CUDA kernels against their plain versions on the card, at the
    fixture's plane shapes (color-only fine window 8) and dual-modality
    parameters (F=128, window 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linemod_tpu_torch.ops import similarity_cuda as sc

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for (p, rows, stride, ch, cw, n, f, win, max_cells) in (
        (513, 48, 128, 30, 40, 2048, 64, 8, 9),
        (33, 304, 384, 240, 320, 64, 128, 4, 58),
    ):
        planes = torch.from_numpy(rng.integers(0, 5, (p, rows, stride), dtype=np.uint8)).to(dev)
        planes[-1] = 0
        off3 = np.stack(
            [rng.integers(0, p, (n, f)), rng.integers(0, max_cells, (n, f)),
             rng.integers(0, max_cells, (n, f))], axis=-1,
        ).astype(np.int32)
        off3 = torch.from_numpy(off3).to(dev)
        launches = sc.coarse_scores.launches
        got = sc.coarse_scores(planes, off3, ch, cw)
        assert sc.coarse_scores.launches == launches + 1
        torch.testing.assert_close(got, sc.coarse_scores_plain(planes, off3, ch, cw), rtol=0, atol=0)

        k = 512
        cand_t = torch.from_numpy(rng.integers(0, n, k).astype(np.int32)).to(dev)
        base = np.stack(
            [rng.integers(0, ch - win + 1, k), rng.integers(0, cw - win + 1, k)], axis=1
        ).astype(np.int32)
        base_yx = torch.from_numpy(base).to(dev)
        got = sc.fine_scores(planes, off3, cand_t, base_yx, win)
        torch.cuda.synchronize()
        want = sc.fine_scores_plain(planes, off3, cand_t, base_yx, win)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_fine_scores_equal_plain_at_its_shapes():
    """The fine kernel against fine_scores_plain on the card at its four
    shapes (the fixture's candidates, 1280x960, the dual shape, K=2,048)
    and its edge cases (tools/fine_time), and its rejections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.tools.coarse_max_split import synthetic_1280
    from linemod_tpu_torch.tools.fine_time import fine_cases, fine_edge_cases, fixture_fine

    dev = torch.device("cuda")
    cases = fine_cases(dev, *fixture_fine(dev), *synthetic_1280(dev))
    for label, args in {**cases, **fine_edge_cases(dev)}.items():
        launches = sc.fine_scores.launches
        got = sc.fine_scores(*args)
        assert sc.fine_scores.launches == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(got, sc.fine_scores_plain(*args)), label
    planes, off3, cand_t, base_yx, win = next(iter(cases.values()))
    with pytest.raises(ValueError, match="32-bit words"):
        sc.fine_scores(planes[:, :, :126].contiguous(), off3, cand_t, base_yx, win)
    with pytest.raises(ValueError, match="8192 features"):
        sc.fine_scores(planes, off3[:, :1].repeat(1, 8193, 1), cand_t, base_yx, win)


def test_jax_state_dataclass_fields_are_ported():
    """The port's MatchState carries every array field of the JAX one."""
    from linemod_tpu.ops.matching import MatchState as JaxMatchState
    from linemod_tpu_torch.ops.matching import META_FIELDS, TENSOR_FIELDS

    names = {f.name for f in dataclasses.fields(JaxMatchState)}
    assert names == set(TENSOR_FIELDS) | set(META_FIELDS)
