"""The masked-max kernel's plan (`similarity_cuda.coarse_max_plan`) on the CPU.

The CUDA kernel (csrc/similarity.cu, `coarse_kernel<false>`) runs only on the
card. What it does with the plan is followed here step by step in numpy
(`planned_max`): for each band of 32 rows x 40 columns, stage each chunk's
planes as the band's rectangles of stage_rows x 4 * pitch bytes (zero past
the planes), add each template's bucket of features for that chunk over the
8-cell items of its band's rows, mask the cells outside the fit box, take
the max. On random seeded banks at small
shapes this must equal `coarse_max_plain` exactly, and JAX's
`coarse_max_pallas` (interpret mode) on one case.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_tpu_torch.ops import similarity_cuda as sc

torch.set_num_threads(2)


def band_stage(pl, plan, c, row0, col0):
    """Chunk c's stage for the band whose corner is (row0, col0), flat: of
    each plane, rows row0 .. row0 + stage_rows and 4 * pitch bytes from col0
    rounded down to 16, zero past the planes; and where the band's first
    column lies in it."""
    width, per_chunk = 4 * plan.pitch, plan.chunk_planes
    col_start = col0 & ~15
    stage = np.zeros((per_chunk, plan.stage_rows, width), np.uint8)
    block = pl[c * per_chunk : min((c + 1) * per_chunk, pl.shape[0] - 1),
               row0 : row0 + plan.stage_rows, col_start : col_start + width]
    stage[: block.shape[0], : block.shape[1], : block.shape[2]] = block
    return stage.reshape(-1), col0 - col_start


def planned_max(planes, plan, lim, ch, cw):
    """coarse_max by the plan's steps, in numpy, with the kernel's indexing:
    each band of 32 rows x 40 columns stages its own rectangles
    (band_stage); the 8-cell items of its lane rows at column x0 read the
    staged bytes feat + lane * 4 * pitch + x0 .. + 7 of their chunk, as
    three aligned words from (feat & ~3) + lane * 4 * pitch + x0, which
    must lie inside the chunk's stage."""
    pl = planes.numpy()
    feat, starts = plan.feat.numpy(), plan.starts.numpy()
    width, ur, uc = 4 * plan.pitch, sc._UNIT_ROWS, sc._UNIT_COLS
    n = feat.shape[0]
    assert plan.row_bands * ur >= ch and plan.col_bands * uc >= cw and plan.pitch % 2
    acc = np.zeros((n, plan.row_bands * ur, plan.col_bands * uc), np.int64)
    lane, x = np.arange(ur), np.arange(uc)
    for rb in range(plan.row_bands):
        for cb in range(plan.col_bands):
            row0, col0 = rb * ur, cb * uc
            for c in range(plan.chunks):
                flat, at = band_stage(pl, plan, c, row0, col0)
                # lanes below the grid read row 0; their sums are never kept
                cell = (np.where(row0 + lane < ch, lane, 0)[:, None] * width + at + x).reshape(-1)
                for t in range(n):
                    offs = feat[t, starts[t, c] : starts[t, c + 1]]
                    sums = flat[offs[:, None] + cell[None, :]].sum(0, dtype=np.int64)
                    acc[t, row0 : row0 + ur, col0 : col0 + uc] += sums.reshape(ur, uc)
                    if offs.size:
                        assert (offs & ~3).max() + cell.max() + 5 <= flat.size
    acc = acc[:, :ch, :cw]
    lim = lim.numpy()
    ny = np.clip(lim[:, 0], 0, ch)[:, None, None]
    nx = np.clip(lim[:, 1], 0, cw)[:, None, None]
    fits = (np.arange(ch)[None, :, None] < ny) & (np.arange(cw)[None, None, :] < nx)
    return np.where(fits, acc, -1).reshape(n, -1).max(1)


def _planes(rng, p, rows, stride, ch, cw, fill=None):
    planes = np.zeros((p + 1, rows, stride), np.uint8)
    planes[:p] = rng.integers(0, 5, (p, rows, stride)) if fill is None else 0
    if fill is not None:
        planes[:p, :ch, :cw] = fill
    return torch.from_numpy(planes)


def _bank(rng, n, f, p, max_sy, max_sx, ch, cw):
    off3 = np.stack([rng.integers(0, p + 1, (n, f)), rng.integers(0, max_sy + 1, (n, f)),
                     rng.integers(0, max_sx + 1, (n, f))], -1)
    lim = np.stack([rng.integers(-2, ch + 3, n), rng.integers(-2, cw + 3, n)], 1)
    lim[:4] = [[0, 0], [ch, 0], [-1, cw], [99, 99]]
    return off3, lim


def _case(name, monkeypatch):
    rng = np.random.default_rng(CASES.index(name))
    p, rows, stride, ch, cw, n, f = 64, 24, 128, 14, 27, 24, 64
    fill = None
    if name == "multi_chunk":  # many chunks, a stride below the staged width
        monkeypatch.setattr(sc, "STAGE_BYTES", 4 * 1024)
        rows, stride, ch, cw = 20, 24, 12, 17
    if name == "fixture_geometry":  # the 640x480 coarse planes: 512 planes, 30 x 40 cells
        p, rows, stride, ch, cw, n = 512, 48, 128, 30, 40, 12
    if name == "f128":
        f = 128
    if name == "overflow":  # every fitting cell sums 4 * F: 256 needs the u16 flush
        fill = 4
    if name == "wide":  # two bands of rows and three of columns per template
        ch, cw, rows, stride = 40, 102, 48, 256
    off3, lim = _bank(rng, n, f, p, rows - ch, stride - cw, ch, cw)
    if name == "one_plane":
        off3[:, :, 0] = rng.integers(0, p, (n, 1))
    if name == "zero_plane":
        off3[:, ::2, 0] = p
        off3[5, :, 0] = p
    if name == "overflow":
        off3[:, :, 0] = rng.integers(0, p, (n, f))
        off3[:, :, 1:] = 0
    if name == "narrow":
        lim[4:, 1] = 1 + np.arange(n - 4) % 7
        off3[:, :, 2] = rng.integers(0, 4, (n, f)) + 4 * rng.integers(0, 2, (n, 1))
    planes = _planes(rng, p, rows, stride, ch, cw, fill)
    return planes, torch.from_numpy(off3.astype(np.int32)), torch.from_numpy(lim.astype(np.int32)), ch, cw


CASES = ["random", "one_plane", "f128", "zero_plane", "multi_chunk", "fixture_geometry",
         "overflow", "narrow", "wide"]


@pytest.mark.parametrize("name", CASES)
def test_planned_max_equals_plain(name, monkeypatch):
    planes, off3, lim, ch, cw = _case(name, monkeypatch)
    plan = sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    want = sc.coarse_max_plain(planes, off3, lim, ch, cw).numpy()
    np.testing.assert_array_equal(planned_max(planes, plan, lim, ch, cw), want)
    assert (want[:3] == -1).all()
    if name == "overflow":
        assert want.max() == 4 * off3.shape[1]
    if name == "multi_chunk":
        assert plan.chunks > 4 and 4 * plan.pitch > planes.shape[2]
    if name == "wide":
        assert (plan.row_bands, plan.col_bands) == (2, 3)
    # the buckets: ascending, holding exactly the features off the zero plane
    starts = plan.starts.numpy()
    assert (np.diff(starts, axis=1) >= 0).all() and (starts[:, 0] == 0).all()
    np.testing.assert_array_equal(starts[:, -1], (off3[..., 0] < planes.shape[0] - 1).sum(1).numpy())


def test_planned_max_equals_pallas(rng):
    """The plan of a JAX-built state's triplets, followed in numpy, equals
    coarse_max_pallas in interpret mode (the shapes of
    tests/test_torch_bigbank.py's masked-max test)."""
    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.matching import MatchConfig, _planes_3d, build_match_state
    from linemod_tpu.ops.similarity_pallas import coarse_max_pallas

    n = 32
    state = build_match_state(
        make_synthetic_bank(n, seed=6, bbox_wh=48), MatchConfig(width=640, height=480, template_chunk=n)
    )
    color = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    planes = _planes_3d(
        jnp.asarray(color[::2, ::2]), jnp.zeros((240, 320)), 8, state.max_cells_coarse, False
    )
    ch, cw = state.coarse_shape[:2]
    lim = np.array(state.lim_coarse)
    lim[3] = (0, 4)
    want = np.asarray(
        coarse_max_pallas(planes, state.off3_coarse, jnp.asarray(lim), state.max_cells_coarse, interpret=True)
    )
    tp = torch.from_numpy(np.array(planes))
    off3 = torch.from_numpy(np.array(state.off3_coarse))
    plan = sc.coarse_max_plan(off3, tuple(tp.shape), ch, cw)
    np.testing.assert_array_equal(planned_max(tp, plan, torch.from_numpy(lim), ch, cw), want)
    assert want[3] == -1 and plan.chunks > 1


def test_state_carries_the_plan_and_subsets_drop_it():
    """Every state builds the plan once, whatever cut is configured; the
    cuts' row subsets cut it with their triplets (same geometry), and the
    cut plan of the rescan's ascending selection follows coarse_max_plain."""
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops.matching import MatchConfig, _coarse_rows, _planes_3d, build_match_state
    from linemod_tpu_torch.ops.extract import downsample2

    kw = dict(width=320, height=240, top_k=8, template_chunk=8)
    bank = make_synthetic_bank(48, seed=9, bbox_wh=48, image_wh=(320, 240))
    dense = build_match_state(bank, MatchConfig(**kw), "cpu")
    assert dense.coarse_plan.off3 is dense.off3_coarse
    state = build_match_state(bank, MatchConfig(prefilter_sel=16, **kw), "cpu")
    plan = state.coarse_plan
    assert plan.off3 is state.off3_coarse and plan.geometry == dense.coarse_plan.geometry
    assert dataclasses.replace(state, cfg=state.cfg).coarse_plan is plan
    sel = torch.from_numpy(np.sort(np.random.default_rng(2).permutation(48)[:20]))
    sub = _coarse_rows(state, sel)
    assert sub.coarse_plan.off3 is sub.off3_coarse and sub.coarse_plan.geometry == plan.geometry
    color = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (240, 320, 3)).astype(np.float32))
    planes = _planes_3d(downsample2(color), 8, state.max_cells_coarse)
    ch, cw = state.coarse_shape[:2]
    for st in (state, sub):
        p = st.coarse_plan
        want = sc.coarse_max(planes, st.off3_coarse, st.lim_coarse, ch, cw, plan=p).numpy()
        np.testing.assert_array_equal(planned_max(planes, p, st.lim_coarse, ch, cw), want)


def test_plan_rejects_what_the_kernel_cannot_take(monkeypatch):
    planes, off3, lim, ch, cw = _case("random", monkeypatch)
    plan = sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    with pytest.raises(ValueError, match="other triplets"):
        sc.coarse_max(planes, off3.clone(), lim, ch, cw, plan=plan)
    with pytest.raises(ValueError, match="grid"):
        sc.coarse_max(planes, off3, lim, ch - 1, cw, plan=plan)
    off3[0, 0, 2] = planes.shape[2] - cw + 1
    with pytest.raises(ValueError, match="outside"):
        sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    with pytest.raises(ValueError, match="other triplets"):  # changed in place
        sc.coarse_max(planes, off3, lim, ch, cw, plan=plan)
    off3[0, 0, 2] = 0
    monkeypatch.setattr(sc, "STAGE_BYTES", 256)
    with pytest.raises(ValueError, match="256 B of shared memory"):
        sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    with pytest.raises(ValueError, match="empty"):
        sc.coarse_max_plan(off3, tuple(planes.shape), 0, cw)


def test_split_tool_cuts_lines_the_kernel_has():
    """The split tool builds the kernels with their adds, their stage, the
    scan's combine or its 16-byte stores cut out by replacing one source
    line each; the lines must still be there, once."""
    import os

    from linemod_tpu_torch.ops import cuda_lib
    from linemod_tpu_torch.tools.coarse_max_split import CUTS, SCAN_CUTS

    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()
    for name, (line, _) in {**CUTS, **SCAN_CUTS}.items():
        assert src.count(line) == 1, name
