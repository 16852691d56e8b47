"""The coarse scan's use of the coarse kernel's plan, on the CPU.

The CUDA kernel (csrc/similarity.cu, `coarse_kernel<true>`) runs only on
the card. What it does with the plan is followed here step by step in numpy
(`planned_scores`): the band-major groups of SCAN_UNITS_PER_BLOCK templates of
one band, each band staging its own rectangles, the group's
chunks split over `split` blocks (block r takes chunks r, r + split, ...),
each block's byte-lane adds flushed into u16 partial sums, then the flat
partition of the partial sums' 16-byte items (8 cells, 4 u32 words of two
u16 cells) over the blocks, each item summed across the blocks' buffers in
rank order word by word as u32, unpacked and written cropped to the grid,
every cell exactly once. On the cases of
tests/test_torch_coarse_max_plan.py this must equal `coarse_scores_plain`
for every split, and JAX's `coarse_scores_pallas` (interpret mode) on one
case. The plan cut by rows (the cuts' template subsets) must equal the plan
of the subset's own triplets, and the cuts must build no plan per frame.
"""

import numpy as np
import pytest
import torch
from test_torch_coarse_max_plan import CASES, _case, band_stage, planned_max

from linemod_tpu_torch.ops import similarity_cuda as sc

torch.set_num_threads(2)

SPLITS = [1, 2, 3, 8]


def planned_scores(planes, plan, ch, cw, split):
    """coarse_scores by the plan's steps, in numpy, with the kernel's
    indexing and arithmetic: band-major groups of SCAN_UNITS_PER_BLOCK templates
    of one band, each band staging its own rectangles (band_stage), uint8
    byte lanes a batch of 32 features, uint16 partial sums a block, u32 sums
    of the packed partials across blocks."""
    pl = planes.numpy()
    feat, starts = plan.feat.numpy(), plan.starts.numpy()
    width, chunks = 4 * plan.pitch, plan.chunks
    ur, uc, upb = sc._UNIT_ROWS, sc._UNIT_COLS, sc.SCAN_UNITS_PER_BLOCK
    n = feat.shape[0]
    per_band = -(-n // upb)
    assert plan.row_bands * ur >= ch and plan.col_bands * uc >= cw and plan.pitch % 2
    assert plan.groups(upb) == plan.row_bands * plan.col_bands * per_band

    def unit(g, j):
        """(template or -1, row0, col0) of unit j of group g."""
        band, q = divmod(g, per_band)
        t = q * upb + j
        return np.where(t < n, t, -1), ur * (band // plan.col_bands), uc * (band % plan.col_bands)

    lane, x = np.arange(ur), np.arange(uc)
    items = upb * ur * uc // 8
    i_j, i_rem = np.divmod(np.arange(items), ur * uc // 8)
    i_row, i_k = np.divmod(i_rem, uc // 8)
    out = np.zeros((n, ch, cw), np.int64)
    written = np.zeros((n, ch, cw), np.int64)
    for g in range(plan.groups(upb)):
        _, row0, col0 = unit(g, 0)
        stages = [band_stage(pl, plan, c, row0, col0) for c in range(chunks)]
        part = np.zeros((split, upb, ur, uc), np.uint16)
        for r in range(split):
            for j in range(upb):
                t = int(unit(g, j)[0])
                if t < 0:
                    continue
                for c in range(r, chunks, split):
                    flat, at = stages[c]
                    # lanes below the grid read row 0; their sums are never written
                    base = np.where(row0 + lane < ch, lane, 0)[:, None] * width + at + x
                    offs = feat[t, starts[t, c] : starts[t, c + 1]]
                    if offs.size:  # an item's 3 aligned words stay inside the stage
                        assert (offs & ~3).max() + base.max() + 5 <= flat.size
                    for b in range(0, offs.size, 32):
                        lanes8 = flat[offs[b : b + 32, None, None] + base].sum(0) % 256
                        part[r, j] += lanes8.astype(np.uint16)
        packed = part[..., 0::2].astype(np.uint32) | part[..., 1::2].astype(np.uint32) << 16
        packed = packed.reshape(split, upb, ur, uc // 8, 4)
        for r in range(split):
            sl = slice(r * items // split, (r + 1) * items // split)
            j, row, k = i_j[sl], i_row[sl], i_k[sl]
            t, row0, col0 = unit(g, j)
            gy, gx = row0 + row, col0 + 8 * k
            keep = (t >= 0) & (gy < ch) & (gx < cw)
            total = np.zeros((j.size, 4), np.uint32)
            for rr in range(split):
                total += packed[rr, j, row, k]
            t, gy, gx, total = t[keep], gy[keep], gx[keep], total[keep]
            for m in range(8):
                cell = total[:, m // 2] >> 16 * (m % 2) & 0xFFFF
                ok = gx + m < cw
                out[t[ok], gy[ok], gx[ok] + m] = cell[ok]
                np.add.at(written, (t[ok], gy[ok], gx[ok] + m), 1)
    assert (written == 1).all()
    return out


def _score_case(name, monkeypatch):
    if name == "overflow_f128":  # every cell sums 4 * 128 = 512
        planes, off3, lim, ch, cw = _case("overflow", monkeypatch)
        return planes, torch.cat([off3, off3], 1).contiguous(), lim, ch, cw
    return _case(name, monkeypatch)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", CASES + ["overflow_f128"])
def test_planned_scores_equal_plain(name, split, monkeypatch):
    planes, off3, _, ch, cw = _score_case(name, monkeypatch)
    plan = sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    want = sc.coarse_scores_plain(planes, off3, ch, cw).numpy()
    np.testing.assert_array_equal(planned_scores(planes, plan, ch, cw, split), want)
    if name.startswith("overflow"):
        assert (want == 4 * off3.shape[1]).all()
    if name == "multi_chunk":
        assert plan.chunks > split
    if name == "wide":  # 24 templates in 2 x 3 bands: 6 groups of 24
        assert plan.groups(sc.SCAN_UNITS_PER_BLOCK) == 6


def test_planned_scores_equal_pallas(rng):
    """The plan of a JAX-built state's triplets, followed in numpy with the
    group split over 3 blocks, equals coarse_scores_pallas in interpret mode
    (the shapes of test_planned_max_equals_pallas)."""
    import jax.numpy as jnp

    from linemod_tpu.models.template_bank import make_synthetic_bank
    from linemod_tpu.ops.matching import MatchConfig, _planes_3d, build_match_state
    from linemod_tpu.ops.similarity_pallas import coarse_scores_pallas

    n = 32
    state = build_match_state(
        make_synthetic_bank(n, seed=6, bbox_wh=48), MatchConfig(width=640, height=480, template_chunk=n)
    )
    color = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    planes = _planes_3d(
        jnp.asarray(color[::2, ::2]), jnp.zeros((240, 320)), 8, state.max_cells_coarse, False
    )
    ch, cw = state.coarse_shape[:2]
    want = np.asarray(
        coarse_scores_pallas(planes, state.off3_coarse, state.max_cells_coarse, interpret=True)
    )[:, :ch, :cw]
    tp = torch.from_numpy(np.array(planes))
    plan = sc.coarse_max_plan(torch.from_numpy(np.array(state.off3_coarse)), tuple(tp.shape), ch, cw)
    assert plan.chunks >= 3
    np.testing.assert_array_equal(planned_scores(tp, plan, ch, cw, 3), want)


def _decoded(plan):
    """Each template's planned features as (plane, sy, sx) in plan order,
    (-1, -1, -1) past its last bucket: the plan read back through its own
    geometry."""
    feat, starts = plan.feat.numpy().astype(np.int64), plan.starts.numpy()
    rect, row = plan.stage_rows * 4 * plan.pitch, 4 * plan.pitch
    pos = np.arange(feat.shape[1])
    chunk = np.stack([np.searchsorted(s, pos, side="right") - 1 for s in starts])
    trip = np.stack([chunk * plan.chunk_planes + feat // rect, feat % rect // row, feat % row], -1)
    return np.where((pos < starts[:, -1:])[..., None], trip, -1)


def _small_state(**over):
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops.matching import MatchConfig, build_match_state

    kw = dict(width=320, height=240, top_k=8, template_chunk=8, **over)
    bank = make_synthetic_bank(48, seed=9, bbox_wh=48, image_wh=(320, 240))
    return build_match_state(bank, MatchConfig(**kw), "cpu")


def _small_frame(state, seed=3):
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.matching import _planes_3d

    color = torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, (240, 320, 3)).astype(np.float32))
    return color, _planes_3d(downsample2(color), 8, state.max_cells_coarse)


@pytest.mark.parametrize("rows", ["ascending", "slice"])
def test_plan_cut_by_rows_equals_the_subsets_own(rows):
    """A plan cut by rows keeps the bank's geometry and holds, feature for
    feature, what coarse_max_plan of the subset's triplets holds; both
    kernels' followers take it to the plain results."""
    from linemod_tpu_torch.ops.matching import _coarse_rows

    state = _small_state()
    sel = (torch.from_numpy(np.sort(np.random.default_rng(2).permutation(48)[:20]))
           if rows == "ascending" else slice(8, 32))
    sub = _coarse_rows(state, sel)
    cut = sub.coarse_plan
    assert cut.off3 is sub.off3_coarse and cut.version == sub.off3_coarse._version
    assert cut.geometry == state.coarse_plan.geometry
    ch, cw = state.coarse_shape[:2]
    own = sc.coarse_max_plan(sub.off3_coarse, cut.planes_shape, ch, cw)
    np.testing.assert_array_equal(_decoded(cut), _decoded(own))
    if own.geometry == cut.geometry:
        np.testing.assert_array_equal(cut.feat.numpy(), own.feat.numpy())
        np.testing.assert_array_equal(cut.starts.numpy(), own.starts.numpy())
    _, planes = _small_frame(state)
    np.testing.assert_array_equal(
        planned_scores(planes, cut, ch, cw, 2),
        sc.coarse_scores(planes, sub.off3_coarse, ch, cw, plan=cut).numpy(),
    )
    np.testing.assert_array_equal(
        planned_max(planes, cut, sub.lim_coarse, ch, cw),
        sc.coarse_max(planes, sub.off3_coarse, sub.lim_coarse, ch, cw, plan=cut).numpy(),
    )
    with pytest.raises(ValueError, match="plan's rows"):
        state.coarse_plan.take_rows(slice(0, 4), sub.off3_coarse)


@pytest.mark.parametrize("cut", ["prefiltered", "streaming"])
def test_cuts_build_no_plan_per_frame(cut, monkeypatch):
    """With coarse_max_plan made to raise, a prefiltered and a streaming
    match run, each scan gets a plan for exactly its triplets, and the
    packed result equals the dense cut's."""
    from linemod_tpu_torch.ops import matching

    over = dict(prefilter_sel=16) if cut == "prefiltered" else dict(scan_chunk=16)
    state = _small_state(**over)
    dense = _small_state()
    color, _ = _small_frame(state, seed=4)
    want = matching.match_templates(dense, color)

    def refuse(*args, **kwargs):
        raise AssertionError("a plan was built per frame")

    scans = []

    def scan(planes, off3, ch, cw, plan=None):
        assert plan is not None and plan.off3 is off3
        scans.append(off3.shape[0])
        return sc.coarse_scores(planes, off3, ch, cw, plan=plan)

    monkeypatch.setattr(sc, "coarse_max_plan", refuse)
    monkeypatch.setattr(matching, "coarse_max_plan", refuse)
    monkeypatch.setattr(matching, "coarse_scores", scan)
    got = matching.match_templates(state, color)
    assert scans == ([16] if cut == "prefiltered" else [16, 16, 16])
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


def test_coarse_scores_checks_its_plan(monkeypatch):
    planes, off3, _, ch, cw = _case("random", monkeypatch)
    plan = sc.coarse_max_plan(off3, tuple(planes.shape), ch, cw)
    np.testing.assert_array_equal(
        sc.coarse_scores(planes, off3, ch, cw, plan=plan).numpy(),
        sc.coarse_scores_plain(planes, off3, ch, cw).numpy(),
    )
    with pytest.raises(ValueError, match="other triplets"):
        sc.coarse_scores(planes, off3.clone(), ch, cw, plan=plan)
    with pytest.raises(ValueError, match="grid"):
        sc.coarse_scores(planes, off3, ch, cw - 1, plan=plan)
    off3[0, 0, 1] = 1
    with pytest.raises(ValueError, match="other triplets"):  # changed in place
        sc.coarse_scores(planes, off3, ch, cw, plan=plan)


@pytest.mark.parametrize(
    "n, active, want",
    [
        # the fixture's 64 groups of 6 chunks: the card runs 66 clusters of
        # 2, so 2 a group take one round of 3 chunks; 39 clusters of 3 would
        # take two rounds of 2
        (2048, {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17}, 2),
        # a streaming chunk's 128 groups: one block a group (one round of 6
        # chunks) ties with 2 a group (two rounds of 3); fewer rounds win
        (4096, {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17}, 1),
        # the rescan's 32 groups: 3 a group take one round of 2 chunks
        (1024, {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17}, 3),
        # with 33 clusters of 4 at once, 4 a group tie with 3 in one round
        # of 2 chunks; the larger S combines fewer cells a block
        (1024, {1: 132, 2: 66, 3: 44, 4: 33, 5: 26, 6: 22}, 4),
        # no cluster fits: one block a group
        (2048, {1: 132, 2: 0, 3: 0, 4: 0, 5: 0, 6: 0}, 1),
    ],
)
def test_coarse_split_fills_the_card(n, active, want, monkeypatch):
    plan = _small_state().coarse_plan
    plan = sc.CoarseMaxPlan(**{**plan.__dict__, "chunks": 6, "feat": torch.zeros((n, 1), dtype=torch.int32)})
    assert plan.groups(sc.SCAN_UNITS_PER_BLOCK) == n // 32
    monkeypatch.setattr(sc, "active_clusters", lambda device, split, smem: active[split])
    monkeypatch.setattr(sc, "_splits", {})
    assert sc.coarse_split(plan, torch.device("cpu")) == want
