"""The fine refine kernel's decomposition (csrc/similarity.cu, `fine_kernel<L, S>`)
on the CPU.

The CUDA kernel runs only on the card. What it does is followed here step by
step in numpy (`warp_fine`), with the constants of `similarity_cuda`: a warp
a group of a window's rows, lanes as (slice, row, word) by `fine_layout`,
the template's features taken FINE_BATCH at a time with one triplet a
lane and handed to the slices by shuffles, each lane
loading one aligned 32-bit word of its row (the extra word clamped to the
planes' last, and idle lanes onto live lanes' words, so that a batch reads
exactly the 32-byte sectors its live rows need), joining it to the next
lane's by a funnel shift, adding
byte lanes flushed into u16 pairs every FINE_FLUSH features a lane, the
slices summed by xor shuffles, and lane (0, row, word) storing its 4 cells.
The arithmetic wraps as u32 does on the card, so a flush too late or a
wrong shift shows as a wrong sum. On seeded numpy inputs this must equal
`fine_scores_plain` exactly, and JAX's `fine_scores_pallas` (interpret
mode) cropped to the window, or the gather of
`linemod_tpu/ops/matching.py:634-644` where the window is wider than the
Pallas tile's 8.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_tpu_torch.ops import similarity_cuda as sc

torch.set_num_threads(2)


def _funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low word of (hi:lo) >> sh."""
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo) >> sh.astype(np.uint64)).astype(np.uint32)


def warp_fine(planes, off3, cand_t, base_yx, win):
    """fine_scores by the kernel's steps, in numpy: every warp (candidate)
    at once, lanes along the second axis."""
    pl = np.ascontiguousarray(planes.numpy())
    n_planes, rows, stride = pl.shape
    assert stride % 4 == 0
    words = pl.reshape(-1).view("<u4")
    last_word = words.size - 1
    lanes_row, slices = sc.fine_layout(win)
    row_words = -(-win // 4)
    slice_rows = 32 // (lanes_row * slices)
    per = sc.FINE_BATCH // slices  # a slice's features of a batch
    flush_batches = sc.FINE_FLUSH // per
    assert row_words + 1 <= lanes_row and sc.FINE_BATCH == 32 and flush_batches >= 1
    k, f = cand_t.shape[0], off3.shape[1]
    # the grid: warp w of block b is warp b * FINE_WARPS + w, group g of
    # candidate c in order c * groups + g
    groups = -(-win // slice_rows)
    blocks = -(-k * groups // sc.FINE_WARPS)
    warps = [b * sc.FINE_WARPS + w for b in range(blocks) for w in range(sc.FINE_WARPS)]
    assert sorted((gw // groups, gw % groups) for gw in warps if gw // groups < k) == [
        (c, g) for c in range(k) for g in range(groups)]

    lane = np.arange(32)
    j, r, s = lane % lanes_row, lane // lanes_row % slice_rows, lane // (lanes_row * slice_rows)
    trips = off3.numpy().astype(np.int64)[cand_t.numpy()]  # [K, F, 3]
    flat = (trips[..., 0] * rows + trips[..., 1]) * stride + trips[..., 2]
    by, bx = base_yx.numpy().astype(np.int64).T
    out = np.full((k, win, win), -1, np.int64)
    for r0 in range(0, win, slice_rows):  # the candidate's warps, a group of rows each
        dy = r0 + r
        adds = (dy < win) & (j < row_words)
        slack = np.where(j >= row_words, 4 * row_words - win, -1)  # the extra word is needed where (at & 3) > slack
        # every lane loads: idle lanes read a live lane's word (last row, extra word)
        base = (by[:, None] + np.minimum(dy, win - 1)[None, :]) * stride + bx[:, None] + 4 * np.minimum(j, row_words)
        acc = np.zeros((2, k, 32), np.uint32)
        a8 = np.zeros((k, 32), np.uint32)
        for batch, b in enumerate(range(0, f, sc.FINE_BATCH), 1):
            g = b + lane
            mine = flat[:, np.minimum(g, f - 1)]  # lane l: feature b + l (past the last, the last)
            nb = min(sc.FINE_BATCH, f - b)
            read, need = set(), set()  # (candidate, 32-byte sector)
            for i in range(per):
                q = s + slices * i
                at = base + mine[:, q]  # __shfl_sync(mine, q)
                wi = np.minimum((at >> 2) - ((at & 3) <= slack), last_word)
                w = words[wi]
                read |= set(zip(np.repeat(np.arange(k), 32), (wi // 8).ravel()))
                row0 = at - 4 * np.minimum(j, row_words)  # the row's first byte
                for x in (row0, row0 + win - 1):  # a row spans at most two sectors
                    keep = np.broadcast_to((dy < win) & (q < nb), x.shape)
                    need |= set(zip(np.nonzero(keep)[0], x[keep] // 32))
                hi = w[:, np.minimum(lane + 1, 31)]  # __shfl_down_sync(w, 1)
                a8 += np.where(adds & (q < nb), _funnel_r(w, hi, (at & 3) * 8), 0).astype(np.uint32)
            assert read == need  # the batch reads exactly the sectors its live rows need
            if batch % flush_batches == 0 or b + sc.FINE_BATCH >= f:  # byte lanes into u16 pairs
                acc[0] += a8 & 0x00FF00FF
                acc[1] += (a8 >> 8) & 0x00FF00FF
                a8[:] = 0
        m = 1
        while m < slices:  # __shfl_xor_sync over the slices
            acc = acc + acc[:, :, lane ^ (m * lanes_row * slice_rows)]
            m <<= 1
        for ln in np.flatnonzero((s == 0) & adds):  # lane (0, r, j) stores cells 4j .. 4j + 3 of row r
            cells = np.stack([acc[0, :, ln] & 0xFFFF, acc[1, :, ln] & 0xFFFF, acc[0, :, ln] >> 16, acc[1, :, ln] >> 16], 1)
            x0 = 4 * j[ln]
            out[:, dy[ln], x0 : x0 + 4] = cells[:, : min(4, win - x0)]
    assert (out >= 0).all()  # every cell stored
    return out.astype(np.int32)


def _case(name):
    """(planes, off3, cand_t, base_yx, win) of one case, seeded by its name."""
    rng = np.random.default_rng(CASES.index(name))
    p, rows, stride, n, f, k, win = 32, 40, 128, 16, 64, 24, 8
    fill = None
    if name.startswith("win"):
        win = int(name[3:])
        rows = max(rows, 2 * win + 16)
    if name == "dual_f128_win4":
        p, rows, f, win = 400, 16, 128, 4
    if name == "f37":
        f = 37
    if name == "k1":
        k = 1
    if name == "full4_f256_win8":  # 128 features a lane: a byte lane would pass 255 unflushed
        f, fill = 256, 4
    if name == "full4_f64_win20":  # one slice, 5 warps a candidate: 64 features a lane
        win, rows, fill = 20, 56, 4
    if name == "full4_f512_win4":  # 8 slices: 64 features a lane
        f, win, fill = 512, 4, 4
    max_s = (rows - win) // 2
    planes = rng.integers(0, 5, (p + 1, rows, stride)).astype(np.uint8)
    planes[-1] = 0
    if fill is not None:
        planes[:-1] = fill
    off3 = np.stack([rng.integers(0, p, (n, f)), rng.integers(0, max_s + 1, (n, f)),
                     rng.integers(0, max_s + 1, (n, f))], -1)
    if name == "dual_f128_win4":  # 64 color features, then 64 normal ones, some invalid
        off3[:, :64, 0] = rng.integers(0, 200, (n, 64))
        off3[:, 64:, 0] = rng.integers(200, 400, (n, 64))
        off3[:, 60:70, 0] = p
    if name == "zero_plane":
        off3[:, ::2, 0] = p
        off3[3, :, 0] = p
    cand_t = rng.integers(0, n, k)
    base = np.stack([rng.integers(0, rows - max_s - win + 1, k), rng.integers(0, stride - max_s - win + 1, k)], 1)
    if name == "last_byte":  # windows ending at the planes' last byte, on every word shift
        planes[-1] = rng.integers(0, 5, (rows, stride))
        off3[0] = (p, rows - win, stride - win)
        cand_t[:4] = 0
        base[:4] = 0
        off3[1] = (p, rows - win - 1, stride - win - 3)
        cand_t[4:8] = 1
        base[4:8] = [[1, 0], [0, 1], [1, 2], [1, 3]]
        cand_t[8:] = rng.integers(2, n, k - 8)
    if fill is not None:
        base[:] = 0
    return (torch.from_numpy(planes), torch.from_numpy(off3.astype(np.int32)),
            torch.from_numpy(cand_t.astype(np.int32)), torch.from_numpy(base.astype(np.int32)), win)


CASES = ["fixture_win8", "dual_f128_win4", "win1", "win2", "win3", "win5", "win12", "win32", "f37", "k1",
         "full4_f256_win8", "full4_f64_win20", "full4_f512_win4", "zero_plane", "last_byte"]


def _jax_gather(planes, off3, cand_t, base_yx, win):
    """The XLA gather path of linemod_tpu/ops/matching.py:634-644 in jnp."""
    _, rows, stride = planes.shape
    o = jnp.asarray(off3.numpy())[jnp.asarray(cand_t.numpy())]
    offs = (o[..., 0] * rows + o[..., 1]) * stride + o[..., 2]
    sub = (jnp.arange(win)[:, None] * stride + jnp.arange(win)[None, :]).reshape(-1)
    b = base_yx.numpy()
    pos = jnp.asarray(b[:, 0] * stride + b[:, 1])[:, None] + sub[None, :]
    idx = offs[:, :, None] + pos[:, None, :]
    flat = jnp.asarray(planes.numpy()).reshape(-1)
    return np.asarray(flat[idx].astype(jnp.int32).sum(axis=1)).reshape(-1, win, win)


@pytest.mark.parametrize("name", CASES)
def test_warp_fine_equals_plain_and_jax(name):
    planes, off3, cand_t, base_yx, win = _case(name)
    want = sc.fine_scores_plain(planes, off3, cand_t, base_yx, win).numpy()
    np.testing.assert_array_equal(warp_fine(planes, off3, cand_t, base_yx, win), want)
    np.testing.assert_array_equal(_jax_gather(planes, off3, cand_t, base_yx, win), want)
    if name.startswith("full4"):
        assert (want == 4 * off3.shape[1]).all()
        assert off3.shape[1] // sc.fine_layout(win)[1] > sc.FINE_FLUSH  # a lane passes a flush period
    if name == "last_byte":
        assert want[0, -1, -1] == off3.shape[1] * int(planes[-1, -1, -1])


@pytest.mark.parametrize("name", ["fixture_win8", "dual_f128_win4", "win3"])
def test_warp_fine_equals_pallas(name):
    """The Pallas kernel's 8 x 128 tile, cropped to the window, on the first
    candidates of the cases whose window fits the tile."""
    from linemod_tpu.ops.similarity_pallas import fine_scores_pallas

    planes, off3, cand_t, base_yx, win = _case(name)
    cand_t, base_yx = cand_t[:6], base_yx[:6]
    pallas = np.asarray(
        fine_scores_pallas(jnp.asarray(planes.numpy()), jnp.asarray(off3.numpy()),
                           jnp.asarray(cand_t.numpy()), jnp.asarray(base_yx.numpy()), interpret=True)
    )[:, :win, :win]
    np.testing.assert_array_equal(warp_fine(planes, off3, cand_t, base_yx, win), pallas)


def test_fine_layout():
    """A row's lanes hold its words plus the extra one, slices split a warp
    evenly, a candidate takes two warps from windows 2 to 8 (one at window
    1, more only where a warp holds fewer rows than half the window), and at
    the color-only and dual windows every lane reads."""
    for win in range(1, 33):
        lanes_row, slices = sc.fine_layout(win)
        row_words = -(-win // 4)
        assert row_words + 1 <= lanes_row < 2 * (row_words + 1) and lanes_row & (lanes_row - 1) == 0
        rows = 32 // (lanes_row * slices)
        assert 32 % (lanes_row * slices) == 0 and rows & (rows - 1) == 0
        warps = -(-win // rows)
        assert warps == (1 if win == 1 else 2) or (slices == 1 and rows == 32 // lanes_row)
    assert sc.fine_layout(8) == (4, 2) and sc.fine_layout(4) == (2, 8)
    for win in (0, 33):
        with pytest.raises(ValueError):
            sc.fine_layout(win)


def test_fine_constants_match_the_source():
    """The Python constants mirror csrc/similarity.cu's, and the C entry
    dispatches each window to the kernel of fine_layout's words."""
    from linemod_tpu_torch.ops import cuda_lib

    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kFineMaxWarps") >= sc.FINE_WARPS >= 1
    assert const("kFineFlush") == sc.FINE_FLUSH and const("kFineBatch") == sc.FINE_BATCH
    assert const("kFineMaxFeatures") == sc._MAX_FEATURES
    assert "constexpr int kRows = 32 / (L * S);" in src and "constexpr int kPer = kFineBatch / S;" in src
    launched = set(re.findall(r"FINE_LAUNCH\((\d+), (\d+)\)", src))
    assert {tuple(str(v) for v in sc.fine_layout(win)) for win in range(1, 33)} == launched


def test_fine_time_variants_change_lines_the_kernel_has():
    """The timing tool builds variants of the kernel by replacing one
    source line each; the lines must still be there, once."""
    from linemod_tpu_torch.ops import cuda_lib
    from linemod_tpu_torch.tools.fine_time import VARIANTS

    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()
    for name, (line, _) in VARIANTS.items():
        assert src.count(line) == 1, name
