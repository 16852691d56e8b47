"""Template-bank-sharded matching over a (dp, tp) mesh of ranks
(counterpart of `linemod_tpu/parallel/sharded_match.py`).

Each rank owns one device and runs, for each frame of its dp share:

1. response planes, band-sharded: the rank quantizes and spreads only
   its band of grid rows (`ops/spread.band_planes_from_image`), and one
   all-gather over its tp group reassembles the exact full planes (a zero
   band rides along, so the gather's output is the [P+1] plane stack);
2. the coarse scan of its template shard (kernel 2.1; the shard's own
   kernel plan is built once, by `shard_state`);
3. the candidate cut, exact in every branch, with ties broken by the
   global flat (template, cell) index as the single-device cut breaks them:
   - dense, or streaming when the shard exceeds `scan_chunk`: a local
     top-K, one gather, a replicated merge;
   - two rounds at tp >= 8: a local top-m (m = min(K, max(2K/tp, 256))),
     the merge, and a proof that every shard's m-th value lies strictly
     below the merged K-th (`cut_exact`);
   - prefiltered (`prefilter_sel`): each shard's template maxes (kernel
     2.3), one gather of N floats, the replicated selection, a rescan of a
     static n_sel/tp slice of it (2.1), the merge, and the single-device
     prefilter's proof;
4. the fine refine of a static K/tp slice of the merged candidates (kernel
   2.2; the fine tables are replicated, so any rank refines any template),
   and three gathers;
5. the replicated threshold and sort.

A frame whose proof fails is re-run on an `exact_only` matcher by
`sharded_detect`, whose decision is one all-reduce over the mesh, so every
rank takes the same branch. The outputs equal `ops/matching.match_templates`
bit for bit.

gloo moves CPU tensors only, so on a gloo group a CUDA tensor is staged
through pinned host memory for each collective (`transport`); NCCL moves it
in place. The kernels run on the rank's device either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.extract import downsample2
from ..ops.gradients import quantize_color_gradients
from ..ops.matching import (
    MatchState,
    _coarse_rows,
    _template_maxes,
    candidate_cut,
    candidate_cut_streaming,
    coarse_similarity,
    finalize_matches,
    fine_refine,
    rank_by_sim_then_index,
)
from ..ops.normals import quantize_normals
from ..ops.similarity_cuda import coarse_max_plan
from ..ops.spread import band_planes_from_image
from .mesh import Mesh


def transport(group, device) -> str:
    """How a collective over `group` moves tensors on `device`: "direct"
    (NCCL on CUDA, gloo on the CPU) or "host-staged" (gloo on CUDA, which
    gloo's all_gather does not take: copied to pinned host memory and back)."""
    staged = torch.device(device).type == "cuda" and dist.get_backend(group) == dist.Backend.GLOO
    return "host-staged" if staged else "direct"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[size, *x.shape]: x of every rank of `group`, in group rank order."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    if transport(group, x.device) == "direct":
        out = x.new_empty((size, *x.shape))
        dist.all_gather(list(out.unbind(0)), x, group=group)
        return out
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    out = torch.empty((size, *x.shape), dtype=x.dtype, pin_memory=True)
    dist.all_gather(list(out.unbind(0)), host, group=group)
    return out.to(x.device)


def all_true(flag: torch.Tensor, group) -> bool:
    """Whether `flag` (a bool tensor) is all true on every rank of `group`:
    one MIN all-reduce, whose answer every rank shares."""
    v = flag.all().to(torch.int32).reshape(1)
    if transport(group, v.device) == "host-staged":
        v = v.cpu()
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=group)
    return bool(v.item())


def place_global(x, mesh: Mesh, device) -> torch.Tensor:
    """This rank's dp block of the host array or tensor x on `device`: x
    split along dim 0 over the mesh's dp axis, cut before it is copied to
    the device."""
    if x.shape[0] % mesh.dp:
        raise ValueError(f"{x.shape[0]} frames do not split over dp = {mesh.dp}")
    n = x.shape[0] // mesh.dp
    x = x[mesh.dp_index * n : (mesh.dp_index + 1) * n]
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_state(state: MatchState, mesh: Mesh) -> MatchState:
    """This rank's view of a match state built over the whole (padded) bank:
    the coarse tables cut to its tp shard of templates, with the shard's own
    kernel plan; the fine tables whole (small, and they let any rank refine
    any candidate). With the prefiltered cut (`cfg.prefilter_sel`) the
    coarse tables stay whole too: its rescan takes the selected templates
    wherever they lie."""
    if not mesh.active:
        raise ValueError("this rank is outside the mesh")
    n = state.off_coarse.shape[0]
    if n % mesh.tp:
        raise ValueError(f"{n} templates do not split over tp = {mesh.tp}")
    if state.cfg.prefilter_sel:
        return state
    n_shard = n // mesh.tp
    rows = slice(mesh.tp_index * n_shard, (mesh.tp_index + 1) * n_shard)
    off3 = state.off3_coarse[rows].contiguous()
    ch, cw = state.coarse_shape[:2]
    return dataclasses.replace(
        state,
        off_coarse=state.off_coarse[rows].contiguous(),
        nf_coarse=state.nf_coarse[rows].contiguous(),
        lim_coarse=state.lim_coarse[rows].contiguous(),
        off3_coarse=off3,
        coarse_plan=coarse_max_plan(off3, state.coarse_plan.planes_shape, ch, cw),
    )


def _gathered_planes_band(modalities, t: int, max_cells: int, mesh: Mesh, shape: tuple) -> torch.Tensor:
    """This rank's band of each modality's planes (quantize included) plus a
    zero band, all-gathered over the tp group into the full [P+1, rows,
    stride] planes. modalities: [(image, quantize_fn), ...]."""
    rows, stride = shape[2], shape[3]
    bh = rows // mesh.tp
    parts = [band_planes_from_image(img, t, max_cells, mesh.tp_index, mesh.tp, fn) for img, fn in modalities]
    if any(tuple(p.shape[-2:]) != (bh, stride) for p in parts):
        raise ValueError(
            f"frame planes' bands {[tuple(p.shape) for p in parts]} do not match the state's geometry {shape}"
        )
    parts = [p.reshape(-1, bh, stride) for p in parts]
    local = torch.cat(parts + [parts[0].new_zeros((1, bh, stride))])  # [P+1, rows/tp, stride]
    bands = all_gather(local, mesh.tp_group)  # [tp, P+1, rows/tp, stride]
    return bands.permute(1, 0, 2, 3).reshape(local.shape[0], rows, stride)


class ShardedMatcher:
    """(color [B, H, W, 3], depth [B, H, W] or None) -> dict of this rank's
    frames' outputs, each [B/dp, ...]: rank (i, j) of the mesh returns
    frames [i*B/dp, (i+1)*B/dp), in order, with global template ids and
    `cut_exact` [B/dp] bool. Built by make_sharded_matcher."""

    def __init__(self, state: MatchState, mesh: Mesh, exact_only: bool = False):
        if not mesh.active:
            raise ValueError("this rank is outside the mesh")
        cfg = state.cfg
        if cfg.top_k % mesh.tp:
            raise ValueError(f"top_k {cfg.top_k} must be a multiple of tp {mesh.tp}")
        self.cfg, self.mesh, self.exact_only = cfg, mesh, exact_only
        self.device = state.off_coarse.device
        self.prefilter = bool(cfg.prefilter_sel)
        n_rows = state.off_coarse.shape[0]
        self.n_total = n_rows if self.prefilter else n_rows * mesh.tp
        self.n_shard = self.n_total // mesh.tp
        # the prefiltered cut's tables are whole (shard_state): phase 1 and
        # the exact cuts scan this rank's contiguous range of them
        self.full = state
        t0 = mesh.tp_index * self.n_shard
        self.local = _coarse_rows(state, slice(t0, t0 + self.n_shard)) if self.prefilter else state

    def __call__(self, color, depth=None) -> dict:
        dual = self.cfg.dual_modality
        if dual and depth is None:
            raise ValueError("dual-modality matching needs the depth images")
        colors = place_global(color, self.mesh, self.device).float()
        depths = place_global(depth, self.mesh, self.device).float() if dual else None
        outs = [self._frame(colors[i], depths[i] if dual else None) for i in range(colors.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _frame(self, color: torch.Tensor, depth) -> dict:
        cfg, st, mesh = self.cfg, self.local, self.mesh
        tp, ti, k = mesh.tp, mesh.tp_index, cfg.top_k
        mods0 = [(color, quantize_color_gradients)]
        mods1 = [(downsample2(color), quantize_color_gradients)]
        if depth is not None:
            mods0.append((depth, quantize_normals))
            # the coarse level's depth is strided, not averaged
            mods1.append((depth[::2, ::2], quantize_normals))
        fine = _gathered_planes_band(mods0, cfg.t_fine, st.max_cells_fine, mesh, st.fine_shape)
        coarse = _gathered_planes_band(mods1, cfg.t_coarse, st.max_cells_coarse, mesh, st.coarse_shape)
        cw = st.coarse_shape[1]
        n_cells = st.coarse_shape[0] * cw

        def merge(sim, flat):
            return rank_by_sim_then_index(
                all_gather(sim, mesh.tp_group).flatten(), all_gather(flat, mesh.tp_group).flatten(), k
            )

        def cut_merge(k_local):
            if cfg.scan_chunk and self.n_shard > cfg.scan_chunk:
                top_sim, ct, gy, gx = candidate_cut_streaming(st, coarse, k_local)
            else:
                top_sim, ct, gy, gx = candidate_cut(coarse_similarity(st, coarse), cw, k_local, cfg)
            flat = (ct + ti * self.n_shard) * n_cells + gy * cw + gx
            return (top_sim, *merge(top_sim, flat))

        # tp >= 8 gate on the two-round cut, as the JAX package sets it
        m_small = min(k, max(2 * (k // tp), 256))
        if self.prefilter and not self.exact_only:
            g_max = all_gather(_template_maxes(st, coarse), mesh.tp_group).flatten()
            n_sel = min(max(cfg.prefilter_sel, k), self.n_total) // tp * tp
            sel_sim, sel_idx = rank_by_sim_then_index(
                g_max, torch.arange(self.n_total, device=self.device), n_sel
            )
            theta = sel_sim[n_sel - 1]
            saturated = (g_max >= theta).sum() > n_sel
            s_slice = n_sel // tp
            mine = torch.sort(sel_idx).values[ti * s_slice : (ti + 1) * s_slice]
            sim_sel = coarse_similarity(_coarse_rows(self.full, mine), coarse)
            l_sim, lt, lgy, lgx = candidate_cut(sim_sel, cw, k, cfg)
            m_sim, m_flat = merge(l_sim, mine[lt] * n_cells + lgy * cw + lgx)
            v_star = m_sim[k - 1]
            cut_exact = ~saturated | (v_star > theta) | (v_star < cfg.threshold)
        elif m_small < k and tp >= 8 and not self.exact_only:
            l_sim, m_sim, m_flat = cut_merge(m_small)
            lasts = all_gather(l_sim[m_small - 1 : m_small], mesh.tp_group).flatten()
            cut_exact = (lasts < m_sim[k - 1]).all()
        else:
            _, m_sim, m_flat = cut_merge(k)
            cut_exact = torch.ones((), dtype=torch.bool, device=self.device)
        m_t = m_flat // n_cells
        m_g = m_flat % n_cells

        # the fine refine of this rank's static K/tp slice
        s = slice(ti * (k // tp), (ti + 1) * (k // tp))
        f_sim, f_x, f_y = fine_refine(st, fine, m_t[s], (m_g // cw)[s], (m_g % cw)[s])
        sim, x, y = (all_gather(v, mesh.tp_group).flatten() for v in (f_sim, f_x, f_y))
        out = finalize_matches(cfg, m_t, sim, x, y, m_sim)
        out["cut_exact"] = cut_exact
        return out


def make_sharded_matcher(state: MatchState, mesh: Mesh, exact_only: bool = False) -> ShardedMatcher:
    """The sharded matcher of a state from shard_state on this rank.

    With exact_only=False the two-round and prefiltered cuts report their
    proof in `cut_exact`; a frame flagged False must be re-run on the
    exact_only=True matcher (sharded_detect). Frames flagged True equal the
    single-device path bit for bit."""
    return ShardedMatcher(state, mesh, exact_only)


def sharded_detect(matcher_fast: ShardedMatcher, matcher_exact: ShardedMatcher, color, depth=None) -> dict:
    """One batch through the fast matcher, re-run on the exact one when any
    frame of any rank's share failed its proof. The decision is collective
    (a MIN all-reduce over the mesh), so every rank takes the same branch
    and none waits in a collective its peers skipped."""
    out = matcher_fast(color, depth)
    if all_true(out["cut_exact"], matcher_fast.mesh.group):
        return out
    return matcher_exact(color, depth)
