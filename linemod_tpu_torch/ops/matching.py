"""Detect-time template matching: the coarse-to-fine pyramid scan
(counterpart of `linemod_tpu/ops/matching.py`).

- the whole bank is scored at the coarse level (half resolution, T=8
  spreading): every template at every coarse grid cell, by the
  `coarse_scores` kernel, with the state's plan (`MatchState.coarse_plan`,
  built once with the state; the cuts' template subsets cut it on the
  device);
- an exact top-K of (template, cell) candidates, in the canonical order
  (similarity descending, then flat template*G + cell index ascending),
  by one of three cuts that give the same candidates:
  - dense: one stable sort of the whole [N, G] similarity (the default);
  - streaming (`MatchConfig.scan_chunk`): the bank in chunks, each chunk's
    top-K merged into a running top-K;
  - prefiltered (`MatchConfig.prefilter_sel`, banks above 8,192 templates):
    one masked max per template (the `coarse_max` kernel), then the dense
    cut over the best `prefilter_sel` templates only, with an on-device
    proof that the result equals the dense cut (`cut_exact`);
- each candidate is refined at the fine level (full resolution, T=2) over
  the sub-cell window its coarse cell covers, by the `fine_scores` kernel;
- similarity = 100 * raw / (4 * num_features); matches are kept when both
  levels reach the detector threshold.

In dual-modality mode (`MatchConfig.dual_modality`: color gradients and
depth normals, T=5/8) each level's planes are the color planes, then the
normal planes, then the zero plane, and a template's features of both
modalities ride in one table, the normal ones on planes offset past the
color planes.

`match_templates_quant` starts from the two quantized orientation maps
that the host made (utils/native.quantize_frame) in place of the color
frame.

The reference's two cut opt-ins compute the exact cut here:
`MatchConfig.approx_topk` asks for `lax.approx_max_k`, which XLA's CPU and
GPU backends lower to the exact `lax.top_k` (values, indices and tie order
equal), so it is the dense cut; `MatchConfig.guarded_cut` counts the
above-threshold entries as the reference's guard does and selects, on the
device, between the re-ranked fast pass and the exact cut, both of which
are the canonical exact cut here.

Spans (utils/profiling) mark the program's host enqueue: `match.quantize`
and `match.planes` once a level, `match.cut`, `match.refine` and
`match.pack`.

The outputs equal the JAX reference's: integers exactly, similarities bit
for bit (the percent scale is computed in the same float32 order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .extract import downsample2
from .gradients import quantize_color_gradients
from ..utils.profiling import span
from .normals import quantize_normals
from .similarity_cuda import (
    CoarseMaxPlan,
    coarse_max,
    coarse_max_plan,
    coarse_scores,
    feature_plane_triplets,
    fine_scores,
)
from .spread import feature_flat_offsets, linear_plane_shape, linearized_response_planes

MAX_RESPONSE = 4


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    width: int = 640
    height: int = 480
    t_fine: int = 2  # T at level 0
    t_coarse: int = 8  # T at level 1
    top_k: int = 512
    threshold: float = 80.0
    dual_modality: bool = False
    template_chunk: int = 256  # the bank is padded to a multiple of this
    # streaming cut: scan the bank in chunks of this many templates, merging
    # a running exact top-K instead of sorting the dense [N, G] similarity
    # (463 MB at 96,512 templates); 0 = the dense cut
    scan_chunk: int = 0
    # prefiltered exact cut: rescan only the best `prefilter_sel` templates
    # by their masked max; 0 = off. Takes precedence over scan_chunk.
    prefilter_sel: int = 0
    # the reference's opt-ins for its TPU cut (off there by default); both
    # give the exact cut on this backend (candidate_cut)
    approx_topk: bool = False
    guarded_cut: bool = False  # takes precedence over approx_topk


TENSOR_FIELDS = (
    "off_fine", "off_coarse", "nf_fine", "nf_coarse", "lim_coarse",
    "off3_coarse", "off3_fine",
)
META_FIELDS = (
    "cfg", "n_templates", "fine_shape", "coarse_shape",
    "max_cells_fine", "max_cells_coarse",
)


@dataclasses.dataclass
class MatchState:
    """Bank data in scan layout: int32 tensors on one device plus the static
    plane geometry."""

    cfg: MatchConfig
    n_templates: int
    off_fine: torch.Tensor  # [N, F] flat offsets into the fine planes
    off_coarse: torch.Tensor  # [N, F] flat offsets into the coarse planes
    nf_fine: torch.Tensor  # [N] valid feature counts (>= 1)
    nf_coarse: torch.Tensor
    lim_coarse: torch.Tensor  # [N, 2] (gy_lim, gx_lim) cells where the template fits
    off3_coarse: torch.Tensor  # [N, F, 3] (plane, sy, sx), coarse level
    off3_fine: torch.Tensor  # [N, F, 3] (plane, sy, sx), fine level
    fine_shape: tuple  # (ch, cw, rows, stride)
    coarse_shape: tuple
    max_cells_fine: int
    max_cells_coarse: int
    # the coarse kernel's plan of off3_coarse (built with the state, never
    # per frame; _coarse_rows cuts it with the triplets)
    coarse_plan: CoarseMaxPlan


def takes_prefilter(cfg: MatchConfig, n: int) -> bool:
    """Whether a bank of n (padded) templates takes the prefiltered cut."""
    return bool(cfg.prefilter_sel) and n > max(cfg.prefilter_sel, cfg.top_k)


def _level_offsets(feats, valids, t, rows, stride, plane_base, zero_base):
    xs = feats[:, :, 0].astype(np.int64)
    ys = feats[:, :, 1].astype(np.int64)
    oris = feats[:, :, 2].astype(np.int64)
    off = feature_flat_offsets(xs, ys, oris, t, rows, stride) + plane_base
    return np.where(valids, off, zero_base).astype(np.int32)


def _n_planes(cfg: MatchConfig, t: int) -> int:
    """Response planes of one level, both modalities, without the zero plane."""
    return (2 if cfg.dual_modality else 1) * 8 * t * t


def _check_triplets(off3: np.ndarray, shape: tuple, n_planes: int, level: str) -> None:
    """The kernels read planes[p, gy + sy, gx + sx] for gy < ch, gx < cw
    unchecked, so every triplet must keep that inside the planes."""
    ch, cw, rows, stride = shape
    p, sy, sx = off3[..., 0], off3[..., 1], off3[..., 2]
    if off3.size and (
        p.min() < 0 or p.max() > n_planes or sy.min() < 0 or sx.min() < 0
        or sy.max() + ch > rows or sx.max() + cw > stride
    ):
        raise ValueError(f"{level} feature triplets fall outside planes of shape {shape}")


def match_state_from_numpy(arrays: dict, meta: dict, device) -> MatchState:
    """MatchState from host arrays (one int32 array per TENSOR_FIELDS name)
    and static metadata (META_FIELDS; `cfg` is a MatchConfig or a mapping
    holding at least its fields, e.g. `dataclasses.asdict` of the JAX
    reference's config).

    With the leaves and metadata of a JAX `MatchState` this carries a state
    built by the reference over unchanged."""
    cfg = meta["cfg"]
    if not isinstance(cfg, MatchConfig):
        cfg = MatchConfig(**{f.name: cfg[f.name] for f in dataclasses.fields(MatchConfig)})
    host = {k: np.array(arrays[k], order="C") for k in TENSOR_FIELDS}
    for k, a in host.items():
        if a.dtype != np.int32:
            raise ValueError(f"{k} must be int32, got {a.dtype}")
    fine_shape = tuple(int(v) for v in meta["fine_shape"])
    coarse_shape = tuple(int(v) for v in meta["coarse_shape"])
    n_planes_c = _n_planes(cfg, cfg.t_coarse)
    _check_triplets(host["off3_coarse"], coarse_shape, n_planes_c, "coarse")
    _check_triplets(host["off3_fine"], fine_shape, _n_planes(cfg, cfg.t_fine), "fine")
    tensors = {k: torch.as_tensor(a, device=device) for k, a in host.items()}
    ch, cw, rows, stride = coarse_shape
    plan = coarse_max_plan(tensors["off3_coarse"], (n_planes_c + 1, rows, stride), ch, cw)
    return MatchState(
        cfg=cfg,
        n_templates=int(meta["n_templates"]),
        fine_shape=fine_shape,
        coarse_shape=coarse_shape,
        max_cells_fine=int(meta["max_cells_fine"]),
        max_cells_coarse=int(meta["max_cells_coarse"]),
        coarse_plan=plan,
        **tensors,
    )


def build_match_state(bank, cfg: MatchConfig, device) -> MatchState:
    """Per-template plane offsets and triplets from a (padded) TemplateBank.
    The bank's modality must be the config's."""
    if cfg.dual_modality != bank.dual_modality:
        raise ValueError(
            f"a {'dual' if bank.dual_modality else 'color-only'} bank needs a config with "
            f"dual_modality={bank.dual_modality}"
        )
    n = bank.num_templates
    bw = bank.bbox[:, 2]
    bh = bank.bbox[:, 3]
    mc_fine = int(np.ceil(max(bw.max(), bh.max()) / cfg.t_fine)) + 1
    mc_coarse = int(np.ceil(max(bw.max(), bh.max()) / 2 / cfg.t_coarse)) + 1
    fine = linear_plane_shape(cfg.height, cfg.width, cfg.t_fine, mc_fine)
    coarse = linear_plane_shape(cfg.height // 2, cfg.width // 2, cfg.t_coarse, mc_coarse)
    ch, cw, rows_c, stride_c = coarse
    _, _, rows_f, stride_f = fine
    # one modality's planes at each level; the zero plane follows all of them
    mod_f = 8 * cfg.t_fine * cfg.t_fine
    mod_c = 8 * cfg.t_coarse * cfg.t_coarse
    zero_f, zero_c = _n_planes(cfg, cfg.t_fine), _n_planes(cfg, cfg.t_coarse)
    mods = [(bank.feat0, bank.valid0, bank.feat1, bank.valid1)]
    if cfg.dual_modality:
        mods.append((bank.nfeat0, bank.nvalid0, bank.nfeat1, bank.nvalid1))
    offs_f, offs_c, trips_f, trips_c = [], [], [], []
    for m, (f0, v0, f1, v1) in enumerate(mods):
        offs_f.append(_level_offsets(
            f0, v0, cfg.t_fine, rows_f, stride_f, m * mod_f * rows_f * stride_f,
            zero_f * rows_f * stride_f,
        ))
        offs_c.append(_level_offsets(
            f1, v1, cfg.t_coarse, rows_c, stride_c, m * mod_c * rows_c * stride_c,
            zero_c * rows_c * stride_c,
        ))
        # a valid feature of modality m lies on its plane past m modalities'
        for trips, f, v, t, per_mod, zero in (
            (trips_f, f0, v0, cfg.t_fine, mod_f, zero_f),
            (trips_c, f1, v1, cfg.t_coarse, mod_c, zero_c),
        ):
            tr = feature_plane_triplets(f, v, t, zero)
            tr[:, :, 0] = np.where(v, tr[:, :, 0] + m * per_mod, tr[:, :, 0])
            trips.append(tr)
    # coarse-cell bounds where the template still fits in the image
    gy_lim = ch - np.ceil(bh / 2 / cfg.t_coarse).astype(np.int64)
    gx_lim = cw - np.ceil(bw / 2 / cfg.t_coarse).astype(np.int64)
    arrays = {
        "off_fine": np.concatenate(offs_f, axis=1),
        "off_coarse": np.concatenate(offs_c, axis=1),
        # inert (padding) templates have no features: clamp to avoid 0-division
        "nf_fine": np.maximum(sum(m[1].sum(1) for m in mods), 1).astype(np.int32),
        "nf_coarse": np.maximum(sum(m[3].sum(1) for m in mods), 1).astype(np.int32),
        "lim_coarse": np.stack([gy_lim, gx_lim], axis=1).astype(np.int32),
        "off3_coarse": np.concatenate(trips_c, axis=1),
        "off3_fine": np.concatenate(trips_f, axis=1),
    }
    meta = {
        "cfg": cfg, "n_templates": n, "fine_shape": fine, "coarse_shape": coarse,
        "max_cells_fine": mc_fine, "max_cells_coarse": mc_coarse,
    }
    return match_state_from_numpy(arrays, meta, device)


def _planes_from_quant(quants, t: int, max_cells: int) -> torch.Tensor:
    """Linearized response planes [P(+1 zero), rows, stride] uint8 from one
    quantized orientation map per modality; the trailing all-zero plane is
    where invalid-feature offsets point."""
    h, w = quants[0].shape
    hp = h - h % t
    wp = w - w % t
    _, _, rows, stride = linear_plane_shape(hp, wp, t, max_cells)
    with span("match.planes"):
        planes = [
            linearized_response_planes(q[:hp, :wp], t, max_cells).reshape(-1, rows, stride)
            for q in quants
        ]
        planes.append(planes[0].new_zeros((1, rows, stride)))
        return torch.cat(planes, dim=0)


def _planes_3d(color: torch.Tensor, t: int, max_cells: int, depth=None, half: bool = False) -> torch.Tensor:
    """Quantize one pyramid level -> its linearized planes: the color
    modality's, then (given the depth, in dual mode) the normal modality's.
    `half`: the level of the frame downsampled 2x (the coarse level; its
    depth is strided, not averaged)."""
    with span("match.quantize"):
        if half:
            color = downsample2(color)
            depth = None if depth is None else depth[::2, ::2]
        quants = [quantize_color_gradients(color)[0]]
        if depth is not None:
            quants.append(quantize_normals(depth)[0])
    return _planes_from_quant(quants, t, max_cells)


def match_templates(state: MatchState, color: torch.Tensor, depth=None, pack=None):
    """Coarse-to-fine match of the whole bank against one frame.

    color: [H, W, 3] float 0..255 BGR; depth: [H, W] float mm, needed in
    dual mode and ignored otherwise; both on the state's device. Returns a
    dict of [top_k] tensors (template_id, x, y: level-0 bbox top-left
    pixels, similarity in percent, valid), sorted by similarity descending;
    with `pack` (detect_core._pack), pack of that dict."""
    cfg = state.cfg
    if cfg.dual_modality and depth is None:
        raise ValueError("dual-modality matching needs the depth image")
    depth = depth if cfg.dual_modality else None
    fine_planes = _planes_3d(color, cfg.t_fine, state.max_cells_fine, depth)
    coarse_planes = _planes_3d(color, cfg.t_coarse, state.max_cells_coarse, depth, half=True)
    return _match_with_planes(state, fine_planes, coarse_planes, pack)


def match_templates_quant(state: MatchState, quant0: torch.Tensor, quant1: torch.Tensor, pack=None):
    """match_templates from the quantized orientation maps of both pyramid
    levels (the host-quantize route, utils/native.quantize_frame):
    quant0 [H, W] and quant1 [H/2, W/2] uint8 one-hot, on the state's
    device. Color-only states only."""
    cfg = state.cfg
    if cfg.dual_modality:
        raise ValueError("match_templates_quant takes a color-only state; a dual state needs the depth")
    fine_planes = _planes_from_quant([quant0], cfg.t_fine, state.max_cells_fine)
    coarse_planes = _planes_from_quant([quant1], cfg.t_coarse, state.max_cells_coarse)
    return _match_with_planes(state, fine_planes, coarse_planes, pack)


def coarse_similarity(state: MatchState, coarse_planes: torch.Tensor) -> torch.Tensor:
    """[N, G] float32 percent similarity of every template at every coarse
    cell, -1 where the template does not fit the image at that cell."""
    ch, cw = state.coarse_shape[0], state.coarse_shape[1]
    return coarse_percent(state, coarse_scores(coarse_planes, state.off3_coarse, ch, cw, plan=state.coarse_plan))


def coarse_percent(state: MatchState, scores: torch.Tensor) -> torch.Tensor:
    """coarse_similarity from the scan's raw int32 [N, ch, cw] scores: the
    percent scale, and -1 where the template does not fit the image."""
    ch, cw = state.coarse_shape[0], state.coarse_shape[1]
    scores = scores.reshape(-1, ch * cw)
    dev = scores.device
    gy = torch.arange(ch, dtype=torch.int32, device=dev).repeat_interleave(cw)
    gx = torch.arange(cw, dtype=torch.int32, device=dev).repeat(ch)
    fits = (gy[None, :] < state.lim_coarse[:, 0:1]) & (gx[None, :] < state.lim_coarse[:, 1:2])
    sim_c = scores.float() * 100.0 / (MAX_RESPONSE * state.nf_coarse[:, None].float())
    return torch.where(fits, sim_c, -1.0)


def candidate_cut(sim_c: torch.Tensor, cw: int, top_k: int, cfg: MatchConfig | None = None):
    """Exact top-K (template, cell) candidates of the dense [N, G] similarity
    in canonical order: similarity descending, then flat index t*G + g
    ascending (a stable descending sort keeps tied entries in index order;
    torch.topk leaves tie order unspecified, and the fixture frame has a
    625-fold tie at the K-th value, above threshold).

    `cfg.approx_topk` is this cut: the reference's `lax.approx_max_k` is the
    exact top_k on XLA's CPU and GPU backends. `cfg.guarded_cut` runs the
    reference's guard over it (`_guarded`).
    Returns (top_sim, cand_t, cand_gy, cand_gx), each [top_k]."""
    n_cells = sim_c.shape[1]
    flat = sim_c.reshape(-1)
    top_sim, top_idx = torch.sort(flat, descending=True, stable=True)
    top_sim, top_idx = top_sim[:top_k], top_idx[:top_k]
    if cfg is not None and cfg.guarded_cut:
        top_sim, top_idx = _guarded(flat, (top_sim, top_idx), (top_sim, top_idx), cfg.threshold, top_k)
    cand_g = top_idx % n_cells
    return top_sim, top_idx // n_cells, cand_g // cw, cand_g % cw


def _guarded(flat: torch.Tensor, approx: tuple, exact: tuple, threshold: float, top_k: int):
    """The reference's guarded cut (`MatchConfig.guarded_cut`): `approx`,
    the approximate pass's (sim, index), holds entries at or above the
    threshold that are a sub-multiset of the dense ones, so equal counts
    prove that it caught every one of them; then the pass re-ranked by
    (sim desc, index asc) is the result, else `exact`. The choice is made on
    the device, without a sync. (Here the pass is the exact cut itself.)"""
    caught = (approx[0] >= threshold).sum() == (flat >= threshold).sum()
    f_sim, f_idx = rank_by_sim_then_index(*approx, top_k)
    return torch.where(caught, f_sim, exact[0]), torch.where(caught, f_idx, exact[1])


def rank_by_sim_then_index(sim: torch.Tensor, idx: torch.Tensor, top_k: int):
    """(sim desc, idx asc) top-K of a candidate set: a stable sort by index,
    then a stable descending sort by similarity. Returns (top_sim, top_idx)."""
    by_idx = torch.sort(idx, stable=True).indices
    top_sim, order = torch.sort(sim[by_idx], descending=True, stable=True)
    return top_sim[:top_k], idx[by_idx[order[:top_k]]]


def _coarse_rows(state: MatchState, rows) -> MatchState:
    """The state with its coarse-level fields cut to `rows` (a slice or an
    index tensor on the state's device); the fine-level fields stay whole.
    The plan is cut with the triplets, on the device (the rescan and the
    streaming chunks build none per frame)."""
    off3 = state.off3_coarse[rows]
    return dataclasses.replace(
        state,
        off_coarse=state.off_coarse[rows],
        nf_coarse=state.nf_coarse[rows],
        lim_coarse=state.lim_coarse[rows],
        off3_coarse=off3,
        coarse_plan=state.coarse_plan.take_rows(rows, off3),
    )


def candidate_cut_streaming(state: MatchState, coarse_planes: torch.Tensor, top_k: int):
    """The exact cut of candidate_cut without the dense [N, G] similarity:
    the bank in chunks of `cfg.scan_chunk` templates (shrunk to a divisor of
    N), each chunk's top-K merged into the running top-K. Chunks arrive in
    ascending template order, so the merge keeps the canonical order.
    Returns (top_sim, cand_t, cand_gy, cand_gx), each [top_k]."""
    n = state.off_coarse.shape[0]
    chunk = min(state.cfg.scan_chunk, n)
    while n % chunk:
        chunk -= 1
    ch, cw = state.coarse_shape[0], state.coarse_shape[1]
    n_cells = ch * cw
    run_sim = run_pos = None
    for t0 in range(0, n, chunk):
        sim_c = coarse_similarity(_coarse_rows(state, slice(t0, t0 + chunk)), coarse_planes)
        c_sim, ct, cgy, cgx = candidate_cut(sim_c, cw, top_k, state.cfg)
        c_pos = (ct + t0) * n_cells + cgy * cw + cgx
        if run_sim is not None:
            c_sim, c_pos = rank_by_sim_then_index(
                torch.cat([run_sim, c_sim]), torch.cat([run_pos, c_pos]), top_k
            )
        run_sim, run_pos = c_sim, c_pos
    cand_g = run_pos % n_cells
    return run_sim, run_pos // n_cells, cand_g // cw, cand_g % cw


def _template_maxes(state: MatchState, coarse_planes: torch.Tensor) -> torch.Tensor:
    """[N] float32 masked max percent similarity of each template over the
    coarse cells where it fits, -1 where it fits nowhere. The `coarse_max`
    kernel gives the raw maxima; the percent scale is monotone, so scaling
    the max equals the max of the scaled similarities."""
    ch, cw = state.coarse_shape[0], state.coarse_shape[1]
    raw = coarse_max(
        coarse_planes, state.off3_coarse, state.lim_coarse, ch, cw, plan=state.coarse_plan
    )
    pct = raw.float() * 100.0 / (MAX_RESPONSE * state.nf_coarse.float())
    return torch.where(raw < 0, -1.0, pct)


def candidate_cut_prefilter(state: MatchState, coarse_planes: torch.Tensor, top_k: int):
    """Two-phase exact cut for large banks (`cfg.prefilter_sel`).

    Phase 1: each template's masked max similarity. Phase 2: the best
    n_sel = max(prefilter_sel, top_k) templates by (max desc, template asc),
    rescanned densely in ascending template order, and cut exactly there.
    Every global top-K entry's template has a max >= the K-th value v*, and
    v* >= theta (the weakest selected max), since the selected templates
    alone supply n_sel >= K values >= theta. So the cut is the dense cut
    unless more than n_sel maxes reach theta (saturated) and v* == theta
    above the threshold; `exact` is False only then, and the caller re-runs
    such a frame on the streaming cut.
    Returns (top_sim, cand_t, cand_gy, cand_gx, exact); exact is a bool
    scalar tensor."""
    cfg = state.cfg
    n = state.off_coarse.shape[0]
    n_sel = min(max(cfg.prefilter_sel, top_k), n)
    m_pct = _template_maxes(state, coarse_planes)
    sel_sim, sel_idx = rank_by_sim_then_index(
        m_pct, torch.arange(n, device=m_pct.device), n_sel
    )
    theta = sel_sim[n_sel - 1]
    saturated = (m_pct >= theta).sum() > n_sel
    # ascending template order: the rescan's (sim desc, flat index asc) tie
    # order then coincides with the global canonical order
    sel_sorted = torch.sort(sel_idx).values
    sim_c = coarse_similarity(_coarse_rows(state, sel_sorted), coarse_planes)
    top_sim, ct, cand_gy, cand_gx = candidate_cut(sim_c, state.coarse_shape[1], top_k, cfg)
    v_star = top_sim[top_k - 1]
    exact = ~saturated | (v_star > theta) | (v_star < cfg.threshold)
    return top_sim, sel_sorted[ct], cand_gy, cand_gx, exact


def fine_refine(state: MatchState, fine_planes, cand_t, cand_gy, cand_gx):
    """Refine each candidate over the fine sub-cell window of its coarse cell.

    One coarse cell spans 2*t_coarse level-0 px; the window origin is the
    exact fine-grid cell (g * 2 * t_coarse) // t_fine and the window spans
    ceil(2 * t_coarse / t_fine) cells (8 in color-only mode). The first
    maximum of the window wins. Returns (sim, x, y), each [K]; x, y are
    level-0 bbox top-left pixels."""
    cfg = state.cfg
    span = 2 * cfg.t_coarse
    win = -(-span // cfg.t_fine)
    base_gy = (cand_gy * span) // cfg.t_fine
    base_gx = (cand_gx * span) // cfg.t_fine
    base_yx = torch.stack([base_gy, base_gx], dim=1).to(torch.int32)
    scores = fine_scores(
        fine_planes, state.off3_fine, cand_t.to(torch.int32), base_yx, win
    ).reshape(-1, win * win)
    best = scores.argmax(dim=1)
    best_raw = scores.gather(1, best[:, None])[:, 0]
    sim = best_raw.float() * 100.0 / (MAX_RESPONSE * state.nf_fine[cand_t].float())
    x = (base_gx + best % win) * cfg.t_fine
    y = (base_gy + best // win) * cfg.t_fine
    return sim, x, y


def finalize_matches(cfg: MatchConfig, cand_t, sim, x, y, top_sim) -> dict:
    """Keep candidates at threshold at both pyramid levels, sort them by fine
    similarity (stable, so ties keep cut order), and set invalid slots to
    sentinels (id -1, x/y 0, sim -1) so the output is deterministic."""
    valid = (sim >= cfg.threshold) & (top_sim >= cfg.threshold)
    order = torch.argsort(-torch.where(valid, sim, -1.0), stable=True)
    v = valid[order]
    return {
        "template_id": torch.where(v, cand_t[order], -1),
        "x": torch.where(v, x[order], 0),
        "y": torch.where(v, y[order], 0),
        "similarity": torch.where(v, sim[order], -1.0),
        "valid": v,
    }


def _match_with_planes(state: MatchState, fine_planes, coarse_planes, pack=None):
    """The cut, the refine and finalize_matches on a frame's planes; `pack`,
    when given, runs on the match dict inside the `match.pack` span."""
    if tuple(fine_planes.shape[1:]) != tuple(state.fine_shape[2:]) or tuple(
        coarse_planes.shape[1:]
    ) != tuple(state.coarse_shape[2:]):
        raise ValueError(
            f"frame planes {tuple(fine_planes.shape)}, {tuple(coarse_planes.shape)} do not "
            f"match the state's geometry {state.fine_shape}, {state.coarse_shape}"
        )
    cfg = state.cfg
    n = state.off_coarse.shape[0]
    cut_exact = None
    with span("match.cut"):
        if takes_prefilter(cfg, n):
            top_sim, cand_t, cand_gy, cand_gx, cut_exact = candidate_cut_prefilter(
                state, coarse_planes, cfg.top_k
            )
        elif cfg.scan_chunk and n > cfg.scan_chunk:
            top_sim, cand_t, cand_gy, cand_gx = candidate_cut_streaming(
                state, coarse_planes, cfg.top_k
            )
        else:
            sim_c = coarse_similarity(state, coarse_planes)
            top_sim, cand_t, cand_gy, cand_gx = candidate_cut(sim_c, state.coarse_shape[1], cfg.top_k, cfg)
    with span("match.refine"):
        sim, x, y = fine_refine(state, fine_planes, cand_t, cand_gy, cand_gx)
    with span("match.pack"):
        out = finalize_matches(cfg, cand_t, sim, x, y, top_sim)
        if cut_exact is not None:
            # the prefiltered cut's proof; detect_core packs it as an extra row
            out["cut_exact"] = cut_exact
        return out if pack is None else pack(out)
