"""The device time of each stage of the match program on one card
(counterpart of `scripts/profile_stages.py`).

    python -m linemod_tpu_torch.tools.profile_stages [--device cuda] [--reps 20]

Runs the fixture frame (`example/benchmark/img0.png`, recentred) with the
committed bank (1,950 templates, padded to 2,048) and times each stage of
`ops/matching.match_templates` on its own, on the outputs of the stages
before it, computed once. The stages are named after PERF.md §3's layers.
For each: event ms (`tools/timing.event_ms`: CUDA events around `--reps`
calls queued behind a sleep; a stage of more launches than the driver's
pending-launch queue holds, such as the whole match, times the host's
enqueue too), the profiler's device busy ms and device operations a call
(`tools/timing.device_profile`), and the kernels' launches a call. On the
CPU it prints the host ms of each stage and no device numbers.

The JAX script perturbs its input inside `lax.scan` so that XLA cannot
merge the repetitions; eager PyTorch runs every call, so the port's own
functions are timed as they are. Its "approx" top-k row is the exact cut on
this backend (`MatchConfig.approx_topk`), so the cut is timed once.

`run_stages` composes the same stage functions into the packed candidates
of `detect_frame`. The last line is a JSON object of the stages' numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..cli import device_from_flag
from ..ops import similarity_cuda as sc
from ..ops.detect_core import _pack
from ..ops.gradients import quantize_color_gradients
from ..ops.matching import (
    MatchState,
    _match_with_planes,
    _planes_3d,
    candidate_cut,
    coarse_percent,
    finalize_matches,
    fine_refine,
    match_templates,
)
from ..ops.spread import linearize, response_maps, spread_orientations
from ..pipeline.pose_detection import PoseDetection
from .fixture import load_fixture
from .timing import card_name, event_ms, launches, profile_call, reset_launches, shown

REPS = 20


def _with_zero_plane(planes: torch.Tensor) -> torch.Tensor:
    """Linearized planes [8, T, T, rows, stride] -> [8 T^2 + 1, rows, stride]
    with the trailing all-zero plane invalid features point at."""
    flat = planes.reshape(-1, planes.shape[-2], planes.shape[-1])
    return torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])


def _crop(quant: torch.Tensor, t: int) -> torch.Tensor:
    """The quantized map cut to multiples of T, as the planes take it."""
    h, w = quant.shape
    return quant[: h - h % t, : w - w % t]


def _both_levels(st: MatchState, c: torch.Tensor, x: dict) -> tuple:
    cfg = st.cfg
    return (_planes_3d(c, cfg.t_fine, st.max_cells_fine),
            _planes_3d(c, cfg.t_coarse, st.max_cells_coarse, half=True))


# (name, PERF.md §3 layer, key of the output it adds to x or None,
#  fn(state, color [H, W, 3] float32 on the device, x)): in the match
# program's order; the stages with a key compose into the packed output
STAGES = (
    ("full match", "the match program", None, lambda st, c, x: match_templates(st, c)),
    ("planes, both levels", "response planes", None, _both_levels),
    ("quantize L0", "response planes: quantize", "quant0", lambda st, c, x: quantize_color_gradients(c)[0]),
    ("downsample2 + quantize L1", "response planes: quantize", "quant1",
     lambda st, c, x: quantize_color_gradients(c, half=True)[0]),
    ("spread T=2 L0", "response planes: spread", "spread0",
     lambda st, c, x: spread_orientations(_crop(x["quant0"], st.cfg.t_fine), st.cfg.t_fine)),
    ("spread T=8 L1", "response planes: spread", "spread1",
     lambda st, c, x: spread_orientations(_crop(x["quant1"], st.cfg.t_coarse), st.cfg.t_coarse)),
    ("response LUT L0", "response planes: response LUT", "resp0", lambda st, c, x: response_maps(x["spread0"])),
    ("response LUT L1", "response planes: response LUT", "resp1", lambda st, c, x: response_maps(x["spread1"])),
    ("linearize L0 (T=2)", "response planes: linearize", "fine_planes",
     lambda st, c, x: _with_zero_plane(linearize(x["resp0"], st.cfg.t_fine, st.max_cells_fine))),
    ("linearize L1 (T=8)", "response planes: linearize", "coarse_planes",
     lambda st, c, x: _with_zero_plane(linearize(x["resp1"], st.cfg.t_coarse, st.max_cells_coarse))),
    ("coarse scan, kernel 2.1", "coarse scan, kernel 2.1", "scores",
     lambda st, c, x: sc.coarse_scores(x["coarse_planes"], st.off3_coarse, st.coarse_shape[0], st.coarse_shape[1],
                                       plan=st.coarse_plan)),
    ("percent scale and fit mask", "coarse scan, kernel 2.1", "sim_c",
     lambda st, c, x: coarse_percent(st, x["scores"])),
    ("match given planes", "coarse scan to pack", None,
     lambda st, c, x: _match_with_planes(st, x["fine_planes"], x["coarse_planes"])),
    ("exact top-512 cut (also the approx row)", "dense cut", "cut",
     lambda st, c, x: candidate_cut(x["sim_c"], st.coarse_shape[1], st.cfg.top_k, st.cfg)),
    ("fine refine, kernel 2.2", "fine refine, kernel 2.2", "refined",
     lambda st, c, x: fine_refine(st, x["fine_planes"], *x["cut"][1:])),
    ("threshold, sort, pack", "threshold, sort, pack", "packed",
     lambda st, c, x: _pack(finalize_matches(st.cfg, x["cut"][1], *x["refined"], x["cut"][0]))),
)


def run_stages(state: MatchState, colorf: torch.Tensor) -> dict:
    """Every composing stage's output, each computed from the ones before
    it; x["packed"] is detect_frame's packed array."""
    x = {}
    for _, _, key, fn in STAGES:
        if key is not None:
            x[key] = fn(state, colorf, x)
    return x


def launches_a_call(fn) -> dict:
    """The kernels' launches during one fn() call."""
    reset_launches()
    fn()
    return launches()


def time_stage(fn, device, reps: int) -> dict:
    """Event ms (on the card), device busy ms and operations a call on the
    card, host ms (median) on the CPU."""
    return {"event_ms": event_ms(fn, reps) if device.type == "cuda" else None, **profile_call(fn, reps, device)}


def run(args) -> dict:
    dev = device_from_flag(args.device)
    card = card_name(dev)
    fx = load_fixture()
    det = PoseDetection(fx.bank, fx.cam, fx.settings, fx.props, dev)
    state = det.state
    colorf = torch.from_numpy(det.recenter(np.ascontiguousarray(fx.color))).to(dev).float()
    x = run_stages(state, colorf)
    print(f"profile_stages: {state.n_templates} templates, frame {tuple(colorf.shape)}, {args.reps} calls a "
          f"stage; {card}")
    rows = []
    for name, layer, _, fn in STAGES:
        call = lambda fn=fn: fn(state, colorf, x)  # noqa: E731
        row = {"name": name, "layer": layer, "launches": launches_a_call(call), **time_stage(call, dev, args.reps)}
        rows.append(row)
        n = row["launches"]
        print(f"  {name:42s} event {shown(row['event_ms'])}, device {shown(row['device_ms'])}, "
              f"operations {shown(row['operations'], '.0f', '')}, host {shown(row['host_ms'], '.2f')}; "
              f"launches 2.1 / 2.2 / 2.3 {n['coarse_scores']:g} / {n['fine_scores']:g} / {n['coarse_max']:g}",
              flush=True)
    return {"tool": "profile_stages", "device": card, "templates": state.n_templates, "reps": args.reps,
            "stages": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=REPS, help="calls each stage is timed over")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
