"""The full-scale bank regime on one card: generation and matching at the
reference's configured bank size (counterpart of `scripts/bigbank_bench.py`).

    python -m linemod_tpu_torch.tools.bigbank_bench [--subdivs 2 3] [--dual] [--device cuda] [--out build/bench]

The reference's settings build up to 642 icosphere views x 15 radii x 10
in-plane rotations = 96,300 templates for a model without rotational
symmetry; the committed fixture bank is pruned to 1,950 by its symmetry.
For each `--subdivs` value (0: 12 views, 1,800 templates; 1: 42, 6,300;
2: 162, 24,300; 3: 642, 96,300), with symmetry pruning off
(`ModelProperties(rotationally_symmetrical=False, planes (0, 0, 0))`):

1. the bank generated on the device (`build_template_bank`) and cached in
   `<out>/bigbank_s<subdiv>.npz` (`--dual`: color gradients and depth
   normals, `<out>/bigbank_dual_s<subdiv>.npz`): seconds, templates/s,
   seconds by phase (`template_bank.TIMED_PHASES`) and the peak device
   memory (`torch.cuda.max_memory_allocated`), with a line after each
   radius of the templates so far, the seconds and that peak so far (a
   cached bank keeps the generation numbers of the row it was measured
   in), and the bank's bytes on disk;
2. the match state (`MatchConfig(top_k=512, scan_chunk=4096,
   prefilter_sel=1024)`, the bank padded to a multiple of 4,096): its device
   bytes (the sum of its tensors' nbytes) and the peak device memory
   (`torch.cuda.max_memory_allocated`) of building it and matching;
3. one random 640x480 frame (seed 0; a dual bank's with a zero depth) on
   the prefiltered cut, which runs the masked max (kernel 2.3), the rescan
   (2.1) and the fine refine (2.2), a dual bank's on the dual layout (F =
   128, t_fine 5): the profiler's device busy ms a frame and its frames/s,
   the host ms a synchronous frame, and the kernels' launches a frame.

Left out: the JAX script's modeled tensor-parallel scaling, which models a
TPU's inter-chip links and is no measurement of the card. Writes
`<out>/bank_scale.json` (never the root BANK_SCALE.json), one row a
(subdiv, dual) with the rows of earlier runs kept, after each subdiv, and
prints it as its last line. Subdiv 2 generates for ~10 minutes on an H100,
subdiv 3 for ~40 (README.md gives the measured times).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..cli import device_from_flag
from ..config import ModelProperties
from ..models.template_bank import TemplateBank, _pad_bank, build_template_bank
from ..models.viewpoints import camera_view_points
from ..ops.detect_core import detect_frame
from ..ops.matching import MatchConfig, MatchState, build_match_state
from ..utils.mesh_io import load_mesh
from .fixture import MODEL, OUT, load_fixture
from .timing import KERNELS, card_name, device_profile, host_ms, launches, reset_launches, shown

TOP_K = 512
SCAN_CHUNK = 4096
PREFILTER_SEL = 1024
PROFILE_CALLS = 10
HOST_CALLS = 20
# the reference's configured regime for an asymmetric part: no pruning
UNPRUNED = ModelProperties(lower_color_range=(0, 0, 50), upper_color_range=(255, 255, 255),
                           rotationally_symmetrical=False, planes_of_symmetry=(0.0, 0.0, 0.0))


def planned_templates(settings, props: ModelProperties = UNPRUNED) -> int:
    """Templates the generation renders: views of every radius x in-plane
    angles."""
    views = sum(
        len(camera_view_points(float(r), settings.subdivisions, props.rotationally_symmetrical,
                               props.planes_of_symmetry))
        for r in settings.radii
    )
    return views * len(settings.in_plane_angles)


def match_config(cam, bank: TemplateBank) -> MatchConfig:
    """The JAX script's config: top-512, 4,096-template chunks, the
    prefiltered cut over the best 1,024 templates."""
    return MatchConfig(
        width=cam.width, height=cam.height, t_fine=5 if bank.dual_modality else 2, top_k=TOP_K,
        dual_modality=bank.dual_modality, template_chunk=256, scan_chunk=SCAN_CHUNK, prefilter_sel=PREFILTER_SEL,
    )


def bigbank_state(cam, bank: TemplateBank, device) -> MatchState:
    """The match state of the bank padded to a multiple of SCAN_CHUNK."""
    return build_match_state(_pad_bank(bank, SCAN_CHUNK), match_config(cam, bank), device)


def state_device_bytes(state) -> int:
    """The nbytes of every tensor the state holds (its plan's included),
    each tensor once."""
    seen = {}

    def walk(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                seen[id(v)] = v.nbytes
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                walk(v)

    walk(state)
    return sum(seen.values())


def random_frame(cam, device, seed: int = 0) -> torch.Tensor:
    """A uniform random uint8 color frame on the device."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (cam.height, cam.width, 3), dtype=np.uint8)).to(device)


def frame_inputs(cam, bank: TemplateBank, device) -> tuple:
    """detect_frame's inputs after the state: the seed-0 random color frame,
    and for a dual bank a zero float32 depth (the JAX script's frame)."""
    color = random_frame(cam, device)
    if not bank.dual_modality:
        return (color,)
    return color, torch.zeros((cam.height, cam.width), dtype=torch.float32, device=device)


def cache_path(out_dir: str, subdiv: int, dual: bool) -> str:
    return os.path.join(out_dir, f"bigbank{'_dual' if dual else ''}_s{subdiv}.npz")


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def radius_printer(label: str, device, t0: float):
    """A generation progress callback that prints, after each radius, the
    templates so far, the seconds since t0 and the device's peak memory so
    far."""
    def progress(radius: float, templates: int) -> None:
        peak = _peak(device)
        print(f"{label}: radius {radius:.0f} mm done, {templates} templates, {time.perf_counter() - t0:.1f} s, "
              f"peak {'not measured' if peak is None else f'{peak} bytes'}", flush=True)

    return progress


def run_subdiv(subdiv: int, device, out_dir: str, dual: bool = False) -> dict:
    fx = load_fixture()
    cam = fx.cam
    settings = dataclasses.replace(fx.settings, subdivisions=subdiv, only_color_modality=not dual)
    planned = planned_templates(settings)
    path = cache_path(out_dir, subdiv, dual)
    label = f"subdiv {subdiv}{' dual' if dual else ''}"
    _peak_reset(device)
    gen_s, phases = None, None
    if os.path.exists(path) and os.path.exists(path + ".json"):
        bank = TemplateBank.load(path)
        print(f"{label}: loaded the cached bank {path}: {bank.num_templates} templates", flush=True)
    else:
        t0 = time.perf_counter()
        print(f"{label}: generating {planned} planned templates", flush=True)
        phases = {}
        bank = build_template_bank(load_mesh(MODEL), "bigbank", cam, settings, UNPRUNED, device,
                                   progress=radius_printer(label, device, t0), timings=phases)
        gen_s = time.perf_counter() - t0
        os.makedirs(out_dir, exist_ok=True)
        bank.save(path)
        print(f"{label}: generated {bank.num_templates} of {planned} planned templates in {gen_s:.1f} s "
              f"({bank.num_templates / gen_s:.1f} templates/s); seconds by phase (host clock, a device sync "
              f"after each): " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
              + f"; the scan {phases['scan'] / gen_s:.2%} of the whole", flush=True)
    gen_peak = None if gen_s is None else _peak(device)
    _peak_reset(device)
    state = bigbank_state(cam, bank, device)
    frame = frame_inputs(cam, bank, device)
    reset_launches()
    packed = detect_frame(state, *frame)
    counts = launches()
    if packed.shape[0] != TOP_K + 1:
        raise RuntimeError(f"a {state.n_templates}-template state did not take the prefiltered cut")
    exact = bool(packed[-1, 0] > 0.5)
    if device.type == "cuda":
        dev_ms, ops = device_profile(lambda: detect_frame(state, *frame), PROFILE_CALLS)
    else:
        dev_ms, ops = None, None
    sync_ms = statistics.median(host_ms(lambda: detect_frame(state, *frame).cpu(), HOST_CALLS, device))
    result = {
        "subdiv": subdiv,
        "dual_modality": dual,
        "planned_templates": planned,
        "n_templates": bank.num_templates,
        "padded_templates": state.n_templates,
        "generation_seconds": gen_s,
        "templates_per_second": None if gen_s is None else bank.num_templates / gen_s,
        "generation_phase_seconds": phases,
        "bank_disk_bytes": os.path.getsize(path),
        "match_state_device_bytes": state_device_bytes(state),
        "generation_peak_bytes": gen_peak,
        "match_peak_bytes": _peak(device),
        "device_ms_a_frame": dev_ms,
        "device_operations_a_frame": ops,
        "device_fps": None if dev_ms is None else 1e3 / dev_ms,
        "host_ms_a_sync_frame": sync_ms,
        "cut_exact": exact,
        "launches_a_frame": counts,
    }
    print(f"{label}: {state.n_templates} padded templates; bank {result['bank_disk_bytes']} bytes on disk, "
          f"state {result['match_state_device_bytes']} bytes on the device, peak {result['match_peak_bytes']} "
          f"bytes; prefiltered cut (exact {exact}): device {shown(dev_ms, '.3f')} a frame, "
          f"{shown(result['device_fps'], '.1f', ' frames/s')}, {shown(ops, '.0f', ' operations')}; host "
          f"{sync_ms:.2f} ms a synchronous frame; launches a frame 2.1 / 2.2 / 2.3 "
          + " / ".join(f"{counts[k]:g}" for k in KERNELS), flush=True)
    return result


# a row's generation numbers, kept from an earlier row when the bank was loaded from its cache
GENERATION_KEYS = ("generation_seconds", "templates_per_second", "generation_phase_seconds", "generation_peak_bytes")


def merge_rows(old: list, row: dict) -> list:
    """The rows of bank_scale.json with `row` in place of the one of its
    (subdiv, dual), sorted by (dual, subdiv); a row of a cached bank keeps
    the earlier row's generation numbers."""
    key = (row["subdiv"], bool(row["dual_modality"]))
    same = [c for c in old if (c["subdiv"], bool(c.get("dual_modality"))) == key]
    if row["generation_seconds"] is None and same and same[0].get("generation_seconds"):
        row = {**row, **{k: same[0].get(k) for k in GENERATION_KEYS}}
    rows = [c for c in old if (c["subdiv"], bool(c.get("dual_modality"))) != key] + [row]
    return sorted(rows, key=lambda c: (bool(c.get("dual_modality")), c["subdiv"]))


def run(args) -> dict:
    dev = device_from_flag(args.device)
    card = card_name(dev)
    path = os.path.join(args.out, "bank_scale.json")
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = json.load(f).get("configs", [])
    os.makedirs(args.out, exist_ok=True)
    # written after each subdiv, so a run cut in a later one keeps the rows it finished
    for s in args.subdivs:
        rows = merge_rows(rows, run_subdiv(s, dev, args.out, args.dual))
        results = {
            "tool": "bigbank_bench",
            "device": card,
            "note": ("the reference's configured regime (15 radii x icosphere views x 10 in-plane angles, symmetry "
                     "pruning off); subdiv 2 = 24,300 templates, 3 = 96,300; one row a (subdiv, dual_modality)"),
            "configs": rows,
        }
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdivs", type=int, nargs="+", default=[2, 3], help="icosphere subdivisions")
    ap.add_argument("--dual", action="store_true", help="dual-modality (color gradients + depth normals) banks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT, help="directory of the bank caches and bank_scale.json")
    args = ap.parse_args(argv)
    if min(args.subdivs) < 0:
        ap.error("--subdivs must be at least 0")
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
