"""Where the coarse kernels' time goes, on one NVIDIA GPU.

    python -m linemod_tpu_torch.tools.coarse_max_split [--kernel scan|max|both]
                                                      [--parent PATH]

Builds `csrc/similarity.cu` several ways with nvcc (all at once): as it is,
with the feature loop cut out (only the stage: plane rectangles copied into
shared memory, chunk by chunk), with the copies cut out (only the
shared-memory adds, on whatever the buffer holds), and, for the scan, with
the combine of the partial sums and the stores cut out, and with the stores
made 4-byte scalar stores. The shared body serves both kernels:

- scan (2.1, `coarse_scores`), at the shapes chip_smoke.py phase 2 checks:
  the fixture's coarse planes with its 1,950-template bank (2,048 padded),
  the large-bank rescan of the 1,024 templates the prefiltered cut selects
  on the fixture frame, a 4,096-template streaming chunk (both with the
  96,300 bank's plan cut by rows), and a 1280x960 random frame with 2,048
  synthetic templates. At each: the whole kernel at every split S it may
  take, with the clusters the card runs at once for each; at the fixture,
  each variant at the split the wrapper picks. With `--parent PATH` (the
  `similarity.cu` of an older commit, whose `coarse_scores` takes the
  triplets: one thread a cell, one global byte load a lookup), also builds
  that source and times it against the current kernel at each shape, in
  turns (old, new, new, old).
- masked max (2.3, `coarse_max`): the fixture's coarse planes with the
  96,300-template bank (the fixture bank and
  make_synthetic_bank(94350, seed=7, bbox_wh=64), 96,512 padded).

Times are `tools.timing` event ms (50 launches queued behind a sleep) and
profiler device ms, with the card's name and power limit, in turns: each
variant, then again in reverse order. Every variant that computes the whole
function must equal the plain version. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..config import load_model_properties, load_settings
from ..models.template_bank import TemplateBank, concat_banks, make_synthetic_bank
from ..ops import cuda_lib
from ..ops import similarity_cuda as sc
from ..ops.extract import downsample2
from ..ops.matching import (
    MatchConfig,
    _coarse_rows,
    _planes_3d,
    _template_maxes,
    build_match_state,
    rank_by_sim_then_index,
)
from ..pipeline.pose_detection import PoseDetection
from ..utils.png import read_png
from .timing import device_ms, event_ms

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(cuda_lib.CSRC)), "example")
# (what is cut, the source line, its replacement); the scan's own cuts
# leave the masked max as it is
CUTS = {
    "stage only": ("for (int b = fb; b < fe; b += kFlush) {",
                   "for (int b = fb; b < fb; b += kFlush) {"),
    "adds only": ("const int plane_rows = min(chunk_planes, n_planes - p0) * stage_rows;",
                  "const int plane_rows = 0;"),
}
SCAN_CUTS = {
    "no combine": ("if (w.t < 0 || gy >= ch || gx >= cw) continue;",
                   "if (true) continue;"),
    "scalar stores": ("if ((cw & 3) == 0 && gx + 8 <= cw) {  // o is 16-byte aligned",
                      "if (false) {"),
}
# the C signature of an older commit's coarse_scores: (planes, rows, stride,
# off3, n, f, ch, cw, out, stream)
_PARENT_SCAN = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
REPS = 50


def compile_texts(texts: dict, out_dir: str) -> dict:
    """name -> ctypes library of each CUDA source text, one nvcc process
    each, all started together (unbound: the caller sets argtypes)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        base = os.path.join(out_dir, name.replace(" ", "_"))
        with open(base + ".cu", "w") as f:
            f.write(text)
        procs[name] = (base + ".so", subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", base + ".so", base + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
        libs[name] = ctypes.CDLL(path)
    return libs


def build_variants(parent: str | None = None) -> dict:
    """name -> ctypes library: the kernel as it is, with each cut, and the
    parent source where given (bound with its own scan signature)."""
    src = open(os.path.join(cuda_lib.CSRC, "similarity.cu")).read()
    texts = {"whole": src}
    for name, (line, repl) in {**CUTS, **SCAN_CUTS}.items():
        if line not in src:
            raise RuntimeError(f"the kernel no longer has the line to cut for {name!r}")
        texts[name] = src.replace(line, repl)
    if parent is not None:
        texts["parent"] = open(parent).read()
    libs = compile_texts(texts, os.path.join(cuda_lib.BUILD_DIR, "split"))
    for name, lib in libs.items():
        signatures = {"coarse_scores": _PARENT_SCAN} if name == "parent" else sc._SIGNATURES
        for fn in ("coarse_scores", "coarse_max"):
            if fn in signatures:
                getattr(lib, fn).argtypes = signatures[fn]
                getattr(lib, fn).restype = ctypes.c_int
    return libs


def in_turns(runs: dict) -> dict:
    """name -> [(event ms, device ms) of the first turn, of the second]:
    each run in order, then in reverse order."""
    times = {name: [] for name in runs}
    for name in list(runs) + list(reversed(list(runs))):
        times[name].append((event_ms(runs[name], REPS), device_ms(runs[name], REPS)))
    return times


def show(times: dict) -> None:
    for name, turns in times.items():
        text = " / ".join(f"{ev:.4f} ms ({'not measured' if dv is None else f'{dv:.4f}'} device)"
                          for ev, dv in turns)
        print(f"  {name}: {text}  (first / second turn)")


def fixture_states(dev, big: bool):
    """(the fixture's detector, the 96,300-bank detector or None, the
    frame's coarse planes for each, the recentred frame as float color)."""
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    dets = [PoseDetection(bank, cam, settings, props, dev)]
    if big:
        big_bank, _ = concat_banks([bank, make_synthetic_bank(94350, seed=7, bbox_wh=64, image_wh=(640, 480))])
        dets.append(PoseDetection(big_bank, cam, settings, props, dev))
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    colorf = torch.from_numpy(dets[0].recenter(np.ascontiguousarray(color))).to(dev).float()
    planes = [_planes_3d(downsample2(colorf), d.state.cfg.t_coarse, d.state.max_cells_coarse) for d in dets]
    return dets[0], dets[1] if big else None, planes[0], planes[-1], colorf


def synthetic_1280(dev):
    """(state, float color frame): 2,048 synthetic templates with 64 px
    boxes and a random 1280x960 frame, seed 7."""
    state = build_match_state(make_synthetic_bank(2048, seed=7, bbox_wh=64, image_wh=(1280, 960)),
                              MatchConfig(width=1280, height=960), dev)
    color = np.random.default_rng(7).integers(0, 256, (960, 1280, 3)).astype(np.float32)
    return state, torch.from_numpy(color).to(dev)


def scan_cases(dev, state, planes, big_state, big_planes, syn, syn_color) -> dict:
    """label -> (planes, state): the scan at the shapes its paths give it:
    the fixture's state, the rescan of the templates the prefiltered cut
    selects on the frame and a streaming chunk of the large bank (both
    with its plan cut by rows), and synthetic_1280."""
    cfg = big_state.cfg
    n = big_state.off3_coarse.shape[0]
    n_sel = min(max(cfg.prefilter_sel, cfg.top_k), n)
    _, sel = rank_by_sim_then_index(_template_maxes(big_state, big_planes), torch.arange(n, device=dev), n_sel)
    chunk = slice(cfg.scan_chunk, 2 * cfg.scan_chunk)
    return {
        f"fixture, {state.off3_coarse.shape[0]}": (planes, state),
        f"rescan, {n_sel} (plan cut by rows)": (big_planes, _coarse_rows(big_state, torch.sort(sel).values)),
        f"streaming chunk, {cfg.scan_chunk} (plan cut by rows)": (big_planes, _coarse_rows(big_state, chunk)),
        "1280x960, 2048": (_planes_3d(downsample2(syn_color), syn.cfg.t_coarse, syn.max_cells_coarse), syn),
    }


def scan_split(libs, dev, cases: dict, parent: bool) -> None:
    def launcher(name, planes, st, split=None):
        ch, cw = st.coarse_shape[:2]
        n, f = st.off3_coarse.shape[:2]
        plan = st.coarse_plan
        split = sc.coarse_split(plan, dev) if split is None else split
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            out = torch.empty((n, ch, cw), dtype=torch.int32, device=dev)
            if name == "parent":
                err = libs[name].coarse_scores(planes.data_ptr(), planes.shape[1], planes.shape[2],
                                               st.off3_coarse.data_ptr(), n, f, ch, cw, out.data_ptr(), stream)
            else:
                err = libs[name].coarse_scores(
                    planes.data_ptr(), planes.shape[1], planes.shape[2], plan.feat.data_ptr(),
                    plan.starts.data_ptr(), n, f, ch, cw, sc._GEOMETRY(*plan.geometry), split,
                    out.data_ptr(), stream)
            cuda_lib.check_launch(name, err)
            return out

        return launch

    for label, (planes, st) in cases.items():
        plan = st.coarse_plan
        ch, cw = st.coarse_shape[:2]
        want = sc.coarse_scores_plain(planes, st.off3_coarse, ch, cw)
        picked = sc.coarse_split(plan, dev)
        splits = range(1, min(sc.MAX_SPLIT, plan.chunks) + 1)
        smem = plan.scan_smem()
        runs = {"whole": launcher("whole", planes, st), "scalar stores": launcher("scalar stores", planes, st)}
        runs.update({f"S={s}": launcher("whole", planes, st, s) for s in splits})
        if parent:
            runs["parent"] = launcher("parent", planes, st)
        for name, run in runs.items():
            if not torch.equal(run(), want):
                raise SystemExit(f"coarse_max_split: the {name!r} scan at {label} differs from coarse_scores_plain")
        group, staged = plan.staged_bytes(sc.SCAN_UNITS_PER_BLOCK)
        groups = plan.groups(sc.SCAN_UNITS_PER_BLOCK)
        print(f"scan, {label}: planes {tuple(planes.shape)} x {st.off3_coarse.shape[0]} templates, grid "
              f"{ch}x{cw}: {groups} groups of {sc.SCAN_UNITS_PER_BLOCK} templates of one of "
              f"{plan.row_bands * plan.col_bands} bands, {plan.chunks} chunks of {plan.chunk_planes} planes, {group} B staged a group, "
              f"{staged} B in all; {smem} B of shared memory a block; clusters the card runs at once by S: "
              f"{ {s: sc.active_clusters(dev, s, smem) for s in splits} }; the wrapper's S = {picked} "
              f"({groups * picked} blocks)")
        if parent:
            print("  the older commit's kernel against this one, in turns (old, new, new, old):")
            show(in_turns({"parent": runs["parent"], "whole": runs["whole"]}))
        if label.startswith("fixture"):
            print(f"  the variants at S = {picked}:")
            show(in_turns({"whole": runs["whole"],
                           **{name: launcher(name, planes, st) for name in [*CUTS, *SCAN_CUTS]}}))
        print("  the whole kernel at every split:")
        show(in_turns({f"S={s}": runs[f"S={s}"] for s in splits}))


def max_split(libs, dev, det_big, planes) -> None:
    st, plan = det_big.state, det_big.state.coarse_plan
    ch, cw = st.coarse_shape[:2]
    n, f = st.off3_coarse.shape[:2]

    def launch(name):
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        err = libs[name].coarse_max(
            planes.data_ptr(), planes.shape[1], planes.shape[2], plan.feat.data_ptr(),
            plan.starts.data_ptr(), st.lim_coarse.data_ptr(), n, f, ch, cw,
            sc._GEOMETRY(*plan.geometry), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        cuda_lib.check_launch(name, err)
        return out

    want = sc.coarse_max_plain(planes, st.off3_coarse, st.lim_coarse, ch, cw)
    if not torch.equal(launch("whole"), want):
        raise SystemExit("coarse_max_split: the whole kernel differs from coarse_max_plain")
    times = in_turns({name: (lambda name=name: launch(name)) for name in ["whole", *CUTS]})
    group, staged = plan.staged_bytes()
    # each staged row is read as 16-byte loads, which L2 serves as 32-byte sectors
    row_bytes = -(-16 * -(-plan.pitch // 4) // 32) * 32
    sectors = staged // (4 * plan.pitch) * row_bytes
    print(f"coarse_max at planes {tuple(planes.shape)} x {n} templates: {plan.chunks} chunks of "
          f"{plan.chunk_planes} planes, {group} B staged a group, {staged} B in all "
          f"({sectors} B of 32-byte sectors)")
    show(times)
    stage_ms = min(ev for ev, _ in times["stage only"])
    print(f"  stage rate: {staged / stage_ms / 1e9:.3f} TB/s staged, {sectors / stage_ms / 1e9:.3f} TB/s of sectors")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("scan", "max", "both"), default="both")
    ap.add_argument("--parent", help="similarity.cu of an older commit, timed against the scan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coarse_max_split: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    libs = build_variants(args.parent)
    det, det_big, planes, big_planes, _ = fixture_states(dev, big=True)
    print(card)
    if args.kernel in ("scan", "both"):
        cases = scan_cases(dev, det.state, planes, det_big.state, big_planes, *synthetic_1280(dev))
        scan_split(libs, dev, cases, args.parent is not None)
    if args.kernel in ("max", "both"):
        max_split(libs, dev, det_big, big_planes)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
