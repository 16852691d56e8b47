"""Multi-class detection's frame rate on one card (counterpart of
`scripts/profile_multimodel.py`).

    python -m linemod_tpu_torch.tools.profile_multimodel [--device cuda] [--frames 30] [--out build/bench]

`MultiModelPoseDetection.detect_all` on the fixture frame with 1, 2 and 3
classes, each a copy of the committed 1,950-template bank under its own
class id: shape-identical to as many models of the same template count,
which is what the time depends on. The frame's response planes are made
once and every class's templates scan them, so a class costs its share of
the scan and the cut, not a second planes pass.

For each class count: the synchronous rate (`detect_all`, one frame at a
time) and the stream rate (`detect_all_stream`), each the median of 3
rounds of `--frames` frames, the variants interleaved round by round so
that a drift of the host's clock reaches each of them; the detections a
class; the kernels' launches a frame. Writes `<out>/multimodel_perf.json`
(never the root MULTIMODEL_PERF.json, the JAX package's) and prints it as
its last line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

from ..cli import device_from_flag
from ..pipeline.multi_model import MultiModelPoseDetection
from .fixture import OUT, load_fixture
from .timing import KERNELS, card_name, launches, reset_launches

N_FRAMES = 30
REPEATS = 3
CLASS_COUNTS = (1, 2, 3)


def class_copies(bank, n_classes: int) -> dict:
    """{class id: bank}: n_classes copies of `bank`, the first under its own
    id and the others under `<id>_<i>`."""
    banks = {}
    for i in range(n_classes):
        b = copy.copy(bank)
        b.class_id = bank.class_id if i == 0 else f"{bank.class_id}_{i}"
        banks[b.class_id] = b
    return banks


def multi_detector(bank, n_classes: int, cam, settings, props, device) -> MultiModelPoseDetection:
    banks = class_copies(bank, n_classes)
    return MultiModelPoseDetection(banks, cam, settings, dict.fromkeys(banks, props), device)


def poses_per_class(det: MultiModelPoseDetection, color, depth) -> dict:
    return {c: len(p) for c, p in det.detect_all(color, depth).items()}


def run(args) -> dict:
    dev = device_from_flag(args.device)
    card = card_name(dev)
    fx = load_fixture()
    frame = (fx.color, fx.depth)
    dets = {}
    for n in CLASS_COUNTS:
        dets[n] = multi_detector(fx.bank, n, fx.cam, fx.settings, fx.props, dev)
        dets[n].detect_all(*frame)
        for _ in dets[n].detect_all_stream([frame] * 10):
            pass
    variants = {}
    for n in CLASS_COUNTS:
        variants[f"c{n}_sync"] = lambda k, d=dets[n]: [d.detect_all(*frame) for _ in range(k)]
        variants[f"c{n}_stream"] = lambda k, d=dets[n]: list(d.detect_all_stream([frame] * k))
    rates = {k: [] for k in variants}
    counts = {}
    for _ in range(REPEATS):
        for k, fn in variants.items():
            reset_launches()
            t0 = time.perf_counter()
            fn(args.frames)
            rates[k].append(args.frames / (time.perf_counter() - t0))
            counts[k] = launches(args.frames)
    med = {k: statistics.median(v) for k, v in rates.items()}
    results = {
        "tool": "profile_multimodel",
        "device": card,
        "note": (f"median of {REPEATS} interleaved rounds of {args.frames} frames; sync = detect_all one frame at "
                 "a time, stream = detect_all_stream; classes are copies of the 1,950-template fixture bank"),
        "multi": [],
    }
    for n in CLASS_COUNTS:
        poses = poses_per_class(dets[n], *frame)
        results["multi"].append({
            "n_classes": n, "total_templates": fx.bank.num_templates * n,
            "detect_all_fps": med[f"c{n}_sync"], "detect_all_stream_fps": med[f"c{n}_stream"],
            "poses_per_class": poses, "launches_a_frame": counts[f"c{n}_stream"],
        })
        print(f"  {n} class(es), {fx.bank.num_templates * n} templates: detect_all {med[f'c{n}_sync']:.2f} "
              f"frames/s, stream {med[f'c{n}_stream']:.2f} frames/s; poses a class {poses}; launches a frame "
              f"2.1 / 2.2 / 2.3 " + " / ".join(f"{counts[f'c{n}_stream'][k]:g}" for k in KERNELS) + f" ({card})",
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "multimodel_perf.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=N_FRAMES, help="frames a timed round")
    ap.add_argument("--out", default=OUT, help="directory of multimodel_perf.json")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be at least 1")
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
