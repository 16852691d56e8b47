"""The synthetic accuracy protocol on the port (counterpart of
`scripts/accuracy_eval.py`).

Runs the reference's running-score evaluation (src/Benchmark.cpp:11-16,
247-251) over the synthetic sequence with exact ground truth
(pipeline/synth_eval.py): detection rate, VSD / ADD-S pass rates at the
reference criteria (VSD < 0.3, src/Benchmark.cpp:33; ADD <= 21 mm,
include/Benchmark.h:105), translation and rotation error statistics, and a
failure taxonomy, per corruption mode. The JSON has the JAX script's schema.

    python -m linemod_tpu_torch.tools.accuracy_eval [--frames-per-mode 30] \\
        [--seed 0] [--out build/accuracy/accuracy_torch.json] [--icp] \\
        [--diagnostics] [--device cuda]

`--device` defaults to the card; `--device cpu` runs the kernels' plain
versions. `--diagnostics` builds the radius-step-25 bank on the device once
and caches it at DENSE_BANK (under the gitignored `build/`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..cli import device_from_flag
from ..config import load_model_properties, load_settings
from ..models.template_bank import TemplateBank, build_template_bank
from ..ops.icp import IcpRefiner
from ..ops.metrics import OBJECT_DIAMETER, VSD_CORRECT
from ..ops.rasterizer import mesh_to_arrays
from ..pipeline.benchmark import Benchmark
from ..pipeline.pose_detection import PoseDetection
from ..pipeline.synth_eval import MODES, SyntheticEvalSet, eval_camera
from ..utils.geometry import quat_to_mat
from ..utils.ply import load_ply
from ..utils.profiling import maybe_stage

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLE = os.path.join(REPO, "example")
OUT = os.path.join(REPO, "build", "accuracy", "accuracy_torch.json")
DENSE_BANK = os.path.join(REPO, "build", "accuracy", "dense_eval_bank.npz")
COUNTS = ("frames", "detected", "vsd_pass", "adds_pass", "both_pass")


def rotation_err_deg(q_gt, q_est) -> float:
    r = quat_to_mat(q_gt).T @ quat_to_mat(q_est)
    c = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


@dataclasses.dataclass
class Protocol:
    """The fixture model, its bank and the frame generator on one device."""

    cam0: object
    cam: object
    settings: object
    bank: TemplateBank
    props: object
    mesh: object
    gen: SyntheticEvalSet
    bench: Benchmark
    device: torch.device

    @staticmethod
    def load(device, seed: int = 0) -> "Protocol":
        dev = torch.device(device)
        cam0, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
        bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
        model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
        mesh = load_ply(model)
        cam = eval_camera(cam0)
        return Protocol(cam0, cam, settings, bank, load_model_properties(model), mesh,
                        SyntheticEvalSet(mesh, bank, cam0, seed=seed, device=dev), Benchmark(mesh, cam, dev), dev)

    def detector(self, bank=None, settings=None) -> PoseDetection:
        """A PoseDetection of the eval camera (the shipped settings unless
        given); settings with `use_icp` give it an IcpRefiner."""
        s = self.settings if settings is None else settings
        icp = None
        if s.use_icp:
            icp = IcpRefiner(self.mesh, self.cam, s.icp_subsampling_factor,
                             mesh_arrays=mesh_to_arrays(self.mesh, self.device))
        return PoseDetection(self.bank if bank is None else bank, self.cam, s, self.props, self.device,
                             mesh=self.mesh if icp else None, icp=icp)

    def run_frame(self, det: PoseDetection, index: int, mode: str, timer=None) -> dict:
        """One frame: synthesis, detect, and VSD / ADD-S of the first pose
        (timed as stages when a StageTimer is given)."""
        with maybe_stage(timer, "synthesis"):
            color, depth, gt, meta = self.gen.make_frame(index, mode)
        with maybe_stage(timer, "detect"):
            poses = det.detect(color, depth, 1)
        rec = {"frame": index, "color": color, "depth": depth, "gt": gt, "meta": meta,
               "pose": poses[0] if poses else None}
        if poses:
            with maybe_stage(timer, "scoring"):
                rec["vsd"] = self.bench.score_vsd(depth.astype(np.float32), gt, poses[0])
                rec["adds"] = self.bench.score_adds(gt, poses[0])
        return rec


def mode_stats(records: list) -> dict:
    """The JAX script's per-mode statistics of a mode's frame records."""
    stats = {"frames": 0, "detected": 0, "vsd_pass": 0, "adds_pass": 0,
             "both_pass": 0, "vsd": [], "adds": [], "t_err_mm": [],
             "rot_err_deg": [], "taxonomy": {"no_detection": 0, "vsd_fail": 0,
                                             "adds_fail": 0, "both_fail": 0}}
    stats["missed_frames"] = []
    for rec in records:
        stats["frames"] += 1
        gt, est = rec["gt"], rec["pose"]
        if est is None:
            stats["taxonomy"]["no_detection"] += 1
            stats["missed_frames"].append(
                {"frame": rec["frame"], "gt_z_mm": round(float(gt.translation[2]), 1)}
            )
            continue
        stats["detected"] += 1
        ok_v = rec["vsd"] < VSD_CORRECT
        ok_a = rec["adds"] <= OBJECT_DIAMETER
        stats["vsd"].append(round(float(rec["vsd"]), 4))
        stats["adds"].append(round(float(rec["adds"]), 2))
        stats["t_err_mm"].append(
            round(float(np.linalg.norm(est.translation - gt.translation)), 2)
        )
        stats["rot_err_deg"].append(
            round(rotation_err_deg(gt.quaternion, est.quaternion), 2)
        )
        stats["vsd_pass"] += int(ok_v)
        stats["adds_pass"] += int(ok_a)
        stats["both_pass"] += int(ok_v and ok_a)
        if not ok_v and not ok_a:
            stats["taxonomy"]["both_fail"] += 1
        elif not ok_v:
            stats["taxonomy"]["vsd_fail"] += 1
        elif not ok_a:
            stats["taxonomy"]["adds_fail"] += 1
    stats["median_t_err_mm"] = (
        float(np.median(stats["t_err_mm"])) if stats["t_err_mm"] else None
    )
    stats["median_rot_err_deg"] = (
        float(np.median(stats["rot_err_deg"])) if stats["rot_err_deg"] else None
    )
    return stats


def mode_settings(settings, mode: str, **replace):
    """The shipped settings for a mode: the clean mode models an uncorrupted
    sensor, so its sensor-compensation offset (`depth offset: 30`, tuned for
    the shiny fixture capture) is zeroed."""
    offset = 0.0 if mode == "clean" else settings.depth_offset
    return dataclasses.replace(settings, depth_offset=offset, **replace)


def totals(results: dict, labels) -> dict:
    total = {k: sum(results["modes"][m][k] for m in labels) for k in COUNTS}
    for k in ("detected", "vsd_pass", "adds_pass", "both_pass"):
        name = "detection_rate_pct" if k == "detected" else f"{k}_pct"
        total[name] = round(100.0 * total[k] / max(total["frames"], 1), 1)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="linemod_tpu_torch.tools.accuracy_eval")
    ap.add_argument("--frames-per-mode", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument(
        "--diagnostics", "--dense-check", dest="diagnostics", action="store_true",
        help="run the miss-cause ablations (jitter zeroing + radius-step-25 "
             "bank) on the shiny-mode frames; appends a diagnostics section",
    )
    ap.add_argument(
        "--icp", action="store_true",
        help="additionally evaluate ICP-on variants: clean_icp and shiny_icp "
             "(not in the totals: the shipped config has 'use icp: 0')",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = device_from_flag(args.device)

    proto = Protocol.load(dev, args.seed)
    n = args.frames_per_mode
    results = {
        "criteria": {"vsd_correct": VSD_CORRECT, "add_threshold_mm": OBJECT_DIAMETER,
                     "metric": "ADD-S (rotationally symmetric model)"},
        "seed": args.seed,
        "frames_per_mode": n,
        "failure_analysis": (
            "Misses are listed per mode under missed_frames; --diagnostics "
            "adds the miss-cause ablations (jitter zeroing, radius-step-25 bank)."
        ),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "modes": {},
    }

    def eval_mode(det, label, gen_mode):
        stats = mode_stats([proto.run_frame(det, i, gen_mode) for i in range(n)])
        results["modes"][label] = stats
        print(
            f"{label}: {stats['detected']}/{stats['frames']} detected, "
            f"VSD pass {stats['vsd_pass']}, ADD-S pass {stats['adds_pass']}, "
            f"both {stats['both_pass']}"
        )

    # one detector for the four modes: it reads its settings at collect time
    det = proto.detector()
    for mode in MODES:
        det.settings = mode_settings(proto.settings, mode)
        eval_mode(det, mode, mode)
    if args.icp:
        # ICP-on rows, not in the headline totals: clean_icp should tighten
        # the pose on an honest sensor; shiny_icp registers to the +40 mm
        # corrupted surface
        for label, gen_mode in (("clean_icp", "clean"), ("shiny_icp", "shiny")):
            icp_det = proto.detector(settings=mode_settings(proto.settings, gen_mode, use_icp=True))
            eval_mode(icp_det, label, gen_mode)
    results["total"] = totals(results, MODES)

    if args.diagnostics:
        det.settings = proto.settings
        diag = {"note": (
            "Miss-cause ablations on the shiny set (shipped bank unless "
            "stated). Zeroing one jitter keeps every other random draw of a "
            "frame identical (the rng stream is preserved), so each row "
            "isolates one GT-pose degree of freedom."
        )}

        def detect_rate(d, **kw):
            hits = 0
            for i in range(n):
                color, depth, _, _ = proto.gen.make_frame(i, "shiny", **kw)
                hits += bool(d.detect(color, depth, 1))
            return hits

        diag["baseline_detected"] = detect_rate(det)
        diag["no_view_jitter_detected"] = detect_rate(det, view_jitter_deg=0.0)
        diag["no_inplane_jitter_detected"] = detect_rate(det, inplane_jitter_deg=0.0)
        dense_settings = dataclasses.replace(proto.settings, distance_step=25)
        if os.path.exists(DENSE_BANK):
            dense_bank = TemplateBank.load(DENSE_BANK)
        else:
            dense_bank = build_template_bank(proto.mesh, "lagergehaeuse_dense", proto.cam0, dense_settings,
                                             proto.props, dev)
            os.makedirs(os.path.dirname(DENSE_BANK), exist_ok=True)
            dense_bank.save(DENSE_BANK)
        diag["radius_step25_bank_detected"] = detect_rate(proto.detector(dense_bank, dense_settings))
        diag["frames"] = n
        results["diagnostics"] = diag
        print("diagnostics:", {k: v for k, v in diag.items() if k != "note"})

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}: {results['total']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
