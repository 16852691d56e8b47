"""The ICP leg's cost on one card (counterpart of `scripts/profile_icp.py`
and `scripts/profile_icp2.py`).

    python -m linemod_tpu_torch.tools.profile_icp [--device cuda] [--frames 30] [--reps 5]

On the fixture frame with `use icp` on (an IcpRefiner at the settings'
`icp_subsampling_factor`, with the mesh's render buffers), the frame's
grouped candidate poses (what its collection refines) and, from the
profiler, the device busy ms and device operations a call of:

- the whole chain, `IcpRefiner.refine_submit` over every group: the scene
  cloud, the 16 iterations and the verify render and score;
- the scene cloud of the first group's box alone;
- the 16 iterations of the first group's poses (padded to a power of two)
  against that cloud alone;
- the verify render and score of the refined poses in the group's window
  alone.

Then the ICP-on `detect_stream` rate: one warm `detect`, an untimed stream
of 10 frames, three timed streams of `--frames` (each printed, and the
median), with the kernels' launches a frame. On the CPU the stages print
host ms (median of `--reps`) and no device numbers. The last line is a JSON
object of the numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..cli import device_from_flag
from ..ops.depth3d import scene_cloud_from_depth
from ..ops.icp import VERIFY_WINDOW, IcpRefiner, _pose_arrays, _pow2, icp_refine_batch
from ..ops.rasterizer import mesh_to_arrays
from ..pipeline.pose_detection import PoseDetection, group_candidate_poses
from ..utils.ply import load_ply
from .fixture import MODEL, load_fixture
from .timing import card_name, launches, profile_call, reset_launches, shown

N = 30
REPS = 5
WARM = 10
STREAMS = 3


def frame_groups(det: PoseDetection, color: np.ndarray, depth: np.ndarray) -> tuple[list, np.ndarray]:
    """(the frame's grouped candidate poses, the recentred depth): what the
    detector's collection hands to ICP."""
    packed, color_c, depth_c = det.detect_submit(color, depth)
    packed = packed.cpu().numpy()
    valid = packed[:, 4] > 0.5
    groups = group_candidate_poses(
        packed[valid, 0].astype(np.int64), packed[valid, 1], packed[valid, 2], det.bank, det.props, det.settings,
        det.cam, color_c, depth_c, {},
    )
    return groups, depth_c


def run(args) -> dict:
    dev = device_from_flag(args.device)
    card = card_name(dev)
    fx = load_fixture()
    cam = fx.cam
    mesh = load_ply(MODEL)
    icp = IcpRefiner(mesh, cam, fx.settings.icp_subsampling_factor, mesh_arrays=mesh_to_arrays(mesh, dev))
    det = PoseDetection(fx.bank, cam, fx.icp_settings, fx.props, dev, mesh=mesh, icp=icp)
    det.detect(fx.color, fx.depth, 1)
    groups, depth_c = frame_groups(det, fx.color, fx.depth)
    if not groups:
        raise RuntimeError("the fixture frame gave no group to refine")
    depth_t = torch.from_numpy(depth_c.astype(np.float32)).to(dev)
    bbox = tuple(int(v) for v in groups[0][0].bounding_box)
    pad = _pow2(len(groups[0]))
    rots, trans = (torch.from_numpy(a).to(dev) for a in _pose_arrays(groups[0], pad))
    cloud = scene_cloud_from_depth(depth_t, bbox, fx=cam.fx, fy=cam.fy, cx=cam.width / 2.0, cy=cam.height / 2.0)

    def iterations():
        return icp_refine_batch(icp.model_pts, *cloud, rots, trans, iterations=icp.iterations,
                                model_nrm=icp.model_nrm, tolerance=icp.tolerance,
                                rejection_scale=icp.rejection_scale)

    r, t, _ = iterations()
    vw = min(VERIFY_WINDOW, cam.width, cam.height)
    crop, origin = icp.verify_window(F.pad(depth_t, (0, vw, 0, vw)), bbox)
    stages = {
        "chain (refine_submit: cloud, iterations, verify)": lambda: icp.refine_submit(depth_c, groups),
        "scene cloud": lambda: scene_cloud_from_depth(depth_t, bbox, fx=cam.fx, fy=cam.fy, cx=cam.width / 2.0,
                                                      cy=cam.height / 2.0),
        f"{icp.iterations} iterations": iterations,
        "verify render and score": lambda: icp._verify(r, t, crop, origin, (vw, vw)),
    }
    print(f"profile_icp: {len(groups)} group(s) of {[len(g) for g in groups]} pose(s) (padded to {pad}), "
          f"{icp.model_pts.shape[0]} model points, {int(cloud[2].sum())} valid scene points; {card}")
    numbers = {}
    for label, fn in stages.items():
        numbers[label] = profile_call(fn, args.reps, dev)
        row = numbers[label]
        print(f"  {label:50s} device {shown(row['device_ms'], '.3f')}, operations "
              f"{shown(row['operations'], '.0f', '')}, host {shown(row['host_ms'], '.2f')}", flush=True)

    det.detect(fx.color, fx.depth, 1)
    for _ in det.detect_stream((fx.color, fx.depth) for _ in range(WARM)):
        pass
    reset_launches()
    rates = []
    for _ in range(STREAMS):
        t0 = time.perf_counter()
        n = sum(1 for _ in det.detect_stream((fx.color, fx.depth) for _ in range(args.frames)))
        rates.append(n / (time.perf_counter() - t0))
        print(f"  ICP-on detect_stream: {rates[-1]:.2f} frames/s", flush=True)
    counts = launches(STREAMS * args.frames)
    fps = statistics.median(rates)
    print(f"  ICP-on detect_stream median {fps:.3f} frames/s over {STREAMS} streams of {args.frames}; launches a "
          f"frame 2.1 / 2.2 / 2.3 {counts['coarse_scores']:g} / {counts['fine_scores']:g} / "
          f"{counts['coarse_max']:g}", flush=True)
    return {"tool": "profile_icp", "device": card, "groups": [len(g) for g in groups], "stages": numbers,
            "stream_fps": rates, "stream_fps_median": fps, "launches_a_frame": counts}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=N, help="frames a timed stream")
    ap.add_argument("--reps", type=int, default=REPS, help="calls each stage is profiled over")
    args = ap.parse_args(argv)
    if min(args.frames, args.reps) < 1:
        ap.error("--frames and --reps must be at least 1")
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
