"""Host ms a frame of the detector and its device stages on one card
(counterpart of `scripts/profile_detect.py`).

    python -m linemod_tpu_torch.tools.profile_detect [--device cuda] [--frames 30]

On the fixture frame with the committed bank, each row runs `--frames`
calls back to back after a warm call and ends with
`torch.cuda.synchronize()`, timed on the host clock (ms a frame):

- the device stages on a frame already on the card: the coarse planes only,
  the coarse planes and the scan (kernel 2.1), the fine planes only, the
  full match, and `detect_frame` (the whole per-frame program);
- the upload of one recentred frame;
- synchronous `PoseDetection.detect` (upload, program, copy back, host
  post-processing, one frame at a time);
- `detect_stream` (frames submitted ahead of the one collected).

Rows of device stages queued back to back are bound by the host's launch
rate where a call makes more launches than the driver's queue holds. The
last line is a JSON object of the rows and the kernels' launches a frame
of the stream.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..cli import device_from_flag
from ..ops.similarity_cuda import coarse_scores
from ..ops.detect_core import detect_frame
from ..ops.extract import downsample2
from ..ops.matching import _planes_3d, match_templates
from ..pipeline.pose_detection import PoseDetection
from .fixture import load_fixture
from .timing import card_name, launches, reset_launches, sync

N = 30


def pipelined_ms(fn, frames: int, device) -> float:
    """Host ms a call of `frames` calls queued back to back after a warm
    call, ended by a sync."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / frames * 1e3


def run(args) -> dict:
    dev = device_from_flag(args.device)
    card = card_name(dev)
    fx = load_fixture()
    det = PoseDetection(fx.bank, fx.cam, fx.settings, fx.props, dev)
    state, cfg = det.state, det.state.cfg
    color_c = det.recenter(np.ascontiguousarray(fx.color))
    depth_c = det.recenter(np.ascontiguousarray(fx.depth))
    color_u8, _ = det.upload(color_c, depth_c)
    colorf = color_u8.float()
    print(f"profile_detect: {fx.bank.num_templates} templates, {args.frames} frames a row; {card}")

    def coarse_planes():
        return _planes_3d(downsample2(colorf), cfg.t_coarse, state.max_cells_coarse)

    rows = {
        "coarse planes": coarse_planes,
        "coarse planes + scan (2.1)": lambda: coarse_scores(
            coarse_planes(), state.off3_coarse, state.coarse_shape[0], state.coarse_shape[1], plan=state.coarse_plan),
        "fine planes": lambda: _planes_3d(colorf, cfg.t_fine, state.max_cells_fine),
        "full match (planes, scan, cut, fine)": lambda: match_templates(state, colorf),
        "detect_frame (the device program)": lambda: detect_frame(state, color_u8),
        "upload (recentred frame to the card)": lambda: det.upload(color_c, depth_c),
        "detect (synchronous)": lambda: det.detect(fx.color, fx.depth, 1),
    }
    ms = {}
    for label, fn in rows.items():
        ms[label] = pipelined_ms(fn, args.frames, dev)
        print(f"  {label:40s} {ms[label]:9.3f} ms a frame", flush=True)
    reset_launches()
    t0 = time.perf_counter()
    n = sum(1 for _ in det.detect_stream((fx.color, fx.depth) for _ in range(args.frames)))
    ms["detect_stream"] = (time.perf_counter() - t0) / n * 1e3
    counts = launches(n)
    print(f"  {'detect_stream':40s} {ms['detect_stream']:9.3f} ms a frame ({1e3 / ms['detect_stream']:.2f} "
          f"frames/s); launches a frame 2.1 / 2.2 / 2.3 {counts['coarse_scores']:g} / "
          f"{counts['fine_scores']:g} / {counts['coarse_max']:g}", flush=True)
    return {"tool": "profile_detect", "device": card, "frames": args.frames, "ms_a_frame": ms,
            "launches_a_frame": counts}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=N, help="calls a row")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be at least 1")
    return args


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
