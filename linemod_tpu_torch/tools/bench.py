"""The port's one-line benchmark (counterpart of `bench.py`).

    python -m linemod_tpu_torch.tools.bench [--device cuda] [--frames 30] \\
        [--repeats 10] [--warm 10] [--out build/bench]

Runs the port's detector on the benchmark frame (`example/benchmark/
img0.png`, the committed 1,950-template bank, the shipped color-only
settings) and prints, last, one JSON line with bench.py's keys:

- `metric`: `detector_fps_per_chip`, suffixed `_ACCURACY_FAIL` when the
  gate fails (no pose, VSD >= 0.3 or ADD > 21 mm against `pose0.yml`);
- `value`: the headline, `detect_stream` frames/s: the median of
  `--repeats` streams of `--frames` frames, pooled from bursts spread over
  the run, each burst after an untimed stream of `--warm` frames;
- `vs_baseline`: the headline over the port's own pipeline on the host's
  CPU (`--cpu-worker`, a subprocess with `--device cpu`: one warm
  `detect`, one timed stream of `--frames` frames), cached in
  `<out>/baseline_cpu.json` for the same frames, host and torch;
- `disk_to_pose_fps`: the stream read from a `%d` PNG sequence (the
  fixture's two files copied byte for byte `--frames` times) through
  `cli._frame_source`'s prefetching loader, median of 3 passes;
- `device_fps`, `dual_device_fps`: 1,000 over the profiler's device busy
  ms of one `detect_frame` call on frames already on the card (not CUDA
  events around queued frames, which would time the host's enqueue); null
  on the CPU, where nothing was measured on a device;
- `host_post_ms`: `detect_collect` of a packed array already on the host,
  the mean of 50 calls after a warm one;
- `icp_fps`, `dual_fps`: the stream rate (one warm `detect`, an untimed
  stream of `--warm`, the median of 3 streams of `--frames`) with `use icp`
  on and with the committed dual-modality bank (`example/banks_dual/`);
- `device`: the card's name and power limit (nvidia-smi), or "cpu".

The line before it is `{"detail": ...}`: the gate's pose count, VSD and
ADD, the headline samples' count and quartiles (host clocks swing between
calls), the kernels' launches a frame on the headline streams, the device
ms and operations of the frame programs, and the CPU baseline's rate.

Nothing is caught: a variant that raises ends the run with a non-zero exit
and no result line. A missing committed bank raises; the bench never
generates one. It writes nothing but its stdout and `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..cli import _frame_source, device_from_flag
from ..ops.detect_core import detect_frame
from ..ops.icp import IcpRefiner
from ..ops.metrics import OBJECT_DIAMETER, VSD_CORRECT
from ..ops.rasterizer import mesh_to_arrays
from ..pipeline.benchmark import Benchmark, read_ground_truth_pose
from ..pipeline.pose_detection import PoseDetection
from ..utils.ply import load_ply
from .fixture import DEPTH0, DUAL_BANK, IMG0, MODEL, OUT, POSE0, REPO, Fixture, load_bank, load_fixture
from .timing import KERNELS, card_name, device_profile, launches, reset_launches

FRAMES = 30
# the headline's samples, pooled from bursts spread across the run (host
# clocks swing between phases of a run, as bench.py's remote link did)
REPEATS = 10
WARM = 10  # untimed frames streamed before each timed burst
PASSES = 3  # the variants' timed streams (median)
HOST_POST_CALLS = 50
PROFILE_CALLS = 10  # detect_frame calls the device time is taken over
RESULT_KEYS = ("metric", "value", "unit", "vs_baseline", "disk_to_pose_fps", "device_fps", "host_post_ms",
               "icp_fps", "dual_fps", "dual_device_fps", "device")


def _frames(fx: Fixture, n: int):
    return ((fx.color, fx.depth) for _ in range(n))


def _stream(det: PoseDetection, frames) -> tuple[int, float]:
    """(frames detected, seconds) of one detect_stream over `frames`."""
    t0 = time.perf_counter()
    n = sum(1 for _ in det.detect_stream(frames))
    return n, time.perf_counter() - t0


class Headline:
    """The headline's samples (seconds a frame of each timed stream) and the
    kernels' launches over them."""

    def __init__(self, det: PoseDetection, fx: Fixture, frames: int, warm: int):
        self.det, self.fx, self.frames, self.warm = det, fx, frames, warm
        self.frame_s: list[float] = []
        self.launches = dict.fromkeys(KERNELS, 0)
        self.counted_frames = 0

    def burst(self, reps: int) -> None:
        """An untimed stream of `warm` frames, then `reps` timed streams."""
        if reps <= 0:
            return
        _stream(self.det, _frames(self.fx, self.warm))
        for _ in range(reps):
            reset_launches()
            n, s = _stream(self.det, _frames(self.fx, self.frames))
            if n != self.frames:
                raise RuntimeError(f"detect_stream gave {n} results for {self.frames} frames")
            for name, count in launches().items():
                self.launches[name] += count
            self.counted_frames += n
            self.frame_s.append(s / n)

    def fps(self) -> float:
        """bench.py's value: one over the median seconds a frame (the upper
        median for an even count)."""
        return 1.0 / sorted(self.frame_s)[len(self.frame_s) // 2]

    def detail(self) -> dict:
        rates = 1.0 / np.asarray(self.frame_s)
        q1, median, q3 = np.percentile(rates, [25, 50, 75])
        return {"samples": len(rates), "frames_a_sample": self.frames, "fps_min": float(rates.min()),
                "fps_q1": float(q1), "fps_median": float(median), "fps_q3": float(q3),
                "fps_max": float(rates.max())}

    def launches_a_frame(self) -> dict:
        return {name: n / self.counted_frames for name, n in self.launches.items()}


def gate(det: PoseDetection, fx: Fixture, device) -> dict:
    """bench.py's correctness gate: one warm detect, then VSD on the
    recentred scene and ADD against pose0.yml; ok needs a pose, VSD < 0.3
    and ADD <= 21 mm."""
    poses = det.detect(fx.color, fx.depth, 1)
    vsd = add = None
    if poses:
        bench = Benchmark(load_ply(MODEL), fx.cam, device)
        gt = read_ground_truth_pose(POSE0)
        scene = det.recenter(np.ascontiguousarray(fx.depth)).astype(np.float32)
        vsd = bench.score_vsd(scene, gt, poses[0])
        add = bench.score_add(gt, poses[0])
    ok = bool(poses) and vsd < VSD_CORRECT and add <= OBJECT_DIAMETER
    return {"poses": len(poses), "vsd": vsd, "add": add, "ok": ok}


def disk_to_pose_fps(det: PoseDetection, fx: Fixture, frames: int, out_dir: str) -> float:
    """The stream read from a `%d` PNG sequence of the fixture's two files
    (copied byte for byte) through cli._frame_source, median of PASSES."""
    os.makedirs(out_dir, exist_ok=True)
    rates = []
    with tempfile.TemporaryDirectory(dir=out_dir) as seq:
        for i in range(frames):
            shutil.copyfile(IMG0, os.path.join(seq, f"img{i}.png"))
            shutil.copyfile(DEPTH0, os.path.join(seq, f"depth{i}.png"))
        for _ in range(PASSES):
            src = _frame_source(os.path.join(seq, "img%d.png"), os.path.join(seq, "depth%d.png"),
                                fx.cam.width, fx.cam.height)
            n, s = _stream(det, src)
            if n != frames:
                raise RuntimeError(f"the PNG sequence gave {n} frames of {frames}")
            rates.append(n / s)
    return sorted(rates)[len(rates) // 2]


def device_frame_ms(det: PoseDetection, fx: Fixture) -> tuple[float, float] | None:
    """(device busy ms, device operations) of one detect_frame call on the
    frame already uploaded, from the profiler; None on the CPU."""
    if det.device.type != "cuda":
        return None
    color_t, depth_t = det.upload(det.recenter(np.ascontiguousarray(fx.color)),
                                  det.recenter(np.ascontiguousarray(fx.depth)))
    ms, ops = device_profile(lambda: detect_frame(det.state, color_t, depth_t), PROFILE_CALLS)
    if ms is None:
        raise RuntimeError("the profiler kept no complete record of detect_frame's device operations")
    return ms, ops


def host_post_ms(det: PoseDetection, fx: Fixture) -> float:
    """Mean host ms of detect_collect on a packed array already on the host,
    after one call that warms the hull-mask cache."""
    packed, color_c, depth_c = det.detect_submit(fx.color, fx.depth)
    fetched = (packed.cpu(), color_c, depth_c)
    det.detect_collect(fetched, 1)
    t0 = time.perf_counter()
    for _ in range(HOST_POST_CALLS):
        det.detect_collect(fetched, 1)
    return (time.perf_counter() - t0) / HOST_POST_CALLS * 1e3


def stream_fps(det: PoseDetection, fx: Fixture, frames: int, warm: int) -> float:
    """One warm detect, an untimed stream of `warm`, then the median rate of
    PASSES streams of `frames`."""
    det.detect(fx.color, fx.depth, 1)
    _stream(det, _frames(fx, warm))
    rates = []
    for _ in range(PASSES):
        n, s = _stream(det, _frames(fx, frames))
        rates.append(n / s)
    return sorted(rates)[len(rates) // 2]


def cpu_baseline_fps(frames: int, out_dir: str) -> float:
    """The port's pipeline on the host's CPU (`--cpu-worker` in a
    subprocess), cached in `<out_dir>/baseline_cpu.json` for the same frame
    count, host and torch; a failing worker raises."""
    key = {"frames": frames, "torch": torch.__version__, "cpu_count": os.cpu_count(),
           "machine": platform.machine(), "node": platform.node()}
    path = os.path.join(out_dir, "baseline_cpu.json")
    if os.path.exists(path):
        with open(path) as f:
            cached = json.load(f)
        if cached.get("key") == key:
            return cached["cpu_fps"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-m", "linemod_tpu_torch.tools.bench", "--cpu-worker", "--device", "cpu",
         "--frames", str(frames)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=3600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"the CPU baseline worker exited {out.returncode}:\n{out.stderr[-4000:]}")
    cpu_fps = json.loads(out.stdout.strip().splitlines()[-1])["fps"]
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"key": key, "cpu_fps": cpu_fps}, f)
    return cpu_fps


def cpu_worker(device, frames: int) -> float:
    """The baseline's measurement (run with `--device cpu`): one warm
    detect, then one timed stream of `frames` frames; frames/s."""
    fx = load_fixture()
    det = PoseDetection(fx.bank, fx.cam, fx.settings, fx.props, device)
    det.detect(fx.color, fx.depth, 1)
    n, s = _stream(det, _frames(fx, frames))
    return n / s


def run(args) -> tuple[dict, dict]:
    """(the result line, the detail line) of one bench run on args.device."""
    dev = device_from_flag(args.device)
    card = card_name(dev)
    fx = load_fixture()
    det = PoseDetection(fx.bank, fx.cam, fx.settings, fx.props, dev)
    checked = gate(det, fx, dev)

    # the device profiles first: a profiler session drops more records the
    # more sessions its process has run (tools/timing.device_profile)
    det_dual = PoseDetection(load_bank(DUAL_BANK), fx.cam, fx.dual_settings, fx.props, dev)
    color_dev = device_frame_ms(det, fx)
    dual_dev = device_frame_ms(det_dual, fx)

    headline = Headline(det, fx, args.frames, args.warm)
    headline.burst(args.repeats // 2)
    disk_fps = disk_to_pose_fps(det, fx, args.frames, args.out)
    headline.burst(args.repeats // 4)
    post_ms = host_post_ms(det, fx)

    # ICP on (use icp: 1): each group refined against the scene cloud and
    # verified by a render (src/PoseDetection.cpp:72-84)
    mesh = load_ply(MODEL)
    icp = IcpRefiner(mesh, fx.cam, fx.settings.icp_subsampling_factor, mesh_arrays=mesh_to_arrays(mesh, dev))
    det_icp = PoseDetection(fx.bank, fx.cam, fx.icp_settings, fx.props, dev, mesh=mesh, icp=icp)
    icp_fps = stream_fps(det_icp, fx, args.frames, args.warm)
    headline.burst(args.repeats // 4)

    # dual modality (color gradients and depth normals, T=5/8): its own bank
    dual_fps = stream_fps(det_dual, fx, args.frames, args.warm)
    headline.burst(args.repeats - len(headline.frame_s))

    fps = headline.fps()
    cpu_fps = cpu_baseline_fps(args.frames, args.out)
    result = {
        "metric": "detector_fps_per_chip" + ("" if checked["ok"] else "_ACCURACY_FAIL"),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / cpu_fps, 2),
        "disk_to_pose_fps": round(disk_fps, 3),
        "device_fps": None if color_dev is None else round(1e3 / color_dev[0], 3),
        "host_post_ms": round(post_ms, 3),
        "icp_fps": round(icp_fps, 3),
        "dual_fps": round(dual_fps, 3),
        "dual_device_fps": None if dual_dev is None else round(1e3 / dual_dev[0], 3),
        "device": card,
    }
    detail = {
        "gate": checked,
        "headline": headline.detail(),
        "launches_a_frame": headline.launches_a_frame(),
        "device_ms": None if color_dev is None else {
            "detect_frame": color_dev[0], "operations": color_dev[1],
            "dual_detect_frame": dual_dev[0], "dual_operations": dual_dev[1]},
        "cpu_baseline_fps": cpu_fps,
        "frames": args.frames,
    }
    return result, detail


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=FRAMES, help="frames a timed stream")
    ap.add_argument("--repeats", type=int, default=REPEATS, help="the headline's timed streams")
    ap.add_argument("--warm", type=int, default=WARM, help="untimed frames before each burst")
    ap.add_argument("--out", default=OUT, help="the CPU baseline's cache and the PNG sequence's directory")
    ap.add_argument("--cpu-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if min(args.frames, args.repeats) < 1 or args.warm < 0:
        ap.error("--frames and --repeats must be at least 1, --warm at least 0")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cpu_worker:
        print(json.dumps({"fps": cpu_worker(device_from_flag(args.device), args.frames)}))
        return 0
    result, detail = run(args)
    print(json.dumps({"detail": detail}))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
