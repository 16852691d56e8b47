"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --quantizer   # phase 2's quantizer part alone

Drives the port's paths on the card and checks them, in phases:

0. the card's name and power limit, torch and CUDA versions; no card -> exit 1;
1. build the kernels from `linemod_tpu_torch/csrc/` with nvcc (one process
   per source, all started together), and the 96,300-template bank of the
   reference's shipped settings (the fixture bank's 1,950 templates followed
   by 94,350 synthetic ones, seed 7) with its match state, and the dual
   bank's (`example/banks_dual/`, color gradients and depth normals, T=5/8);
2. each kernel against its plain PyTorch version on the card, exactly, with
   times of the kernel, its plain version and, where one PyTorch call
   computes the same function, that call: CUDA events around 50 calls
   queued behind a sleep, over 50 (`tools/timing.event_ms`), and
   torch.profiler's device time a call (`tools/timing.device_ms`); with the
   least time the card could take (bound). The coarse scan at the shapes its
   paths give it, each with its design numbers (templates a group, split S,
   blocks, staged bytes, lookups/ms): the fixture (2,048 templates), the
   large-bank rescan (the 1,024 selected templates, plan cut by rows), a
   4,096-template streaming chunk (plan cut by rows) and a 1280x960 random
   frame with a 2,048-template synthetic bank; the fine refine at its four
   shapes (tools/fine_time.fine_cases: the fixture's 512 candidates,
   1280x960, the dual shape F=128 window 4 on synthetic [401, 120, 256]
   planes, K=2,048) and on its edge cases (planes of 4 past a byte lane's
   flush, windows 1, 2, 3, 5, 12, 20 and 32, F=37, K=1, features on the zero
   plane, windows ending at the planes' last byte), its bound counting the
   distinct plane bytes the windows read; the masked max at the fixture's coarse planes
   with the 96,300 bank (with its design numbers) and at 1280x960, with
   templates whose bounds fit no cell; the coarse scan and the masked max
   on the edge cases: planes of 4 (sums of 256 and 512, past a byte lane),
   templates on one plane, F=128, half the features on the zero plane, fit
   boxes 1-7 cells wide at every shift residue, bounds beyond the grid, 0
   and negative; all three at the dual fixture's shapes: the scan and the
   masked max on its real coarse planes [1025, rows, stride] with the dual
   state's triplets [2048, 128, 3], the fine refine on its real fine planes
   [401, rows, stride] with the dual cut's 512 candidates at window 4;
   the color-gradient quantizer (`csrc/quantize.cu`) at both levels of the
   fixture frame, orientations and magnitudes bit for bit, with its
   bound (bytes) and the plain chain's time, and its launches a frame on
   the main path (2, one a level);
3. the main path: the fixture (640x480, the 1,950-template bank, ICP off)
   through `detect_submit` / `detect_collect`. The quantized maps equal the
   golden's with no pixel differing, the packed [512, 5] candidates equal
   the JAX reference's (tests/goldens/img0_torch_ref.npz; ints exact,
   similarities atol 1e-4), the top 8 equal tests/goldens/img0_golden.npz,
   the pose equals the JAX pose (0.5 mm, 1e-4) with ADD <= 21 mm against the
   ground truth, and both scan kernels were launched. The pose is scored
   with VSD by the port's Benchmark (< 0.3, and within 1e-3 of the JAX
   color pose's VSD in tests/goldens/img0_dual_ref.npz), and the card's
   render of the ground-truth pose is held against the JAX render there;
4. 20 more detect calls on the main path: median device ms of
   `detect_frame` (CUDA events), host post-processing ms and whole `detect`
   ms; then a torch.profiler window of 5 frames: device busy ms, device
   operations per frame and the largest kernels;
5. the large-bank path: the same frame through `PoseDetection` with the
   96,300 bank, which takes the prefiltered cut. Its packed [513, 5], the
   per-template maxes, the cut's four arrays and the pose equal the JAX
   golden (tests/goldens/img0_bigbank_ref.npz), the cut is proved exact,
   and the masked-max and scan kernels were launched. The streaming and the
   dense cut give the same packed candidates, the streaming cut with one
   scan launch a chunk. No path builds a kernel plan per frame. A bank of
   identical templates forces a saturated cut, which is retried on the
   streaming cut. Times: median whole `detect` ms (20 calls) and a profile
   as in phase 4, one-frame ms of the streaming and dense cuts;
6. the dual path: the fixture through `PoseDetection` with the dual bank
   (the depth goes to the card). The normal-quantized maps equal the
   golden's with no pixel differing at both levels, the packed [512, 5]
   equals tests/goldens/img0_dual_ref.npz, the pose is within 0.5 mm / 1e-4
   of the JAX pose with ADD <= 21 mm and VSD < 0.3 (and both within 1e-3 of
   JAX's scores), and the scan and the fine refine were launched once each.
   The same state with the prefiltered cut forced (`prefilter_sel` 1024,
   proved exact, the masked max launched) and with the streaming cut
   (`scan_chunk` 512) gives the dense packed array; the template maxes
   equal the golden's; a saturated dual bank is retried with its depth.
   Times: 20 dual detect calls and a profile, as in phase 4;
7. ICP on (`use icp: 1`, an IcpRefiner at the settings' sample step 2, the
   7,168-point model cloud): the fixture through `PoseDetection` on the
   card. The scan kernels were launched once each and the frame renders
   once; the pre-ICP groups and DetectionDebug counters equal JAX's, the
   scene cloud equals tests/goldens/img0_icp_ref.npz bit for bit, one ICP
   iteration is within 5e-4 mm / 5e-6 of JAX's, and the pose is within 0.5
   mm / 0.02 (rotation-matrix entries) of the nearest of the reference's
   poses from starts one and two ulps away (the reference's ICP is chaotic
   at the float32 level), with 10 < dz < 70 mm against the ICP-off pose and
   verify <= 35 mm. With TF32 allowed the result is the same bit for bit.
   The four stress starts of tests/test_icp_stress.py on the card's render
   converge (dt < 10 mm, ADD-S < 10 mm, verify <= 35 mm). Times: 20 ICP-on
   detect calls, the ICP leg split into scene cloud, 16 iterations and the
   verify render, and a profile of the leg;
8. two classes in one bank: the fixture bank and make_synthetic_bank(1950,
   seed=11, bbox_wh=64), 3,900 templates padded to 4,096, top_k 1,024. The
   packed [1024, 5] equals tests/goldens/img0_multi_ref.npz, the fixture
   class's pose equals JAX's (and whether it equals the single-class pose
   is printed), detect_all_stream over 3 frames equals detect_all, 2.1 at
   N = 4,096 and 2.2 at K = 1,024 equal their plain versions (times and
   bounds), and 20 detect_all calls are timed;
9. offline template generation on the card (`build_template_bank` with
   `device=cuda:0`, the shipped settings): the full dual bank (1,950
   templates) equals example/banks_dual/lagergehaeuse.npz row for row on all
   13 arrays, and the full color bank's first radius (rows 0-129) equals
   tests/goldens/gen_color_r500_ref.npz on all 9 (both are JAX's CPU
   generation); how many of its rows differ from the older committed
   example/banks is printed. The color bank then drives `PoseDetection`:
   2.1 and 2.2 launched once each, ADD <= 21 mm and VSD < 0.3; the dual bank
   gives tests/goldens/img0_dual_ref.npz's packed [512, 5] and pose. Times:
   seconds a bank, ms a template split into render, quantize, cut, scan and
   assembly, and one radius's wall time with the device's busy share
   (torch.profiler);
10. the command line and its tooling (`tooling_phase`): `cli detect
   --benchmark --display --profile` over PNG frames (the fixture frame, then
   synthetic frames of `pipeline/synth_eval` written with `write_png`, their
   ground truth with `write_yamlcv`): each frame's pose count and VSD as
   JAX's, every det*.png equal to the overlay drawn in memory, the mean ms
   (fps) line and the profile printed; `cli evaluate --gt yml` on the
   fixture and `--gt linemod` on a LINEMOD-layout sequence pass 100%; `cli
   convert` takes the color and dual banks through the reference pair and
   back (every array equal), its export equals the JAX golden pair
   (tests/goldens/refpair_ref.npz), which imports to the npz bank; the
   synthetic accuracy protocol (30 frames a mode x 4 modes, through
   `tools/accuracy_eval`) equals tests/goldens/synth_eval_ref.npz frame for
   frame (sha256 of color and depth, the detected set, each pose within 0.5
   mm / 1e-4, VSD and ADD-S within 1e-3), its totals printed beside
   ACCURACY_r05.json's and its ms a frame split into synthesis, detect and
   scoring; `register_depth_to_color` at Kinect v2's shapes (512x424 into
   1920x1080) with 0 pixels differing from tests/goldens/registration_ref.npz,
   and its ms; a Paeth-filtered 640x480 PNG decoded by `utils/png` (the
   C++ unfilter), equal to its pixels, and its host ms. Each CLI path
   prints its 2.1 and 2.2 launches a frame;
11. the sharded path (`parallel/`, `sharded_phase`): three worlds of ranks
   on cuda:0, each rank a process of this script (`--sharded-rank`):
   (i) one rank on NCCL, (ii) two ranks on gloo, tp 2, (iii) four ranks on
   gloo, dp 2 x tp 2 (NCCL takes one rank a GPU; gloo's collectives are
   staged through pinned host memory, which is printed). On every rank the
   fixture's packed [512, 5] equals tests/goldens/img0_torch_ref.npz and
   its pose passes the gate (ADD <= 21 mm, VSD < 0.3); the 96,300 bank's
   first 512 rows equal tests/goldens/img0_bigbank_ref.npz on the
   prefiltered cut (proved exact, through `sharded_detect`) and on the
   exact_only streaming matcher; at tp 2 the dual bank equals
   tests/goldens/img0_dual_ref.npz; 2.1, 2.2 and 2.3 launch as each path
   needs and no plain twin is called. Each launch's inputs and output are
   kept, and after the path's run every one of them is held against its
   plain twin on the same inputs (max|kernel - plain| 0, every launch of
   every rank). Times (CUDA events, medians of 20):
   the sharded frame a rank, the planes' band all-gather alone, and the
   single-device detect_frame in the same call;
12. the host-side ingest routes (`ingest_phase`): the card host's g++,
   glibc and core count; `utils/native.quantize_frame` (the port's copy of
   native/quantize.cpp, built here) on the fixture frame against the
   golden's maps, and on a seeded frame where the reference's host and
   device quantizers disagree, at the reference's pixels; then, each
   kernel launch kept with its inputs and held against its plain twin, the
   packed arrays against the JAX goldens of `detect_frame_quant` (the 1,950
   and 96,300 banks), `detect_frame_delta`, `detect_frame_dual_delta` (the
   dual bank), `detect_frames_batch_delta` (3 frames: the golden's, and
   each the default route's) and the `approx_topk` and `guarded_cut` cuts
   (which also equal the exact cut on a sparse frame, where the guard
   passes); `PoseDetection(host_quant=True)` and `delta_transport` give the
   default route's pose. Times: `quantize_frame` and `delta_encode_host` on
   the host, `detect_frame` / `_quant` / `_delta` (CUDA events, medians of
   20, in turns) with their device operations a frame (torch.profiler),
   whole `detect` by route, and `cli detect` over a 20-frame PNG sequence
   with the prefetching loader and with FileSequenceSource, in turns;
13. JPEG frames and ArUco ground-truth capture (`jpeg_aruco_phase`):
   every golden JPEG (tests/goldens/jpeg/), the progressive one too,
   decodes to cv2's digest; `cli evaluate --gt linemod` and `cli detect`
   over a JPEG LINEMOD-layout sequence (its .dpt depths and tra/rot written
   here) print JAX's lines (tests/goldens/jpeg_ref.npz), 2.1 and 2.2
   launching once a frame, each launch held against its plain twin; the
   board images equal cv2's, and on six 1920x1080 frames built here the
   markers' ids and corners (first pass and refined) equal cv2's, the
   device threshold maps the CPU's, and the board pose JAX's within the
   pose solvers' gap (tests/goldens/aruco_ref.npz); `capture_ground_truth`
   writes JAX's files. Times: host decode of the 640x480 frame as JPEG
   4:2:0 / 4:4:4 and as PNG, `cli evaluate` ms a frame over JPEG and PNG,
   `detect_board_pose` at 1920x1080 by stage, the capture's ms a frame;
14. the other frame formats (`imread_phase`): every golden of
   tests/goldens/imread/ (progressive JPEG, TIFF, PNM, BMP, a color PNG
   read as depth) decodes to cv2's digest in both modes and each refused
   kind raises naming the file and the kind (tests/goldens/imread_ref.npz);
   `cli detect` and `cli evaluate --gt yml` over the fixture as progressive
   JPEG with LZW and Deflate TIFF depths, and as PPM and BMP (written here
   from the PNG's pixels) with 16-bit PGM depths, print JAX's lines, 2.1
   and 2.2 launching once a frame, each launch held against its plain twin.
   Times: host decode of the 640x480 frame in each format beside PNG and
   baseline JPEG, `cli evaluate` ms a frame over progressive and baseline
   JPEG;
15. the measurement entry points (`tools_phase`): `python -m
   linemod_tpu_torch.tools.bench` in a process of its own, as a user runs
   it: it exits 0, its last line has every key of bench.py's and `device`,
   none null, the metric has no `_ACCURACY_FAIL`, its VSD and ADD are
   within 1e-3 of phase 3's, and 2.1 and 2.2 launch once a frame on its
   headline streams (2.3 never); the line is printed. Then, each in a
   process of its own at its defaults, `tools.profile_stages` (2.1 and 2.2 once a
   full match), `profile_detect`, `profile_icp` and `profile_multimodel`
   (2.1 and 2.2 once a frame), and `bigbank_bench --subdivs 0` and
   `--subdivs 0 --dual` (1,800 templates each generated with symmetry
   pruning off, a line a radius; each prefiltered frame, the dual one on
   the dual layout F = 128 with a zero depth, launches 2.1, 2.2 and 2.3
   once each, and each of those launches is held against its plain twin on
   the same inputs). Every tool's own lines are printed; any failure fails
   the phase;
16. the probes P1 and P2: the probe scripts' sequences through the wrappers,
   then each kernel against its plain twin;
17. a JSON line of per-kernel results (with `device_ms`; the dual shapes'
   numbers under `dual`, the ICP path's launches under `icp`, the
   two-class shapes' numbers under `multi`, the launches of detection
   with the card's generated color bank under `generated`, phase 10's
   launches a frame of each path under `cli_launches_a_frame`, phase 13's
   JPEG paths' under `jpeg_launches_a_frame`, phase 14's under
   `imread_launches_a_frame`, phase 15's under `tools_launches_a_frame`,
   by tool, phase 11's launches a frame a rank and max|kernel - plain| over the ranks
   under `sharded`, by world and path, and phase 12's launches a frame and
   max|kernel - plain| under `quant`, `delta` and `cut_opt_ins`, by path),
   after a line of the seconds from the start to each phase, then the
   result line {"ok": true, "device": {...}} last.

Any failed check raises, so the script exits non-zero and prints no result
line. Each path resets the kernels' launch counts just before it runs and
reads them just after; launches made to compare a kernel with its plain
version do not count.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(REPO, "example")
GOLDEN = os.path.join(REPO, "tests", "goldens", "img0_golden.npz")
TORCH_REF = os.path.join(REPO, "tests", "goldens", "img0_torch_ref.npz")
BIGBANK_REF = os.path.join(REPO, "tests", "goldens", "img0_bigbank_ref.npz")
DUAL_REF = os.path.join(REPO, "tests", "goldens", "img0_dual_ref.npz")
ICP_REF = os.path.join(REPO, "tests", "goldens", "img0_icp_ref.npz")
MULTI_REF = os.path.join(REPO, "tests", "goldens", "img0_multi_ref.npz")
GEN_COLOR_REF = os.path.join(REPO, "tests", "goldens", "gen_color_r500_ref.npz")
SYNTH_REF = os.path.join(REPO, "tests", "goldens", "synth_eval_ref.npz")
PAIR_REF = os.path.join(REPO, "tests", "goldens", "refpair_ref.npz")
REG_REF = os.path.join(REPO, "tests", "goldens", "registration_ref.npz")
JPEG_DIR = os.path.join(REPO, "tests", "goldens", "jpeg")
JPEG_REF = os.path.join(REPO, "tests", "goldens", "jpeg_ref.npz")
IMREAD_DIR = os.path.join(REPO, "tests", "goldens", "imread")
IMREAD_REF = os.path.join(REPO, "tests", "goldens", "imread_ref.npz")
ARUCO_REF = os.path.join(REPO, "tests", "goldens", "aruco_ref.npz")
# the port's board pose against JAX's (one cv2.solvePnP call, which stops
# with steps left) on the clean frames, and against solvePnP rerun from its
# own answer until it stops moving (tests/test_torch_aruco.py)
ARUCO_POSE_MM, ARUCO_POSE_ROT = 5e-6, 2e-7
ARUCO_CONVERGED_MM, ARUCO_CONVERGED_ROT = 1e-6, 1e-9
SYNTH_FRAMES = 30  # the accuracy protocol's frames a mode
# synthetic frames after the fixture frame in the CLI's sequence (mode, index)
CLI_SYNTH_FRAMES = (("shiny", 0), ("holes", 0), ("clutter", 0))
REPS = 20
# calls a kernel's time is taken over (its plain version's, where slow)
LAUNCHES = 50
PLAIN_LAUNCHES = 10
SIM_ATOL = 1e-4
# VSD and ADD against the JAX scores; the card's render of a pose against
# JAX's: pixels whose coverage differs, as a share of the covered pixels,
# and |depth| where both cover (the port fuses its dot products as XLA's
# CPU backend does, and on the CPU its render of pose0 equals JAX's bit for
# bit, tests/test_torch_render.py)
SCORE_ATOL = 1e-3
RENDER_COVERAGE = 1e-3
RENDER_ATOL_MM = 1e-2
# ICP against the JAX golden (tests/test_torch_icp_fixture.py): one
# iteration within a few ulps; the 16-iteration pose within these limits of
# the nearest of the reference's poses from starts one and two ulps away
# (the reference's ICP is chaotic at the float32 level)
ICP_ONE_ITER_MM = 5e-4
ICP_ONE_ITER_ROT = 5e-6
ICP_ENVELOPE_MM = 0.5
ICP_ENVELOPE_ROT = 0.02
# the least-time bound: device memory at 3.35 TB/s (H100 SXM data sheet,
# 700 W), and int32 adds at the INT32 rate: 64 INT32 lanes per SM (Hopper
# architecture white paper) x 132 SMs x 1,980 MHz boost (data sheet) =
# 16.7 T adds/s. The coarse kernels (2.1, 2.3) add 4 cells per u32 add
# (byte lanes), the fine refine (2.2) one int32 add per feature and cell;
# 2.2's bytes are the distinct plane bytes its windows read
# (tools/fine_time.fine_work), not the whole planes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# seconds from the script's start to each phase's first line
STARTED = time.perf_counter()
PHASE_AT = {}


def phase(n: int, text: str) -> None:
    PHASE_AT.setdefault(n, time.perf_counter() - STARTED)
    print(f"[phase {n}] {text}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median ms of one fn() call (a whole frame, host enqueue included)
    between CUDA events, over `reps` calls after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS) -> tuple:
    """(median, min) ms of one fn() call on the host's clock around
    synchronised work, over `reps` calls after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_start) * 1e3)
    return statistics.median(times), min(times)


def kernel_times(fn, reps: int = LAUNCHES) -> tuple:
    """(event ms, device ms) of one fn() call, without the host's enqueue:
    tools/timing.event_ms and device_ms over `reps` calls."""
    from linemod_tpu_torch.tools.timing import device_ms, event_ms

    return event_ms(fn, reps), device_ms(fn, reps)


def fmt(times: tuple) -> str:
    dev_ms = "not measured" if times[1] is None else f"{times[1]:.4f}"
    return f"{times[0]:.4f} ms (device {dev_ms})"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of bytes over the memory rate and int32
    adds over the INT32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fitting_cells(lim: torch.Tensor, ch: int, cw: int, weights=None) -> int:
    """Cells the masked max must score: sum over templates of the fit box
    (times weights[t], e.g. the template's features)."""
    ny = lim[:, 0].long().clamp(0, ch)
    nx = lim[:, 1].long().clamp(0, cw)
    cells = ny * nx if weights is None else ny * nx * weights.long()
    return int(cells.sum().item())


def profile_frames(fn, frames: int = 5) -> tuple:
    """torch.profiler over `frames` calls of fn(), in the guarded sessions
    of tools.timing.device_records: device busy ms per frame (the sum of
    the kernels' and copies' device time), device operations per frame,
    and the five largest by device time as (name, ms per frame); (None,
    None, []), not measured, where no session kept complete records."""
    from linemod_tpu_torch.tools.timing import device_records

    ops = device_records(fn, frames)
    if ops is None:
        return None, None, []
    by_name = collections.Counter()
    for e in ops:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3 / frames
    return sum(by_name.values()), len(ops) / frames, by_name.most_common(5)


def busy_text(busy, count, span_ms: float, what: str) -> str:
    """A profile_frames reading as printed: busy ms, operations and the
    idle share of `span_ms`, or "not measured"."""
    if busy is None:
        return f"device busy not measured (the profiler kept no complete session) over the {span_ms:.3f} ms {what}"
    return (f"device busy {busy:.3f} ms and {count:.0f} device operations a frame; idle {1 - busy / span_ms:.1%} "
            f"of the {span_ms:.3f} ms {what}")


def icp_phase(dev, card: str, cam, settings, bank, props, color, depth) -> dict:
    """Phase 7: the fixture with ICP on (the 1,950 bank, sample step 2) on
    the card, against tests/goldens/img0_icp_ref.npz. Returns the path's
    scan launches."""
    from linemod_tpu_torch.ops import icp as icp_mod
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.depth3d import scene_cloud_from_depth
    from linemod_tpu_torch.ops.icp import VERIFY_ACCEPT_MM, IcpRefiner, icp_refine_batch, verify_mean_depth_diff
    from linemod_tpu_torch.ops.metrics import adds_error
    from linemod_tpu_torch.ops.rasterizer import mesh_to_arrays, render
    from linemod_tpu_torch.pipeline.pose_detection import DetectionDebug, PoseDetection
    from linemod_tpu_torch.types import ObjectPose
    from linemod_tpu_torch.utils.geometry import mat_to_quat, rotation_about_axis
    from linemod_tpu_torch.utils.ply import load_ply

    ref = np.load(ICP_REF)
    mesh = load_ply(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    marr = mesh_to_arrays(mesh, dev)
    icp = IcpRefiner(mesh, cam, settings.icp_subsampling_factor, mesh_arrays=marr)
    det = PoseDetection(bank, cam, dataclasses.replace(settings, use_icp=True), props, dev, mesh=mesh, icp=icp)
    check(tuple(icp.model_pts.shape) == (7168, 3), "the model cloud's size")

    renders = []
    render_fn = icp_mod.render

    def counting_render(*args, **kwargs):
        renders.append(1)
        return render_fn(*args, **kwargs)

    icp_mod.render = counting_render
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    dbg = DetectionDebug()
    handle = det.detect_submit(color, depth)
    grouped, icp_handle = det._collect_phase1(handle, dbg)
    packed = icp_handle[0].cpu().numpy()
    poses = det._collect_phase2((grouped, icp_handle), 1)
    launches = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches,
                "coarse_max": sc.coarse_max.launches}
    icp_mod.render = render_fn
    phase(7, f"ICP path launches: coarse_scores {launches['coarse']}, fine_scores {launches['fine']}, "
             f"coarse_max {launches['coarse_max']}; renders a frame {len(renders)}; groups "
             f"{[len(g) for g in grouped]}; debug: {dbg.num_raw_matches} valid, {dbg.num_groups} groups, "
             f"{dbg.groups_kept} kept")
    check(launches == {"coarse": 1, "fine": 1, "coarse_max": 0}, "the ICP path's kernel launches")
    check([dbg.num_raw_matches, dbg.num_groups, dbg.groups_kept] == ref["debug_counts"].tolist(),
          "DetectionDebug differs from JAX's")
    check(np.array_equal(np.array([[p.translation for p in g] for g in grouped]), ref["pre_translation"]),
          "the pre-ICP groups differ from JAX's")

    # the scene cloud bit for bit, one ICP iteration within a few ulps
    depth_c = det.recenter(np.ascontiguousarray(depth))
    depth_t = torch.from_numpy(depth_c.astype(np.float32)).to(dev)
    first = grouped[0][0]
    cloud = scene_cloud_from_depth(depth_t, first.bounding_box, fx=cam.fx, fy=cam.fy,
                                   cx=cam.width / 2.0, cy=cam.height / 2.0)
    cloud_diff = [int((a.cpu().numpy() != ref[k]).any(axis=-1).sum() if a.dim() > 1 else
                      (a.cpu().numpy() != ref[k]).sum())
                  for a, k in zip(cloud, ("cloud_points", "cloud_normals", "cloud_valid"))]
    r0 = torch.from_numpy(first.rotation_matrix()[None].astype(np.float32)).to(dev)
    t0 = torch.from_numpy(np.asarray(first.translation, np.float32)[None]).to(dev)

    r1, t1, _ = icp_refine_batch(icp.model_pts, *cloud, r0, t0, iterations=1, model_nrm=icp.model_nrm,
                                 tolerance=icp.tolerance, rejection_scale=icp.rejection_scale)
    it_mm = float(np.abs(t1[0].cpu().numpy() - ref["icp1_trans"]).max())
    it_rot = float(np.abs(r1[0].cpu().numpy() - ref["icp1_rot"]).max())
    phase(7, f"scene cloud vs JAX: points, normals, valid differing {cloud_diff} of 4096; one ICP iteration "
             f"vs JAX: max|dt| {it_mm:.3g} mm, max|dR| {it_rot:.3g}")
    check(cloud_diff == [0, 0, 0], "the card's scene cloud differs from JAX's")
    check(it_mm <= ICP_ONE_ITER_MM and it_rot <= ICP_ONE_ITER_ROT, "one ICP iteration differs from JAX's")

    # the pose: nearest of the reference's envelope, and the reference's gates
    check(len(poses) == 1 and packed.shape == (1, 1, 13), "the ICP-on fixture gives one pose")
    p = poses[0]
    rot = p.rotation_matrix()
    gaps = [(float(np.abs(p.translation - e[0, 0, 9:12]).max()), float(np.abs(rot - e[0, 0, :9].reshape(3, 3)).max()))
            for e in ref["envelope"]]
    near = min(range(len(gaps)), key=lambda i: max(gaps[i][0] / ICP_ENVELOPE_MM, gaps[i][1] / ICP_ENVELOPE_ROT))
    base = ref["base_translation"]
    dz = float(p.translation[2] - base[2])
    verify = float(packed[0, 0, 12])
    phase(7, f"ICP pose t={np.round(p.translation, 4).tolist()} mm, verify {verify:.4f} mm (JAX: "
             f"t={np.round(ref['translation'], 4).tolist()}, verify {ref['packed'][0, 0, 12]:.4f}); gap to JAX's "
             f"{gaps[0][0]:.4f} mm / {gaps[0][1]:.4g}; nearest envelope pose #{near} {gaps[near][0]:.4f} mm / "
             f"{gaps[near][1]:.4g} (limits {ICP_ENVELOPE_MM} / {ICP_ENVELOPE_ROT}); dz {dz:.3f} mm vs ICP off")
    check(gaps[near][0] <= ICP_ENVELOPE_MM and gaps[near][1] <= ICP_ENVELOPE_ROT,
          "the ICP pose is outside the reference's envelope")
    check(10 < dz < 70 and abs(p.translation[0] - base[0]) < 15 and abs(p.translation[1] - base[1]) < 15
          and verify <= VERIFY_ACCEPT_MM, "the ICP pose fails the reference's gates")

    # TF32 allowed: the same pose bit for bit (no product is a matmul)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    packed_tf32 = icp.refine_submit(depth_c, grouped)[0].cpu().numpy()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
    torch.set_float32_matmul_precision(flags[2])
    phase(7, f"TF32 allowed: packed [G, P, 13] equal to TF32 off bit for bit: {np.array_equal(packed_tf32, packed)}")
    check(np.array_equal(packed_tf32, packed), "the ICP result depends on TF32")

    # the four stress starts of tests/test_icp_stress.py on the card's render
    s_cam = dataclasses.replace(cam, fx=1044.87, fy=1045.69, cx=320.0, cy=240.0)
    s_icp = IcpRefiner(mesh, s_cam, 2, mesh_arrays=marr)
    gt_rot = rotation_about_axis([1.0, 0.0, 0.0], np.radians(105.0)).astype(np.float32)
    gt_t = np.array([10.0, 25.0, 620.0], np.float32)
    s_depth = render(marr, gt_rot, gt_t, s_cam.fx, s_cam.fy, 320.0, 240.0)
    s_depth_np = s_depth.cpu().numpy()
    sub = torch.from_numpy(mesh.subsampled_vertices(40)).to(dev)
    for dz_s, deg in [(50.0, 0.0), (0.0, 15.0), (50.0, 15.0), (-50.0, 10.0)]:
        pert = rotation_about_axis([0.3, 1.0, 0.2], np.radians(deg)).astype(np.float32)
        init = ObjectPose(translation=(gt_t + np.array([5.0, -5.0, dz_s])).astype(np.float64),
                          quaternion=mat_to_quat(pert @ gt_rot), bounding_box=(220, 180, 200, 160))
        out = s_icp.refine(s_depth_np, [init])[0]
        r_out = torch.from_numpy(out.rotation_matrix().astype(np.float32)).to(dev)
        t_out = torch.from_numpy(out.translation.astype(np.float32)).to(dev)
        dt = float(np.linalg.norm(out.translation - gt_t))
        adds = float(adds_error(sub, torch.from_numpy(gt_rot).to(dev), torch.from_numpy(gt_t).to(dev), r_out, t_out))
        ver = float(verify_mean_depth_diff(s_depth, render(marr, r_out, t_out, s_cam.fx, s_cam.fy, 320.0, 240.0)))
        phase(7, f"stress start dz {dz_s:+.0f} mm, {deg:.0f} deg: dt {dt:.3f} mm, ADD-S {adds:.3f} mm, verify "
                 f"{ver:.3f} mm")
        check(dt < 10.0 and adds < 10.0 and ver <= VERIFY_ACCEPT_MM, f"stress start ({dz_s}, {deg}) not converged")

    # times: whole ICP-on detect, and the ICP leg split
    bbox = first.bounding_box
    rr, tt, _ = icp_refine_batch(icp.model_pts, *cloud, r0, t0, model_nrm=icp.model_nrm,
                                 tolerance=icp.tolerance, rejection_scale=icp.rejection_scale)
    vw = min(icp_mod.VERIFY_WINDOW, cam.width, cam.height)
    ox = min(max(bbox[0] + bbox[2] // 2 - vw // 2, 0), cam.width - vw)
    oy = min(max(bbox[1] + bbox[3] // 2 - vw // 2, 0), cam.height - vw)
    crop = depth_t[oy : oy + vw, ox : ox + vw]
    ms = {
        "detect": host_ms(lambda: det.detect(color, depth, 1))[0],
        "leg": host_ms(lambda: icp.refine_best_many(depth_c, grouped))[0],
        "cloud": host_ms(lambda: scene_cloud_from_depth(depth_t, bbox, fx=cam.fx, fy=cam.fy,
                                                        cx=cam.width / 2.0, cy=cam.height / 2.0))[0],
        "refine": host_ms(lambda: icp_refine_batch(icp.model_pts, *cloud, r0, t0, model_nrm=icp.model_nrm,
                                                   tolerance=icp.tolerance,
                                                   rejection_scale=icp.rejection_scale))[0],
        "verify": host_ms(lambda: icp._verify(rr, tt, crop, (ox, oy), (vw, vw)))[0],
    }
    phase(7, f"{REPS} ICP-on detect calls: whole detect {ms['detect']:.3f} ms; the ICP leg (refine_best_many) "
             f"{ms['leg']:.3f} ms: scene cloud {ms['cloud']:.3f} ms, 16 iterations {ms['refine']:.3f} ms, verify "
             f"render {ms['verify']:.3f} ms ({len(renders)} render a frame) (medians, host clock around synchronised "
             f"calls; {card})")
    busy, count, top = profile_frames(lambda: icp.refine_best_many(depth_c, grouped))
    phase(7, "ICP leg profile (torch.profiler, 5 frames): " + busy_text(busy, count, ms["leg"], "leg") + "; top: "
             + ", ".join(f"{name} {t:.3f} ms" for name, t in top))
    return launches


def multi_phase(dev, card: str, cam, settings, bank, props, color, depth, colorf) -> dict:
    """Phase 8: the fixture class and a synthetic second class in one bank
    (3,900 templates, padded to 4,096, top_k 1,024), against
    tests/goldens/img0_multi_ref.npz; kernels 2.1 at N = 4,096 and 2.2 at
    K = 1,024. Returns the path's launches and the kernels' numbers."""
    from linemod_tpu_torch.config import ModelProperties
    from linemod_tpu_torch.models.template_bank import make_synthetic_bank
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.detect_core import detect_frame
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.matching import _planes_3d, candidate_cut, coarse_similarity
    from linemod_tpu_torch.pipeline.multi_model import MultiModelPoseDetection
    from linemod_tpu_torch.tools.fine_time import fine_work

    ref = np.load(MULTI_REF)
    single = np.load(TORCH_REF)
    multi = MultiModelPoseDetection(
        {"lagergehaeuse": bank, "synthetic": make_synthetic_bank(1950, seed=11, bbox_wh=64)}, cam, settings,
        {"lagergehaeuse": props, "synthetic": ModelProperties()}, dev,
    )
    st = multi.state
    check(st.n_templates == 4096 and st.cfg.top_k == 1024, "the two-class bank's size and top_k")
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    out = multi.detect_all(color, depth, 1)
    launches = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches,
                "coarse_max": sc.coarse_max.launches}
    phase(8, f"multi-class path launches: coarse_scores {launches['coarse']}, fine_scores {launches['fine']}, "
             f"coarse_max {launches['coarse_max']}")
    check(launches == {"coarse": 1, "fine": 1, "coarse_max": 0}, "the multi-class path's kernel launches")
    packed = detect_frame(st, *multi.upload(multi.recenter(color), None)).cpu().numpy()
    ints_equal = np.array_equal(packed[:, [0, 1, 2, 4]], ref["packed"][:, [0, 1, 2, 4]])
    sim_err = float(np.abs(packed[:, 3] - ref["packed"][:, 3]).max())
    pose = out["lagergehaeuse"][0] if out["lagergehaeuse"] else None
    phase(8, f"packed {list(packed.shape)} vs JAX golden: ints equal {ints_equal}, max|sim diff| {sim_err:.3g}, "
             f"{int(packed[:, 4].sum())} valid; poses per class {({c: len(v) for c, v in out.items()})}")
    check(packed.shape == (1024, 5) and ints_equal and sim_err <= SIM_ATOL,
          "multi-class packed candidates differ from the JAX golden")
    check(pose is not None and len(out["synthetic"]) == int(ref["synthetic_poses"][0]), "the classes' pose counts")
    dt = float(np.abs(pose.translation - ref["translation"]).max())
    dq = float(np.abs(pose.quaternion - ref["quaternion"]).max())
    same_single = (np.array_equal(pose.translation, single["translation"])
                   and np.array_equal(pose.quaternion, single["quaternion"]))
    phase(8, f"fixture class pose t={np.round(pose.translation, 3).tolist()} mm: max|dt| {dt:.3g} mm, max|dq| "
             f"{dq:.3g} vs JAX's; equal to the single-class pose: {same_single}")
    check(dt == 0.0 and dq == 0.0, "the fixture class's pose differs from JAX's")
    streamed = list(multi.detect_all_stream([(color, depth)] * 3, 1))
    stream_equal = len(streamed) == 3 and all(
        {c: [(q.translation.tolist(), q.quaternion.tolist()) for q in v] for c, v in o.items()}
        == {c: [(q.translation.tolist(), q.quaternion.tolist()) for q in v] for c, v in out.items()}
        for o in streamed)
    phase(8, f"detect_all_stream over 3 frames equals detect_all: {stream_equal}")
    check(stream_equal, "detect_all_stream differs from detect_all")

    # 2.1 at N = 4,096 and 2.2 at K = 1,024, exact against the plain versions
    coarse_p = _planes_3d(downsample2(colorf), st.cfg.t_coarse, st.max_cells_coarse)
    fine_p = _planes_3d(colorf, st.cfg.t_fine, st.max_cells_fine)
    ch, cw = st.coarse_shape[:2]
    scan_args = (coarse_p, st.off3_coarse, ch, cw)
    _, cand_t, gy, gx = candidate_cut(coarse_similarity(st, coarse_p), cw, st.cfg.top_k)
    span = 2 * st.cfg.t_coarse
    fine_args = (fine_p, st.off3_fine, cand_t.int(),
                 torch.stack([gy * span // st.cfg.t_fine, gx * span // st.cfg.t_fine], 1).int(),
                 -(-span // st.cfg.t_fine))
    err = {"coarse": max_abs_err(sc.coarse_scores(*scan_args, plan=st.coarse_plan), sc.coarse_scores_plain(*scan_args)),
           "fine": max_abs_err(sc.fine_scores(*fine_args), sc.fine_scores_plain(*fine_args))}
    times = {"coarse": (kernel_times(lambda: sc.coarse_scores(*scan_args, plan=st.coarse_plan)),
                        kernel_times(lambda: sc.coarse_scores_plain(*scan_args), PLAIN_LAUNCHES)),
             "fine": (kernel_times(lambda: sc.fine_scores(*fine_args)),
                      kernel_times(lambda: sc.fine_scores_plain(*fine_args), PLAIN_LAUNCHES))}
    n = st.off3_coarse.shape[0]
    lookups = int((st.off3_coarse[..., 0] < coarse_p.shape[0] - 1).sum().item()) * ch * cw
    work = fine_work(*fine_args)
    bounds = {"coarse": bound(nbytes(coarse_p, st.off3_coarse) + 4 * n * ch * cw, lookups / 4),
              "fine": bound(work["bytes"], work["adds"])}
    phase(8, "two-class shapes: the kernels and their plain versions")
    print(f"  coarse_scores: planes {tuple(coarse_p.shape)} x {tuple(st.off3_coarse.shape)} -> [{n}, {ch}, {cw}]: "
          f"max|kernel-plain| {err['coarse']}; kernel {fmt(times['coarse'][0])}, plain {fmt(times['coarse'][1])}, "
          f"bound {bounds['coarse'][0]:.6f} ms by {bounds['coarse'][1]} ({lookups} lookups) ({card})")
    print(f"  fine_scores: planes {tuple(fine_p.shape)} x {tuple(st.off3_fine.shape)}, K={cand_t.shape[0]}, "
          f"win {fine_args[4]}: max|kernel-plain| {err['fine']}; kernel {fmt(times['fine'][0])}, plain "
          f"{fmt(times['fine'][1])}, bound {bounds['fine'][0]:.6f} ms by {bounds['fine'][1]} ({work['touched']} "
          f"distinct plane bytes) ({card})")
    check(err == {"coarse": 0, "fine": 0} and n == 4096 and cand_t.shape[0] == 1024, "a kernel != plain at the "
          "two-class shapes")

    med, low = host_ms(lambda: multi.detect_all(color, depth, 1))
    phase(8, f"{REPS} detect_all calls: median {med:.3f} ms, min {low:.3f} ms (host clock; {card})")
    return {name: {"launches": launches[name], "max_abs_err": err[name], "ms": times[name][0][0],
                   "device_ms": times[name][0][1], "plain_ms": times[name][1][0], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1]} for name in ("coarse", "fine")}


def generate_phase(dev, card: str, cam, settings, props, mesh, color, depth) -> dict:
    """Phase 9: offline template generation on the card. The full dual bank
    (1,950 templates) against example/banks_dual/lagergehaeuse.npz and the
    full color bank's first radius against tests/goldens/gen_color_r500_ref.npz,
    row for row on every array (both are JAX's CPU generation); each bank
    then drives detection: the color bank launches 2.1 and 2.2 once each and
    passes ADD and VSD, the dual bank gives tests/goldens/img0_dual_ref.npz's
    packed [512, 5] and pose. Times: seconds a bank, ms a template split into
    render, quantize, cut, scan and assembly, and the device's busy share
    over one radius. Returns the detection's launches."""
    from linemod_tpu_torch.models.template_bank import DUAL_FIELDS, FIELDS, TIMED_PHASES, build_template_bank
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.metrics import OBJECT_DIAMETER, VSD_CORRECT
    from linemod_tpu_torch.pipeline.benchmark import Benchmark, model_vertices, read_ground_truth_pose, score_add
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection

    model = os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")
    dual_settings = dataclasses.replace(settings, only_color_modality=False)
    banks, seconds, timings = {}, {}, {}
    for kind, st in (("dual", dual_settings), ("color", settings)):
        timings[kind] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        banks[kind] = build_template_bank(mesh, "lagergehaeuse.ply", cam, st, props, dev, timings=timings[kind])
        seconds[kind] = time.perf_counter() - t0

    def differing_rows(bank, ref, fields, rows):
        """Per field, the rows (of the first `rows`) whose arrays differ."""
        out = {}
        for f in fields:
            got, want = getattr(bank, f)[:rows], ref[f][:rows]
            same = got.shape == want.shape and got.dtype == want.dtype
            out[f] = int((got != want).reshape(rows, -1).any(1).sum()) if same else -1
        return out

    dual_ref_bank = np.load(os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz"))
    n_dual = banks["dual"].num_templates
    check(n_dual == dual_ref_bank["quat"].shape[0] == 1950, f"the dual bank has {n_dual} templates")
    dual_diff = differing_rows(banks["dual"], dual_ref_bank, FIELDS + DUAL_FIELDS, n_dual)
    phase(9, f"dual bank generated on the card: {n_dual} templates in {seconds['dual']:.2f} s ({card}); "
             f"rows differing from example/banks_dual (JAX's CPU generation), per array: {dual_diff}")
    check(banks["dual"].dual_modality and max(dual_diff.values()) == 0, "the dual bank differs from JAX's")

    color_ref = np.load(GEN_COLOR_REF)
    n_color = banks["color"].num_templates
    check(n_color == 1950, f"the color bank has {n_color} templates")
    color_diff = differing_rows(banks["color"], color_ref, FIELDS, 130)
    old = np.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    old_rows = sum(differing_rows(banks["color"], old, ("feat0", "feat1"), n_color).values())

    def level0(feat, valid, bbox, i):
        """Template i's level-0 features as (x, y, ori) in the image."""
        f = feat[i][valid[i]].astype(np.int64) + [bbox[i][0], bbox[i][1], 0]
        return set(map(tuple, f))

    cb = banks["color"]
    common = [len(level0(cb.feat0, cb.valid0, cb.bbox, i) & level0(old["feat0"], old["valid0"], old["bbox"], i))
              for i in range(n_color)]
    phase(9, f"color bank generated on the card: {n_color} templates in {seconds['color']:.2f} s ({card}); "
             f"rows 0-129 differing from the color golden (JAX's CPU generation), per array: {color_diff}; "
             f"rows whose level-0 or level-1 features differ from the committed example/banks (an older "
             f"generation), summed over the two: {old_rows} of {n_color}; level-0 features in common with "
             f"it a template: {min(common)}-{max(common)} of 63 (median {int(np.median(common))})")
    check(max(color_diff.values()) == 0, "the color bank's first radius differs from JAX's")
    for kind in ("dual", "color"):
        views = banks[kind].num_templates
        split = ", ".join(f"{k} {1e3 * timings[kind][k] / views:.3f}" for k in TIMED_PHASES)
        phase(9, f"{kind} generation, ms a template (host clock, a device sync after each phase): {split}; "
                 f"total {1e3 * seconds[kind] / views:.3f} ({card})")

    # the card's banks drive detection
    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    verts = model_vertices(model, dev)
    bench = Benchmark(mesh, cam, dev)
    det = PoseDetection(banks["color"], cam, settings, props, dev)
    scene = det.recenter(np.ascontiguousarray(depth)).astype(np.float32)
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    handle = det.detect_submit(color, depth)
    poses = det.detect_collect(handle, 1)
    launches = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches,
                "coarse_max": sc.coarse_max.launches}
    check(len(poses) == 1, f"the card's color bank: {len(poses)} poses")
    add, vsd = score_add(verts, gt, poses[0]), bench.score_vsd(scene, gt, poses[0])
    phase(9, f"detect with the card's color bank: launches coarse_scores {launches['coarse']}, fine_scores "
             f"{launches['fine']}, coarse_max {launches['coarse_max']}; pose t="
             f"{np.round(poses[0].translation, 3).tolist()} mm, ADD {add:.3f} mm, VSD {vsd:.5f}")
    check(launches == {"coarse": 1, "fine": 1, "coarse_max": 0}, "the generated color bank's launches")
    check(add <= OBJECT_DIAMETER and vsd < VSD_CORRECT, "the generated color bank's pose fails ADD or VSD")

    dual_ref = np.load(DUAL_REF)
    det_d = PoseDetection(banks["dual"], cam, dual_settings, props, dev)
    handle = det_d.detect_submit(color, depth)
    packed = handle[0].cpu().numpy()
    dposes = det_d.detect_collect(handle, 1)
    ints_equal = np.array_equal(packed[:, [0, 1, 2, 4]], dual_ref["packed"][:, [0, 1, 2, 4]])
    sim_err = float(np.abs(packed[:, 3] - dual_ref["packed"][:, 3]).max())
    check(len(dposes) == 1, f"the card's dual bank: {len(dposes)} poses")
    dt = float(np.abs(dposes[0].translation - dual_ref["translation"]).max())
    dq = float(np.abs(dposes[0].quaternion - dual_ref["quaternion"]).max())
    phase(9, f"detect with the card's dual bank: packed {list(packed.shape)} vs JAX golden: ints equal "
             f"{ints_equal}, max|sim diff| {sim_err:.3g}; pose max|dt| {dt:.3g} mm, max|dq| {dq:.3g}")
    check(packed.shape == (512, 5) and ints_equal and sim_err <= SIM_ATOL and dt <= 0.5 and dq <= 1e-4,
          "the generated dual bank's detection differs from the JAX golden")

    # one radius (130 views) of color generation: its wall time without the
    # profiler, then the device's busy time over it with the profiler
    # tracing the device alone (the host's ~10^5 operator events would
    # take minutes to collect), in tools.timing's guarded sessions
    radius = dataclasses.replace(settings, distance_stop=settings.distance_start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_template_bank(mesh, "lagergehaeuse.ply", cam, radius, props, dev)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    busy, count, top = profile_frames(lambda: build_template_bank(mesh, "lagergehaeuse.ply", cam, radius, props, dev),
                                      frames=1)
    phase(9, f"one radius of color generation (130 views): {wall:.1f} ms wall; profiler: "
             + busy_text(busy, count, wall, "radius (host clock)") + "; top: "
             + ", ".join(f"{n} {ms:.1f} ms" for n, ms in top) + f" ({card})")
    return launches


def kinect_depth(seed: int) -> np.ndarray:
    """The seeded Kinect v2 depth frame of tests/goldens/registration_ref.npz
    (tests/test_torch_registration.kinect_depth): integer mm in [500, 4500],
    5% holes, 512x424."""
    rng = np.random.default_rng(seed)
    depth = np.round(rng.uniform(500.0, 4500.0, (424, 512))).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    return depth


def run_cli(argv: list, cwd: str) -> str:
    """The port's CLI in this process: its standard output; a non-zero exit
    code fails the check."""
    import contextlib
    import io

    from linemod_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
    finally:
        os.chdir(here)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return out.getvalue()


def tooling_phase(dev, card: str, bank, color_vsd: float) -> dict:
    """Phase 10: the command line (detect, evaluate, convert) and the
    synthetic accuracy protocol on the card, and the Kinect v2
    registration. Returns each path's 2.1 and 2.2 launches a frame."""
    import gzip
    import hashlib
    import shutil
    import tempfile

    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.metrics import OBJECT_DIAMETER, VSD_CORRECT
    from linemod_tpu_torch.ops.registration import register_depth_to_color
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.pipeline.pose_detection import DetectionDebug
    from linemod_tpu_torch.tools.accuracy_eval import MODES, Protocol, mode_settings, mode_stats
    from linemod_tpu_torch.utils.draw import draw_coordinate_system, draw_features
    from linemod_tpu_torch.utils.geometry import quat_to_mat, rotation_about_axis
    from linemod_tpu_torch.utils.io import save_depth_linemod_dataset
    from linemod_tpu_torch.utils.png import encode_png, read_png, write_png
    from linemod_tpu_torch.utils.profiling import StageTimer
    from linemod_tpu_torch.utils.yamlcv import write_yamlcv

    def reset():
        sc.coarse_scores.launches = sc.fine_scores.launches = 0

    def per_frame(path, frames):
        """The path's 2.1 and 2.2 launches a frame; each must have launched."""
        counts = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches}
        check(min(counts.values()) > 0, f"{path}: a kernel was not launched ({counts})")
        return {k: v / frames for k, v in counts.items()}

    synth = np.load(SYNTH_REF)
    proto = Protocol.load(dev, seed=0)
    launches = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tooling-", dir=os.path.join(REPO, "build"))
    try:
        # (a) detect over PNG frames: the fixture frame, then synthetic frames
        # written with write_png, their ground truth with write_yamlcv
        seq = os.path.join(tmp, "seq")
        os.makedirs(seq)
        for name in ("img0.png", "depth0.png", "pose0.yml"):
            shutil.copy(os.path.join(EXAMPLE, "benchmark", name), seq)
        frames = {0: None}
        for i, (mode, index) in enumerate(CLI_SYNTH_FRAMES, start=1):
            color_s, depth_s, gt_s, _ = proto.gen.make_frame(index, mode)
            write_png(os.path.join(seq, f"img{i}.png"), color_s)
            write_png(os.path.join(seq, f"depth{i}.png"), depth_s)
            write_yamlcv(os.path.join(seq, f"pose{i}.yml"),
                         {"rotMat": quat_to_mat(gt_s.quaternion), "position": list(gt_s.translation)})
            frames[i] = MODES.index(mode) * SYNTH_FRAMES + index
        display = os.path.join(tmp, "display")
        reset()
        out = run_cli(["detect", "--model", "lagergehaeuse.ply", "--images", os.path.join(seq, "img%d.png"),
                       "--depths", os.path.join(seq, "depth%d.png"), "--benchmark", "--display", display,
                       "--profile", "--device", str(dev)], EXAMPLE)
        launches["detect"] = per_frame("cli detect", len(frames))
        lines = out.splitlines()
        for line in lines:
            print("  " + line)
        phase(10, f"cli detect over {len(frames)} PNG frames: 2.1 / 2.2 launches a frame {launches['detect']['coarse']:g}"
                  f" / {launches['detect']['fine']:g} ({card})")
        check(lines[0].startswith("frame 0: 1 pose(s) in ") and f"VSD error: {color_vsd:.3f}" in lines[0],
              f"cli detect, fixture frame: {lines[0]!r} (JAX's VSD {color_vsd:.5f})")
        for i, k in frames.items():
            if i:
                check(lines[i].startswith(f"frame {i}: 1 pose(s) in ")
                      and f"VSD error: {synth['vsd'][k]:.3f}" in lines[i],
                      f"cli detect, synthetic frame {i}: {lines[i]!r} (JAX's VSD {synth['vsd'][k]:.5f})")
        check(lines[len(frames)].startswith(f"{len(frames)} frames, mean "), "cli detect: no mean line")
        stages = {line.split()[0] for line in lines[len(frames) + 1:]}
        check(stages == {"decode", "detect", "benchmark", "display", "frame.submit", "submit.recenter",
                         "submit.upload", "match.quantize", "match.planes", "match.cut", "match.refine", "match.pack",
                         "frame.collect", "collect.copy", "collect.group", "collect.checks"},
              f"cli detect --profile stages {sorted(stages)}")
        # each overlay reads back equal to the image drawn in memory
        det = proto.detector()
        for i in frames:
            color_i, depth_i = read_png(os.path.join(seq, f"img{i}.png"), "color"), read_png(os.path.join(seq, f"depth{i}.png"), "anydepth")
            dbg = DetectionDebug()
            drawn = color_i.copy()
            poses = det.detect(color_i, depth_i, 1, debug=dbg)
            for t, _, _, okc, okd, xy in dbg.checks:
                if okc and okd:
                    draw_features(drawn, bank.feat0[t], bank.valid0[t], xy)
            for p in poses:
                draw_coordinate_system(drawn, proto.cam, 75.0, p)
            check(np.array_equal(read_png(os.path.join(display, f"det{i}.png"), "color"), drawn),
                  f"det{i}.png differs from the overlay drawn in memory")
        phase(10, f"the {len(frames)} overlays det*.png read back equal to the images drawn in memory")

        # (b) evaluate: the fixture's pose*.yml, and a LINEMOD-layout sequence
        reset()
        out = run_cli(["evaluate", "--model", "lagergehaeuse.ply", "--images", "benchmark/img%d.png", "--depths",
                       "benchmark/depth%d.png", "--gt", "yml", "--max-frames", "1", "--device", str(dev)], EXAMPLE)
        launches["evaluate"] = per_frame("cli evaluate", 1)
        print("  " + out.replace("\n", "\n  ").rstrip())
        check("VSD pass 100.0%" in out and "ADD-S pass 100.0%" in out, "cli evaluate --gt yml")
        lm = os.path.join(tmp, "benchmarkLINEMOD")
        os.makedirs(lm)
        shutil.copy(os.path.join(EXAMPLE, "benchmark", "img0.png"), os.path.join(lm, "color0.png"))
        save_depth_linemod_dataset(os.path.join(lm, "depth0.dpt"),
                                   read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth"))
        gt0 = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
        rot_raw = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0).T @ quat_to_mat(gt0.quaternion)
        with open(os.path.join(lm, "tra0.tra"), "w") as f:
            f.write("1 3\n" + " ".join(f"{v / 10.0:.6f}" for v in gt0.translation) + "\n")
        with open(os.path.join(lm, "rot0.rot"), "w") as f:
            f.write("3 3\n" + "\n".join(" ".join(f"{v:.8f}" for v in row) for row in rot_raw) + "\n")
        out = run_cli(["evaluate", "--model", "lagergehaeuse.ply", "--images", os.path.join(lm, "color%d.png"),
                       "--depths", os.path.join(lm, "depth%d.dpt"), "--gt", "linemod", "--device", str(dev)], EXAMPLE)
        print("  " + out.replace("\n", "\n  ").rstrip())
        check("VSD pass 100.0%" in out and "ADD-S pass 100.0%" in out, "cli evaluate --gt linemod")
        phase(10, f"cli evaluate --gt yml and --gt linemod pass 100.0%; 2.1 / 2.2 launches a frame "
                  f"{launches['evaluate']['coarse']:g} / {launches['evaluate']['fine']:g}")

        # (c) convert: both banks out to the reference pair and back, and the
        # committed golden pair in
        t0 = time.perf_counter()
        for label, src in (("color", os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz")),
                           ("dual", os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz"))):
            pair, back = os.path.join(tmp, f"{label}_pair"), os.path.join(tmp, f"{label}_back.npz")
            run_cli(["convert", "--to-reference", pair, "--bank", src], EXAMPLE)
            run_cli(["convert", "--from-reference", pair, "--bank", back], EXAMPLE)
            orig, got = TemplateBank.load(src), TemplateBank.load(back)
            fields = [f for f in vars(orig) if isinstance(getattr(orig, f), np.ndarray)]
            check(got.class_id == orig.class_id and got.dual_modality == orig.dual_modality
                  and len(fields) == (13 if orig.dual_modality else 9), f"convert {label}: bank fields")
            for f in fields:
                # the .bin keeps medianDepth as uint16
                want = np.round(orig.median_depth) if f == "median_depth" else getattr(orig, f)
                check(np.array_equal(getattr(got, f), want), f"convert {label}: {f} differs after the round trip")
            if label == "color":
                ref_pair = np.load(PAIR_REF)
                with gzip.open(os.path.join(pair, "linemod_templates.yml.gz"), "rb") as f:
                    check(f.read() == ref_pair["text"].tobytes(), "exported YAML differs from the golden pair")
                with open(os.path.join(pair, "linemod_tempPosFile.bin"), "rb") as f:
                    check(f.read() == ref_pair["bin"].tobytes(), "exported .bin differs from the golden pair")
                golden_pair = os.path.join(tmp, "golden_pair")
                os.makedirs(golden_pair)
                with gzip.open(os.path.join(golden_pair, "linemod_templates.yml.gz"), "wb") as f:
                    f.write(ref_pair["text"].tobytes())
                with open(os.path.join(golden_pair, "linemod_tempPosFile.bin"), "wb") as f:
                    f.write(ref_pair["bin"].tobytes())
                run_cli(["convert", "--from-reference", golden_pair, "--bank", os.path.join(tmp, "golden.npz")],
                        EXAMPLE)
                imported = TemplateBank.load(os.path.join(tmp, "golden.npz"))
                for f in fields:
                    check(np.array_equal(getattr(imported, f), getattr(got, f)), f"golden pair import: {f} differs")
        phase(10, f"cli convert: the color and dual banks round-trip through the reference pair (every array "
                  f"equal, median depth to its uint16 rounding), the export equals the JAX golden pair's text and "
                  f"bytes, and the golden pair imports to the npz bank; {time.perf_counter() - t0:.1f} s host")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the synthetic accuracy protocol: 30 frames a mode x 4 modes
    det = proto.detector()
    timer = StageTimer(sync=True, device=dev)
    records = {}
    reset()
    t0 = time.perf_counter()
    for mode in MODES:
        det.settings = mode_settings(proto.settings, mode)
        records[mode] = [proto.run_frame(det, i, mode, timer) for i in range(SYNTH_FRAMES)]
    wall = time.perf_counter() - t0
    n = len(MODES) * SYNTH_FRAMES
    launches["accuracy"] = per_frame("accuracy protocol", n)
    worst = {"dt": 0.0, "dq": 0.0, "vsd": 0.0, "adds": 0.0}
    for m, mode in enumerate(MODES):
        for rec in records[mode]:
            k = m * SYNTH_FRAMES + rec["frame"]
            where = f"{mode} frame {rec['frame']}"
            check(hashlib.sha256(rec["color"].tobytes()).hexdigest().encode() == synth["color_sha256"][k]
                  and hashlib.sha256(rec["depth"].tobytes()).hexdigest().encode() == synth["depth_sha256"][k],
                  f"{where}: the frame differs from JAX's")
            check((rec["pose"] is not None) == bool(synth["detected"][k]), f"{where}: detected differs from JAX")
            if rec["pose"] is None:
                continue
            for key, value in (("dt", np.abs(rec["pose"].translation - synth["translation"][k]).max()),
                               ("dq", np.abs(rec["pose"].quaternion - synth["quaternion"][k]).max()),
                               ("vsd", abs(rec["vsd"] - synth["vsd"][k])), ("adds", abs(rec["adds"] - synth["adds"][k]))):
                worst[key] = max(worst[key], float(value))
        stats = mode_stats(records[mode])
        print(f"  {mode}: {stats['detected']}/{stats['frames']} detected, VSD pass {stats['vsd_pass']}, "
              f"ADD-S pass {stats['adds_pass']}, both {stats['both_pass']}")
    check(worst["dt"] <= 0.5 and worst["dq"] <= 1e-4, f"a pose differs from JAX's: {worst}")
    check(worst["vsd"] <= SCORE_ATOL and worst["adds"] <= SCORE_ATOL, f"a score differs from JAX's: {worst}")
    card_total = {k: sum(mode_stats(records[m])[k] for m in MODES) for k in ("detected", "vsd_pass", "adds_pass",
                                                                              "both_pass")}
    vsd_ok, adds_ok = synth["vsd"] < VSD_CORRECT, synth["adds"] <= OBJECT_DIAMETER
    jax_total = {"detected": int(synth["detected"].sum()), "vsd_pass": int(vsd_ok.sum()),
                 "adds_pass": int(adds_ok.sum()), "both_pass": int((vsd_ok & adds_ok).sum())}
    with open(os.path.join(REPO, "ACCURACY_r05.json")) as f:
        r05 = json.load(f)["total"]
    phase(10, f"accuracy protocol, {n} frames: every frame equals JAX's byte for byte, the detected set is JAX's, "
              f"max|dt| {worst['dt']:.3g} mm, max|dq| {worst['dq']:.3g}, max|dVSD| {worst['vsd']:.3g}, "
              f"max|dADD-S| {worst['adds']:.3g}")
    phase(10, "totals (detected, VSD pass, ADD-S pass, both) of 120: card "
              + "/".join(str(card_total[k]) for k in card_total) + ", JAX CPU golden "
              + "/".join(str(jax_total[k]) for k in jax_total) + ", ACCURACY_r05.json "
              + "/".join(str(r05[k]) for k in card_total))
    split = ", ".join(f"{name} {timer.totals[name] / timer.counts[name] * 1e3:.2f} ms x{timer.counts[name]}"
                      for name in ("synthesis", "detect", "scoring"))
    phase(10, f"accuracy protocol ms a frame: {wall / n * 1e3:.2f} wall; by stage (device synced at each "
              f"stage's ends): {split}; 2.1 / 2.2 launches a frame {launches['accuracy']['coarse']:g} / "
              f"{launches['accuracy']['fine']:g} ({card})")

    # (e) depth-to-color registration at Kinect v2's shapes
    ref = np.load(REG_REF)
    depth = kinect_depth(int(ref["seed"]))
    check(hashlib.sha256(depth.tobytes()).hexdigest().encode() == ref["depth_sha256"], "the Kinect input differs")
    depth_t = torch.from_numpy(depth).to(dev)
    cams = [torch.from_numpy(ref[k]).to(dev) for k in ("k_depth", "k_color", "rot", "trans")]
    got = register_depth_to_color(depth_t, *cams).cpu().numpy().ravel()
    want = np.zeros_like(got)
    want[ref["index"]] = ref["value"]
    differ = int((got != want).sum())
    reg_ms = kernel_times(lambda: register_depth_to_color(depth_t, *cams), reps=20)
    phase(10, f"register_depth_to_color 512x424 -> 1920x1080: {differ} of {got.size} pixels differ from JAX's "
              f"({len(ref['index'])} covered); {fmt(reg_ms)} ({card})")
    check(differ == 0, "the registration differs from JAX's")

    # (f) a PNG frame written with the Paeth filter on every row, decoded by
    # utils/png (the C++ unfilter) on the host
    rgb = np.random.default_rng(7).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    path = os.path.join(REPO, "build", "paeth.png")
    with open(path, "wb") as f:
        f.write(encode_png(rgb, 640, 2, 8, 4))
    decoded = read_png(path, "color")
    decode_ms = host_ms(lambda: read_png(path, "color"))
    phase(10, f"a Paeth-filtered 640x480 color PNG decodes equal to its pixels: {np.array_equal(decoded, rgb[:, :, ::-1])}; "
              f"{decode_ms[0]:.3f} ms (median of {REPS}, min {decode_ms[1]:.3f}; host clock)")
    check(np.array_equal(decoded, rgb[:, :, ::-1]), "the Paeth frame decodes wrongly")
    return launches


# phase 11's worlds: (label, ranks, backend, dp), run one after the other on
# cuda:0; NCCL takes one rank a GPU, so the worlds of several ranks on the
# one card use gloo, whose collectives the port stages through pinned host
# memory (parallel/sharded_match.transport)
SHARDED_WORLDS = (("world1_nccl", 1, "nccl", 1), ("world2_gloo", 2, "gloo", 1), ("world4_gloo_dp2", 4, "gloo", 2))
SHARDED_TIMEOUT_S = 240


def sharded_rank(spec_json: str) -> int:
    """Phase 11's rank: one process of a world on cuda:0 (started by
    sharded_phase with MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK set).
    Runs the fixture (1,950 bank), the 96,300 bank (the prefiltered cut,
    then the exact_only streaming matcher) and, at tp 2, the dual bank
    through the sharded matcher, with each path's kernel launches, and
    times the sharded frame, the planes' band all-gather and (rank 0) the
    single-device detect_frame; writes rank<r>.npz into spec["out"]."""
    import torch.distributed as dist

    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank, concat_banks, make_synthetic_bank
    from linemod_tpu_torch.ops import matching as matching_mod
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.detect_core import _pack, detect_frame
    from linemod_tpu_torch.parallel.distributed import initialize_distributed
    from linemod_tpu_torch.parallel.mesh import make_mesh
    from linemod_tpu_torch.parallel.sharded_match import (
        all_gather,
        make_sharded_matcher,
        shard_state,
        sharded_detect,
        transport,
    )
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    spec = json.loads(spec_json)
    dev = initialize_distributed(backend=spec["backend"], device=torch.device("cuda", 0),
                                 timeout_s=SHARDED_TIMEOUT_S)
    rank = dist.get_rank()
    mesh = make_mesh(dist.get_world_size(), dp=spec["dp"])

    # the kernels as the matcher calls them (ops/matching's names), their
    # plain twins, which refuse while the sharded path runs
    kernels = ("coarse_scores", "fine_scores", "coarse_max")
    plain = {name: getattr(sc, f"{name}_plain") for name in kernels}

    def refuse(name):
        def refusing(*args, **kwargs):
            raise SmokeFailure(f"a sharded rank called {name}")
        return refusing

    def refuse_all():
        for name in kernels:
            setattr(sc, f"{name}_plain", refuse(f"{name}_plain"))

    refuse_all()

    def launched(fn):
        """fn()'s result, the kernels' launches during it (2.1, 2.2, 2.3),
        and each kernel's max|kernel - plain| over every launch: each call's
        inputs and output are kept, and once fn has run the plain twins are
        restored and given the same inputs on the card. Also the inputs'
        shapes, kernel by kernel (the rows of off3 and of the output)."""
        calls = []

        def keep(name, kernel):
            def wrapper(*args, **kwargs):
                out = kernel(*args, **kwargs)
                calls.append((name, args, out))
                return out
            return wrapper

        sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
        for name in kernels:
            setattr(matching_mod, name, keep(name, getattr(sc, name)))
        try:
            result = fn()
            torch.cuda.synchronize()
        finally:
            for name in kernels:
                setattr(matching_mod, name, getattr(sc, name))
        counts = np.array([getattr(sc, name).launches for name in kernels])
        err = np.zeros(3, np.int64)
        compared = np.zeros(3, np.int64)
        shapes = {name: [] for name in kernels}
        for name in kernels:
            setattr(sc, f"{name}_plain", plain[name])
        try:
            for name, args, out in calls:
                i = kernels.index(name)
                if out.numel():
                    err[i] = max(err[i], max_abs_err(out, plain[name](*args)))
                    compared[i] += 1
                    shapes[name].append(f"{list(args[1].shape)}->{list(out.shape)}")
        finally:
            refuse_all()
        check(np.array_equal(compared, counts), f"kernel launches {counts.tolist()}, calls compared with their "
                                                f"plain versions {compared.tolist()}")
        shapes = {name: sorted(set(v), key=v.index) for name, v in shapes.items()}
        return result, counts, err, np.array(json.dumps(shapes))

    def packed(out, proof):
        keys = ("template_id", "x", "y", "similarity", "valid") + (("cut_exact",) if proof else ())
        return _pack({k: out[k][0] for k in keys}).cpu().numpy()

    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    res = {"transport": np.array(transport(mesh.tp_group, dev))}

    # the fixture: every dp row takes one copy of the frame
    det = PoseDetection(bank, cam, settings, props, dev)
    frames = np.stack([det.recenter(color)] * mesh.dp)
    fast = make_sharded_matcher(shard_state(det.state, mesh), mesh)
    out, res["fixture_launches"], res["fixture_err"], res["fixture_shapes"] = launched(lambda: fast(frames))
    res["fixture_packed"] = packed(out, False)
    res["fixture_ms"] = np.array(cuda_ms(lambda: fast(frames)))
    # the planes' band all-gather alone, at both levels' band shapes
    for level, shape, t in (("fine", det.state.fine_shape, 2), ("coarse", det.state.coarse_shape, 8)):
        band = torch.zeros((8 * t * t + 1, shape[2] // mesh.tp, shape[3]), dtype=torch.uint8, device=dev)
        res[f"gather_{level}_ms"] = np.array(cuda_ms(lambda b=band: all_gather(b, mesh.tp_group)))
        res[f"gather_{level}_bytes"] = np.array(band.numel() * mesh.tp)

    # the 96,300 bank: the prefiltered cut, then the exact streaming matcher
    big_bank, _ = concat_banks([bank, make_synthetic_bank(94350, seed=7, bbox_wh=64, image_wh=(640, 480))])
    det_big = PoseDetection(big_bank, cam, settings, props, dev)
    big_state = shard_state(det_big.state, mesh)
    fast_b = make_sharded_matcher(big_state, mesh)
    exact_b = make_sharded_matcher(big_state, mesh, exact_only=True)
    out, res["big_launches"], res["big_err"], res["big_shapes"] = launched(
        lambda: sharded_detect(fast_b, exact_b, frames))
    res["big_packed"] = packed(out, True)
    out, res["big_exact_launches"], res["big_exact_err"], res["big_exact_shapes"] = launched(
        lambda: exact_b(frames))
    res["big_exact_packed"] = packed(out, True)
    res["big_ms"] = np.array(cuda_ms(lambda: sharded_detect(fast_b, exact_b, frames)))
    res["big_exact_ms"] = np.array(cuda_ms(lambda: exact_b(frames), reps=3))

    if mesh.tp == 2:
        det_dual = PoseDetection(TemplateBank.load(os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz")), cam,
                                 dataclasses.replace(settings, only_color_modality=False), props, dev)
        depths = np.stack([det_dual.recenter(depth).astype(np.float32)] * mesh.dp)
        fast_d = make_sharded_matcher(shard_state(det_dual.state, mesh), mesh)
        out, res["dual_launches"], res["dual_err"], res["dual_shapes"] = launched(
            lambda: fast_d(frames, depths))
        res["dual_packed"] = packed(out, False)
        res["dual_ms"] = np.array(cuda_ms(lambda: fast_d(frames, depths)))

    # the single-device frame program in the same call, on rank 0 alone
    dist.barrier()
    if rank == 0:
        color_t = torch.from_numpy(frames[0]).to(dev)
        res["single_ms"] = np.array(cuda_ms(lambda: detect_frame(det.state, color_t)))
        big_t = torch.from_numpy(frames[0]).to(dev)
        res["single_big_ms"] = np.array(cuda_ms(lambda: detect_frame(det_big.state, big_t)))
    dist.barrier()
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    return 0


def run_world(label: str, size: int, backend: str, dp: int, out: str) -> list:
    """Start `size` ranks of sharded_rank on cuda:0 and wait for all of
    them; a rank that fails or outlives SHARDED_TIMEOUT_S fails the check
    with the tail of its log. Returns each rank's results."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.makedirs(out, exist_ok=True)
    spec = json.dumps({"backend": backend, "dp": dp, "out": out})
    procs, logs = [], []
    try:
        for rank in range(size):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(size),
                       RANK=str(rank), LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(size))
            logs.append(open(os.path.join(out, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank", spec],
                                          env=env, cwd=REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        if p.returncode != 0:
            failed.append(f"rank {rank} exited {p.returncode}:\n{log.read()[-3000:]}")
        log.close()
    check(not failed, f"{label}: " + "\n".join(failed))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(size)]


def sharded_phase(card: str, ref, big_ref, dual_ref, pose_gate) -> dict:
    """Phase 11: the sharded path (parallel/) in each of SHARDED_WORLDS on
    the card. Every rank's fixture packed array equals the JAX reference
    and its pose passes the gate (pose_gate(packed, label)); the 96,300
    bank's first 512 rows equal its golden on the prefiltered cut (proved
    exact) and on the exact streaming matcher; at tp 2 the dual bank equals
    its golden; 2.1, 2.2 and 2.3 launch on every rank as each path needs.
    Every launch on every rank is held against its plain version on the
    same inputs (max|kernel - plain| 0). Returns, by world and path, rank
    0's launches a frame and the largest error over the ranks, each
    [2.1, 2.2, 2.3]."""
    import shutil

    root = os.path.join(REPO, "build", "sharded")
    shutil.rmtree(root, ignore_errors=True)

    def same(got, want, rows, label):
        ints = np.array_equal(got[:rows][:, [0, 1, 2, 4]], want[:rows][:, [0, 1, 2, 4]])
        sim_err = float(np.abs(got[:rows, 3] - want[:rows, 3]).max())
        check(ints and sim_err <= SIM_ATOL, f"{label}: packed differs from the JAX golden "
                                            f"(ints equal {ints}, max|sim diff| {sim_err:.3g})")
        return bool(np.array_equal(got[:rows], want[:rows]))

    launches = {}
    for label, size, backend, dp in SHARDED_WORLDS:
        t0 = time.perf_counter()
        ranks = run_world(label, size, backend, dp, os.path.join(root, label))
        tp = size // dp
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        phase(11, f"{label}: {size} rank(s) on cuda:0, dp {dp} x tp {tp}, {backend}, collectives "
                  f"{r0['transport']}; the world ran in {wall:.1f} s")
        # the exact matcher streams each shard in chunks of at most 4,096
        # templates, a divisor of the shard (candidate_cut_streaming)
        n_shard = 96512 // tp
        chunk = min(4096, n_shard)
        while n_shard % chunk:
            chunk -= 1
        want = {"fixture": [1, 1, 0], "big": [1, 1, 1], "big_exact": [n_shard // chunk, 1, 0]}
        if tp == 2:
            want["dual"] = [1, 1, 0]
        exact, errs = {}, {}
        for r, res in enumerate(ranks):
            for path, n in want.items():
                got = res[f"{path}_launches"].tolist()
                check(got == n, f"{label} rank {r} {path}: launches (2.1, 2.2, 2.3) {got}, want {n}")
                err = res[f"{path}_err"].tolist()
                check(max(err) == 0, f"{label} rank {r} {path}: max|kernel - plain| (2.1, 2.2, 2.3) {err}")
                errs[path] = np.maximum(errs.get(path, 0), res[f"{path}_err"])
            exact[r] = [same(res["fixture_packed"], ref["packed"], 512, f"{label} rank {r} fixture"),
                        same(res["big_packed"], big_ref["packed"], 512, f"{label} rank {r} 96,300 bank"),
                        same(res["big_exact_packed"], big_ref["packed"], 512, f"{label} rank {r} 96,300 exact")]
            check(res["big_packed"].shape == (513, 5) and res["big_packed"][-1, 0] == 1.0,
                  f"{label} rank {r}: the sharded prefiltered cut was not proved exact")
            if tp == 2:
                exact[r].append(same(res["dual_packed"], dual_ref["packed"], 512, f"{label} rank {r} dual"))
            check(np.array_equal(res["fixture_packed"], r0["fixture_packed"]), f"{label}: ranks disagree")
        phase(11, f"{label}: every rank's packed equals the JAX goldens (fixture [512, 5], the 96,300 bank's first "
                  f"512 rows on the prefiltered cut, cut_exact 1, and on the exact streaming matcher"
                  f"{', the dual bank' if tp == 2 else ''}); bit for bit by rank: {exact}")
        phase(11, f"{label}: launches a frame a rank (2.1, 2.2, 2.3): " + ", ".join(
            f"{path} {tuple(r0[f'{path}_launches'].tolist())}" for path in want))
        phase(11, f"{label}: every launch of every rank held against its plain version on the same inputs, "
                  f"max|kernel - plain| (2.1, 2.2, 2.3): " + ", ".join(
                      f"{path} {tuple(errs[path].tolist())}" for path in want))
        for path in want:
            print(f"  {label} {path}, rank 0's kernel inputs (off3 rows -> output): "
                  + "; ".join(f"{name} {', '.join(v)}" for name, v in json.loads(str(r0[f'{path}_shapes'])).items()
                              if v))
        pose_gate(r0["fixture_packed"], f"{label} fixture")
        ms = {k: [float(res[k]) for res in ranks] for k in ("fixture_ms", "big_ms", "big_exact_ms",
                                                            "gather_fine_ms", "gather_coarse_ms")}
        if tp == 2:
            ms["dual_ms"] = [float(res["dual_ms"]) for res in ranks]
        phase(11, f"{label}: sharded ms a frame a rank (CUDA events, median of {REPS}; the exact matcher of 3): "
                  + "; ".join(f"{k[:-3]} " + ", ".join(f"{v:.3f}" for v in vals) for k, vals in ms.items())
                  + f"; planes' band all-gather of {int(r0['gather_fine_bytes'])} / "
                    f"{int(r0['gather_coarse_bytes'])} B (fine / coarse, {r0['transport']}); "
                    f"single-device detect_frame in the same call {float(r0['single_ms']):.3f} ms, 96,300 bank "
                    f"{float(r0['single_big_ms']):.3f} ms ({card})")
        launches[label] = {path: (r0[f"{path}_launches"].tolist(), errs[path].tolist()) for path in want}
    return launches


# phase 12: a seeded frame on which the reference's host quantizer
# (native/quantize.cpp) and its device quantizer disagree, and where, as
# (level, row, column, host value, device value); tests/test_torch_native.py
# pins the same pixels against JAX on the CPU. The card host's build of the
# port's copy must give the reference's host values there.
DISAGREEING_SEED = 249
DISAGREEING_PIXELS = [(0, 44, 19, 0, 64), (0, 44, 20, 0, 64), (1, 6, 9, 128, 0), (1, 6, 10, 128, 0)]
# frames of the PNG sequence phase 12 times `cli detect` over
CLI_SEQUENCE_FRAMES = 20


def kept_launches(fn):
    """fn()'s result, each kernel's launches during it (2.1, 2.2, 2.3) and
    its max|kernel - plain| over them: every call through ops/matching's
    names keeps its inputs and output, and once fn has run each plain twin
    is given the same inputs on the card."""
    from linemod_tpu_torch.ops import matching as matching_mod
    from linemod_tpu_torch.ops import similarity_cuda as sc

    names = ("coarse_scores", "fine_scores", "coarse_max")
    calls = []

    def keep(name, kernel):
        def wrapper(*args, **kwargs):
            out = kernel(*args, **kwargs)
            calls.append((name, args, out))
            return out
        return wrapper

    for name in names:
        getattr(sc, name).launches = 0
        setattr(matching_mod, name, keep(name, getattr(sc, name)))
    try:
        result = fn()
        torch.cuda.synchronize()
    finally:
        for name in names:
            setattr(matching_mod, name, getattr(sc, name))
    launches = {name: getattr(sc, name).launches for name in names}
    err = dict.fromkeys(names, 0)
    compared = dict.fromkeys(names, 0)
    for name, args, out in calls:
        err[name] = max(err[name], max_abs_err(out, getattr(sc, f"{name}_plain")(*args)))
        compared[name] += 1
    check(compared == launches, f"launches {launches}, calls held against their plain versions {compared}")
    return result, launches, err


def first_line(cmd: list) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    return (out.stdout or out.stderr).strip().splitlines()[0]


def cli_sequence_ms(dev, seq: str, frame_source) -> dict:
    """`cli detect --profile` over the PNG sequence in `seq`, with the CLI's
    frame source replaced by `frame_source` when given: the mean line's ms
    and the decode and detect stages' ms a call."""
    from linemod_tpu_torch import cli

    real = cli._frame_source
    if frame_source is not None:
        cli._frame_source = frame_source
    try:
        out = run_cli(["detect", "--model", "lagergehaeuse.ply", "--images", os.path.join(seq, "img%d.png"),
                       "--depths", os.path.join(seq, "depth%d.png"), "--profile", "--device", str(dev)], EXAMPLE)
    finally:
        cli._frame_source = real
    lines = out.splitlines()
    check(lines[CLI_SEQUENCE_FRAMES].startswith(f"{CLI_SEQUENCE_FRAMES} frames, mean "), "cli detect: no mean line")
    stages = {line.split()[0]: float(line.split()[4]) for line in lines[CLI_SEQUENCE_FRAMES + 1:]}
    return {"mean": float(lines[CLI_SEQUENCE_FRAMES].split()[3]), "decode": stages["decode"],
            "detect": stages["detect"]}


def ingest_phase(dev, card: str, det, det_big, det_dual, refs: dict, color, depth, check_pose) -> dict:
    """Phase 12: the host-side ingest routes on the card. Returns each
    path's kernel launches and max|kernel - plain|, by path."""
    import shutil
    import tempfile

    from linemod_tpu_torch.ops.detect_core import (
        delta_encode_host,
        detect_frame,
        detect_frame_delta,
        detect_frame_dual_delta,
        detect_frame_quant,
        detect_frames_batch_delta,
    )
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.pipeline.sensors import FileSequenceSource
    from linemod_tpu_torch.utils.native import quantize_frame

    ref, big_ref, dual_ref = refs["fixture"], refs["96300"], refs["dual"]
    host = (f"os.cpu_count() {os.cpu_count()}; {first_line(['ldd', '--version'])}; "
            f"{first_line(['g++', '--version'])}")
    phase(12, f"the card's host: {host}")
    where = f"{card}; os.cpu_count() {os.cpu_count()}"

    # the host quantizer, built by g++ here: the fixture's maps against the
    # golden's (JAX's), and the reference's disagreeing pixels
    color_c = det.recenter(np.ascontiguousarray(color))
    depth_c = det.recenter(np.ascontiguousarray(depth))
    t0 = time.perf_counter()
    q0, q1 = quantize_frame(color_c)
    build_s = time.perf_counter() - t0
    mism = [int((q0 != ref["quant0"]).sum()), int((q1 != ref["quant1"]).sum())]
    drawn = np.clip(np.random.default_rng(DISAGREEING_SEED).normal(128, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
    h_maps = quantize_frame(drawn)
    drawn_f = torch.from_numpy(drawn).to(dev).float()
    d_maps = [quantize_color_gradients(drawn_f)[0].cpu().numpy(),
              quantize_color_gradients(downsample2(drawn_f))[0].cpu().numpy()]
    pixels = [(lv, int(y), int(x), int(h_maps[lv][y, x]), int(d_maps[lv][y, x]))
              for lv in (0, 1) for y, x in np.argwhere(h_maps[lv] != d_maps[lv])]
    q_ms = host_ms(lambda: quantize_frame(color_c))
    e_ms = host_ms(lambda: delta_encode_host(color_c))
    phase(12, f"quantize_frame (csrc/quantize.cpp, g++ at first use, {build_s:.2f} s with the build): fixture maps "
              f"vs golden {mism[0]} of {q0.size} level-0 and {mism[1]} of {q1.size} level-1 pixels differ; the "
              f"pinned frame's host/device disagreements {pixels} (the reference's: {DISAGREEING_PIXELS}); "
              f"{q_ms[0]:.3f} ms a 640x480 frame (median of {REPS}, min {q_ms[1]:.3f}; host clock); "
              f"delta_encode_host {e_ms[0]:.3f} ms ({where})")
    check(mism == [0, 0], "the card host's quantize_frame differs from the golden maps")
    check(pixels == DISAGREEING_PIXELS, "the card host's quantize_frame is not the reference's on the pinned frame")

    # each route's device program, every kernel launch held against its plain
    # version; the packed arrays against the JAX goldens
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q0_t, q1_t = up(q0), up(q1)
    delta_t, color_t = up(delta_encode_host(color_c)), up(color_c)
    depth_t = up(det_dual.recenter(np.ascontiguousarray(depth)).astype(np.float32))
    sparse = np.full_like(color_c, 128)
    sparse[237:261, 264:288] = color_c[237:261, 264:288]
    batch = [color_c, np.roll(color_c, (9, -14), (0, 1)), sparse]
    state = det.state
    opt_state = {opt: dataclasses.replace(state, cfg=dataclasses.replace(state.cfg, **{opt: True}))
                 for opt in ("approx_topk", "guarded_cut")}
    paths = {
        "quant": (lambda: detect_frame_quant(state, q0_t, q1_t), ref["packed"], 1),
        "quant 96,300": (lambda: detect_frame_quant(det_big.state, q0_t, q1_t), big_ref["packed"], 1),
        "delta": (lambda: detect_frame_delta(state, delta_t), ref["packed"], 1),
        "dual delta": (lambda: detect_frame_dual_delta(det_dual.state, delta_t, depth_t), dual_ref["packed"], 1),
        "batch delta": (lambda: detect_frames_batch_delta(state, up(np.stack([delta_encode_host(c) for c in batch]))),
                        None, 3),
        "approx_topk": (lambda: detect_frame(opt_state["approx_topk"], color_t), ref["packed"], 1),
        "guarded_cut": (lambda: detect_frame(opt_state["guarded_cut"], color_t), ref["packed"], 1),
    }
    results = {}
    for label, (fn, want, frames) in paths.items():
        got, launches, err = kept_launches(fn)
        got = got.cpu().numpy()
        if want is None:  # the batch: frame 0 the golden's, each frame the default route's
            defaults = [detect_frame(state, up(c)).cpu().numpy() for c in batch]
            ok = all(np.array_equal(g, d) for g, d in zip(got, defaults))
            got, want = got[0], ref["packed"]
            ok = ok and got.shape == want.shape
        else:
            ok = got.shape == want.shape
        ok = ok and np.array_equal(got[:, [0, 1, 2, 4]], want[:, [0, 1, 2, 4]])
        sim_err = float(np.abs(got[:, 3] - want[:, 3]).max()) if ok else float("inf")
        results[label] = {"launches": {k: v / frames for k, v in launches.items()}, "max_abs_err": err}
        phase(12, f"{label}: packed {list(got.shape)} vs JAX golden: ints equal {ok}, max|sim diff| {sim_err:.3g}; "
                  f"launches a frame (2.1, 2.2, 2.3) {tuple(v / frames for v in launches.values())}, "
                  f"max|kernel-plain| {tuple(err.values())} over every launch")
        check(ok and sim_err <= SIM_ATOL, f"{label}: packed candidates differ from the JAX golden")
        check(launches["coarse_scores"] > 0 and launches["fine_scores"] > 0, f"{label}: a kernel was not launched")
        check(max(err.values()) == 0, f"{label}: a kernel launch != its plain version")
    check(results["quant 96,300"]["launches"]["coarse_max"] == 1, "the 96,300 quant path did not take the masked max")
    sparse_t = up(sparse)
    same = {opt: np.array_equal(detect_frame(st, sparse_t).cpu().numpy(), detect_frame(state, sparse_t).cpu().numpy())
            for opt, st in opt_state.items()}
    phase(12, f"sparse frame (228 coarse entries at threshold; the guard passes): the opt-ins' packed arrays equal "
              f"the exact cut's: {same}")
    check(all(same.values()), "an opt-in cut differs from the exact cut on the sparse frame")

    # the routes through PoseDetection: the default route's pose
    det_hq = PoseDetection(det.bank, det.cam, det.settings, det.props, dev, host_quant=True)
    det_dt = PoseDetection(det.bank, det.cam, det.settings, det.props, dev)
    det_dt.delta_transport = True
    check(det_hq.host_quant and not det_dt.host_quant, "the routes' flags")
    for label, d in (("host-quantize route", det_hq), ("delta route", det_dt)):
        poses, launches, err = kept_launches(lambda d=d: d.detect(color, depth, 1))
        check_pose(poses, ref, label, 12)
        check(max(err.values()) == 0 and launches["fine_scores"] == 1, f"{label}: launches {launches}, err {err}")
        results[f"{label} detect"] = {"launches": launches, "max_abs_err": err}

    # times: the device programs (CUDA events around the whole call, host
    # enqueue included; medians of 20, in turns), device operations a frame
    # (torch.profiler), and each route's whole detect (host clock)
    prog = {"detect_frame": lambda: detect_frame(state, color_t),
            "detect_frame_quant": lambda: detect_frame_quant(state, q0_t, q1_t),
            "detect_frame_delta": lambda: detect_frame_delta(state, delta_t)}
    order = ["detect_frame", "detect_frame_quant", "detect_frame_delta", "detect_frame_delta", "detect_frame_quant",
             "detect_frame"]
    prog_ms = {k: [] for k in prog}
    for k in order:
        prog_ms[k].append(cuda_ms(prog[k]))
    profiles = {k: profile_frames(fn) for k, fn in prog.items()}
    phase(12, "device programs on the fixture, CUDA events (median of 20, run in the order ABCCBA): "
              + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in prog_ms[k])} ms" for k in prog) + f" ({where})")
    for k, (busy, count, top) in profiles.items():
        print(f"  {k} profile (torch.profiler, 5 frames): " + busy_text(busy, count, statistics.median(prog_ms[k]),
                                                                         "program (CUDA events)")
              + "; top: " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top))
    ops = {k: v[1] for k, v in profiles.items()}
    share = ("not measured" if None in (ops["detect_frame"], ops["detect_frame_quant"]) else
             f"{ops['detect_frame'] - ops['detect_frame_quant']:.0f} of {ops['detect_frame']:.0f}")
    phase(12, f"the quantizer's share of the color program's launches: {share} device operations a frame ({where})")
    routes = {"default": det, "host_quant": det_hq, "delta_transport": det_dt}
    route_ms = {k: host_ms(lambda d=d: d.detect(color, depth, 1)) for k, d in routes.items()}
    phase(12, "whole detect by route (host clock, median of 20 / min): "
              + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} ms" for k, v in route_ms.items()) + f" ({where})")

    # cli detect over a PNG sequence, with the prefetching loader and with
    # FileSequenceSource, in turns after a warm-up run
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ingest-", dir=os.path.join(REPO, "build"))
    try:
        for i in range(CLI_SEQUENCE_FRAMES):
            shutil.copy(os.path.join(EXAMPLE, "benchmark", "img0.png"), os.path.join(tmp, f"img{i}.png"))
            shutil.copy(os.path.join(EXAMPLE, "benchmark", "depth0.png"), os.path.join(tmp, f"depth{i}.png"))
        sources = {"loader": None,
                   "FileSequenceSource": lambda images, depths, w, h: iter(FileSequenceSource(images, depths))}
        cli_sequence_ms(dev, tmp, None)
        cli = {k: [] for k in sources}
        for k in ("loader", "FileSequenceSource", "FileSequenceSource", "loader"):
            cli[k].append(cli_sequence_ms(dev, tmp, sources[k]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase(12, f"cli detect --profile over {CLI_SEQUENCE_FRAMES} PNG frames, two runs each in turns (ms a frame): "
              + "; ".join(f"{k}: " + ", ".join(f"decode {r['decode']:.2f} + detect {r['detect']:.2f} = "
                                               f"{r['decode'] + r['detect']:.2f} (mean line {r['mean']:.1f})"
                                               for r in runs) for k, runs in cli.items()) + f" ({where})")
    return results


def aruco_frames() -> dict:
    """The ArUco test frames of tests/test_torch_aruco.test_frames (numpy
    only; their sha256 is in tests/goldens/aruco_ref.npz): the JAX test's
    frame, its noise-corrupted copy and four seeded views, 1920x1080."""
    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.pipeline.aruco_capture import _board, board_view

    board = _board().generate_image((720, 1000), 20)
    frame = np.full((1080, 1920, 3), 128, np.uint8)
    frame[40:1040, 600:1320] = board[:, :, None]
    noisy = frame.copy()
    noisy[60:180, 620:740] = np.random.default_rng(0).integers(0, 255, (120, 120, 3), dtype=np.uint8)
    out = {"jax": frame, "noisy": noisy}
    cam = CameraParameters(fx=1000.0, fy=1000.0, cx=960.0, cy=540.0, width=1920, height=1080)
    for seed in (0, 2, 3, 4):
        r = np.random.default_rng(seed)
        rvec = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.5, 0.5), r.uniform(-0.4, 0.4)])
        tvec = np.array([-340 + r.uniform(-150, 150), -480 + r.uniform(-60, 60), r.uniform(1150, 1600)])
        out[f"view{seed}"] = board_view(board, cam, rvec, tvec)
    return out


def jpeg_aruco_phase(dev, card: str) -> dict:
    """Phase 13: JPEG color frames and the ArUco ground-truth capture on the
    card, held to the goldens of tests/test_torch_jpeg.py and
    tests/test_torch_aruco.py (cv2 and JAX on the CPU). Returns the JPEG
    paths' 2.1 and 2.2 launches a frame."""
    import hashlib
    import re
    import shutil
    import tempfile

    from linemod_tpu_torch.config import CameraParameters
    from linemod_tpu_torch.ops import aruco
    from linemod_tpu_torch.pipeline import aruco_capture as ac
    from linemod_tpu_torch.pipeline.benchmark import read_ground_truth_pose
    from linemod_tpu_torch.utils.geometry import quat_to_mat, rotation_about_axis
    from linemod_tpu_torch.utils.io import save_depth_linemod_dataset
    from linemod_tpu_torch.utils.jpeg import read_jpeg
    from linemod_tpu_torch.utils.png import read_png, write_png
    from linemod_tpu_torch.utils.profiling import StageTimer
    from linemod_tpu_torch.utils.yamlcv import read_yamlcv

    jref, aref = np.load(JPEG_REF), np.load(ARUCO_REF)
    # (a) every golden JPEG, the progressive one too, decodes to cv2's digest
    decoded = 0
    for name, color_sha, gray_sha in zip(jref["names"], jref["color_sha256"], jref["gray_sha256"]):
        path = os.path.join(JPEG_DIR, str(name))
        check(hashlib.sha256(read_jpeg(path, "color").tobytes()).hexdigest() == color_sha, f"{name}: color != cv2")
        check(hashlib.sha256(read_jpeg(path, "anydepth").tobytes()).hexdigest() == gray_sha, f"{name}: gray != cv2")
        decoded += 1
    phase(13, f"JPEG decode: {decoded} golden files (one progressive) equal cv2's decode (color and gray) bit "
              "for bit")

    # (b) evaluate --gt linemod and detect over the JPEG LINEMOD-layout sequence
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="jpeg-aruco-", dir=os.path.join(REPO, "build"))
    launches = {}
    try:
        seq = os.path.join(tmp, "benchmarkLINEMOD")
        png_seq = os.path.join(tmp, "png")
        os.makedirs(seq)
        os.makedirs(png_seq)
        depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
        gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
        rot_raw = rotation_about_axis([1.0, 0.0, 0.0], -np.pi / 2.0).T @ quat_to_mat(np.asarray(gt.quaternion))
        for i, name in enumerate(jref["sequence"]):
            shutil.copy(os.path.join(JPEG_DIR, str(name)), os.path.join(seq, f"color{i}.jpg"))
            write_png(os.path.join(png_seq, f"color{i}.png"), read_jpeg(os.path.join(seq, f"color{i}.jpg"), "color"))
            for d in (seq, png_seq):
                save_depth_linemod_dataset(os.path.join(d, f"depth{i}.dpt"), depth)
                with open(os.path.join(d, f"tra{i}.tra"), "w") as f:
                    f.write("1 3\n" + " ".join(f"{v / 10.0:.6f}" for v in gt.translation) + "\n")
                with open(os.path.join(d, f"rot{i}.rot"), "w") as f:
                    f.write("3 3\n" + "\n".join(" ".join(f"{v:.8f}" for v in row) for row in rot_raw) + "\n")
        frames_n = len(jref["sequence"])

        def argv(command, folder, ext):
            return [command, "--model", "lagergehaeuse.ply", "--images", os.path.join(folder, f"color%d{ext}"),
                    "--depths", os.path.join(folder, "depth%d.dpt"), "--device", str(dev)] + (
                        ["--gt", "linemod"] if command == "evaluate" else [])

        for command in ("evaluate", "detect"):
            out, n, err = kept_launches(lambda: run_cli(argv(command, seq, ".jpg"), EXAMPLE))
            text = re.sub(r"mean \d+\.\d ms \(\d+\.\d+ fps\)", "mean <t> ms (<f> fps)",
                          re.sub(r"in \d+\.\d ms", "in <t> ms", out))
            check(text.splitlines() == list(jref[f"{command}_lines"]), f"cli {command} over JPEG != JAX:\n{out}")
            check(n["coarse_scores"] == n["fine_scores"] == frames_n and n["coarse_max"] == 0,
                  f"cli {command} over JPEG launches {n}")
            check(err["coarse_scores"] == err["fine_scores"] == 0, f"cli {command} over JPEG: kernel != plain {err}")
            launches[command] = {"coarse": n["coarse_scores"] / frames_n, "fine": n["fine_scores"] / frames_n}
            phase(13, f"cli {command} over {frames_n} JPEG frames (4:2:0 q95, 4:4:4 q75, 4:2:2 with restarts): "
                      f"JAX's lines; launches a frame 2.1 {launches[command]['coarse']:g}, 2.2 "
                      f"{launches[command]['fine']:g}, max|kernel - plain| {max(err.values())}")
        # evaluate's ms a frame: the 3-frame command less the 1-frame command
        # (the bank's load and the detector's set-up cancel), in turns
        eval_ms = {".png": [], ".jpg": []}
        for folder, ext in ((png_seq, ".png"), (seq, ".jpg"), (seq, ".jpg"), (png_seq, ".png")):
            runs = []
            for max_frames in ("1", "0"):
                t0 = time.perf_counter()
                run_cli(argv("evaluate", folder, ext) + ["--max-frames", max_frames], EXAMPLE)
                runs.append((time.perf_counter() - t0) * 1e3)
            eval_ms[ext].append((runs[1] - runs[0]) / (frames_n - 1))
        fixture_png = os.path.join(EXAMPLE, "benchmark", "img0.png")
        decode = {
            "JPEG 4:2:0 q95": host_ms(lambda: read_jpeg(os.path.join(JPEG_DIR, "fixture_420.jpg"), "color")),
            "JPEG 4:4:4 q75": host_ms(lambda: read_jpeg(os.path.join(JPEG_DIR, "fixture_444_q75.jpg"), "color")),
            "PNG": host_ms(lambda: read_png(fixture_png, "color")),
        }
        phase(13, "host decode of the 640x480 fixture frame, median (min) ms of 20: " + ", ".join(
            f"{k} {v[0]:.3f} ({v[1]:.3f})" for k, v in decode.items()) + "; cli evaluate ms a frame (3 frames less 1, "
            f"in turns PNG, JPEG, JPEG, PNG): JPEG {[round(v, 1) for v in eval_ms['.jpg']]}, PNG "
            f"{[round(v, 1) for v in eval_ms['.png']]} ({card})")

        # (c) the board image
        board_path = os.path.join(tmp, "board.png")
        ac.create_aruco_board(board_path)
        check(np.array_equal(read_png(board_path, "anydepth"), aref["board"]), "board image != cv2's")
        other = aruco.GridBoard((5, 7), 120.0, 20.0).generate_image((500, 730), 13)
        check(np.array_equal(other, aref["board_other"]), "500x730 board image != cv2's")

        # (d) ids, corners and poses on the test frames; (e) device maps
        cam = CameraParameters(fx=1000.0, fy=1000.0, cx=960.0, cy=540.0, width=1920, height=1080)
        frames = aruco_frames()
        check(list(frames) == list(aref["frames"]), "test frames differ from the golden's")
        worst = {"clean": [0.0, 0.0], "noisy": [0.0, 0.0], "converged": [0.0, 0.0]}
        for name, frame in frames.items():
            check(hashlib.sha256(frame.tobytes()).hexdigest() == str(aref[f"{name}_sha256"]), f"{name}: frame differs")
            gray_d = aruco.to_gray(torch.from_numpy(frame).to(dev))
            maps_d = aruco.threshold_maps(gray_d).cpu().numpy()
            maps_h = aruco.threshold_maps(aruco.to_gray(torch.from_numpy(frame))).numpy()
            check(np.array_equal(maps_d, maps_h), f"{name}: device threshold maps != CPU maps")
            for refine, key in ((False, "plain"), (True, "refined")):
                corners, ids = ac.detect_markers(frame, cam, refine=refine, device=dev)
                check(np.array_equal(ids, aref[f"{name}_{key}_ids"]), f"{name} {key}: ids != cv2's")
                check(np.array_equal(np.array(corners).reshape(-1, 4, 2), aref[f"{name}_{key}_corners"]),
                      f"{name} {key}: corners != cv2's")
            rot, t = ac.board_pose(corners, ids, cam)
            kind = "noisy" if name == "noisy" else "clean"
            worst[kind][0] = max(worst[kind][0], float(np.abs(t - aref[f"{name}_t"]).max()))
            worst[kind][1] = max(worst[kind][1], float(np.abs(rot - aref[f"{name}_rot"]).max()))
            worst["converged"][0] = max(worst["converged"][0], float(np.abs(t - aref[f"{name}_t_converged"]).max()))
            worst["converged"][1] = max(worst["converged"][1],
                                        float(np.abs(rot - aref[f"{name}_rot_converged"]).max()))
        check(worst["clean"][0] <= ARUCO_POSE_MM and worst["clean"][1] <= ARUCO_POSE_ROT,
              f"clean-frame pose vs JAX: {worst['clean']}")
        check(worst["noisy"][0] <= 0.5 and worst["noisy"][1] <= 1e-3, f"noisy-frame pose vs JAX: {worst['noisy']}")
        check(worst["converged"][0] <= ARUCO_CONVERGED_MM and worst["converged"][1] <= ARUCO_CONVERGED_ROT,
              f"pose vs converged cv2.solvePnP: {worst['converged']}")
        phase(13, f"ArUco on {len(frames)} frames (1920x1080): ids and corners equal cv2's (first pass and "
                  f"refined), device threshold maps equal the CPU's; pose vs JAX: clean max|dt| "
                  f"{worst['clean'][0]:.3g} mm, max|dR| {worst['clean'][1]:.3g}; noisy {worst['noisy'][0]:.3g} mm, "
                  f"{worst['noisy'][1]:.3g}; every frame vs cv2.solvePnP rerun until it stops moving "
                  f"{worst['converged'][0]:.3g} mm, {worst['converged'][1]:.3g}; board images equal cv2's")

        # (f) the capture
        cap = os.path.join(tmp, "capture")
        depth_c = np.full((1080, 1920), 700, np.uint16)
        check(ac.capture_ground_truth([(frames["jax"], depth_c)], cam, out_dir=cap, device=dev) == 1, "capture count")
        check(hashlib.sha256(read_png(os.path.join(cap, "img0.png"), "color").tobytes()).hexdigest()
              == str(aref["capture_img_sha256"]), "captured img0.png != JAX's")
        check(hashlib.sha256(read_png(os.path.join(cap, "depth0.png"), "anydepth").tobytes()).hexdigest()
              == str(aref["capture_depth_sha256"]), "captured depth0.png != JAX's")
        pose = read_yamlcv(os.path.join(cap, "pose0.yml"))
        check(np.abs(pose["rotMat"] - aref["capture_rot"]).max() <= ARUCO_POSE_ROT
              and np.abs(np.array(pose["position"]) - aref["capture_position"]).max() <= ARUCO_POSE_MM,
              "captured pose0.yml != JAX's")

        # times: detect_board_pose at 1920x1080, whole and by its own stages,
        # and the device stage's ops by CUDA events
        frame = frames["view0"]
        timer = StageTimer(sync=True, device=dev)
        total, device_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            ac.detect_board_pose(frame, cam, device=dev, timer=timer)
            total.append((time.perf_counter() - t0) * 1e3)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            frame_d = torch.from_numpy(frame).to(dev)
            start.record()
            aruco.threshold_maps(aruco.to_gray(frame_d))
            end.record()
            torch.cuda.synchronize()
            device_ms.append(start.elapsed_time(end))
        stages = {k: timer.totals[k] * 1e3 / timer.counts[k] for k in timer.totals}
        source = [(f, depth_c) for f in frames.values()]
        t0 = time.perf_counter()
        saved = ac.capture_ground_truth(source, cam, out_dir=os.path.join(tmp, "capture_all"), device=dev)
        capture_ms = (time.perf_counter() - t0) * 1e3 / len(source)
        check(saved == len(source), f"capture saved {saved} of {len(source)} frames")
        phase(13, f"detect_board_pose at 1920x1080 (view0, 35 markers), host clock: median "
                  f"{statistics.median(total):.3f} ms of 5; its stages, mean ms of 5 (StageTimer synchronised with "
                  "the card): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + f"; gray+threshold's device ops by CUDA events, median {statistics.median(device_ms):.3f} ms; "
                    f"capture {capture_ms:.1f} ms a frame over {len(source)} frames (detection, PNG and YAML "
                    f"writes) ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def write_ppm(path: str, bgr: np.ndarray) -> None:
    """A binary PPM (P6) of BGR uint8 [H, W, 3]."""
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (bgr.shape[1], bgr.shape[0]) + np.ascontiguousarray(bgr[:, :, ::-1]).tobytes())


def write_pgm16(path: str, gray: np.ndarray) -> None:
    """A binary 16-bit PGM (P5, big-endian samples) of uint16 [H, W]."""
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n65535\n" % (gray.shape[1], gray.shape[0]) + gray.astype(">u2").tobytes())


def write_bmp24(path: str, bgr: np.ndarray) -> None:
    """A 24-bit bottom-up BMP (BITMAPINFOHEADER, BI_RGB) of BGR uint8 [H, W, 3]."""
    h, w = bgr.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = bgr[::-1].reshape(h, -1)
    header = struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 54 + rows.size, 0, 0, 54, 40, w, h, 1, 24, 0, rows.size,
                         2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def imread_phase(dev, card: str) -> dict:
    """Phase 14: the other frame formats (progressive JPEG, TIFF, PNM, BMP)
    on the card's host, held to tests/goldens/imread_ref.npz (cv2 and JAX on
    the CPU), and `cli detect` / `cli evaluate` over them on the card.
    Returns the new CLI paths' 2.1 and 2.2 launches a frame."""
    import hashlib
    import re
    import shutil
    import tempfile

    from linemod_tpu_torch.pipeline.sensors import read_image
    from linemod_tpu_torch.utils.png import read_png, write_png

    ref = np.load(IMREAD_REF)
    # (a) every golden decodes to cv2's digest (none: cv2 gives nothing and
    # the reader raises); every refused file raises naming itself and its kind
    decoded = refused = 0
    for name, color_sha, gray_sha in zip(ref["names"], ref["color_sha256"], ref["gray_sha256"]):
        path = os.path.join(IMREAD_DIR, str(name))
        for mode, sha in (("color", str(color_sha)), ("anydepth", str(gray_sha))):
            try:
                got = hashlib.sha256(read_image(path, mode).tobytes()).hexdigest()
            except ValueError as e:
                got = f"raised: {e}"
            check(got == sha or (not sha and got.startswith(f"raised: {path}")), f"{name} {mode}: {got} != cv2's")
            decoded += bool(sha)
    for name, words in zip(ref["refused_names"], ref["refused_words"]):
        path = os.path.join(IMREAD_DIR, "refused", str(name))
        try:
            read_image(path, "color")
            check(False, f"{name}: a refused file decoded")
        except ValueError as e:
            check(re.search(re.escape(path) + ".*(" + str(words) + ")", str(e)) is not None, f"{name}: {e}")
        refused += 1
    phase(14, f"{decoded} decodes of {len(ref['names'])} golden files (progressive JPEG, TIFF, PNM, BMP, color "
              f"PNG as depth; color and gray) equal cv2's bit for bit, the rest raise where cv2 gives nothing; "
              f"{refused} refused kinds raise naming the file and the kind")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="imread-", dir=os.path.join(REPO, "build"))
    launches = {}
    try:
        color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
        depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
        pose = os.path.join(EXAMPLE, "benchmark", "pose0.yml")
        prog_jpg = os.path.join(JPEG_DIR, "fixture_progressive.jpg")
        # (b) the sequences of tests/test_torch_imread.sequences
        seqs = {"progressive": (os.path.join(tmp, "progressive"), ".jpg", ".tif"),
                "lossless": (os.path.join(tmp, "lossless"), ".img", ".img")}
        for folder, _, _ in seqs.values():
            os.makedirs(folder)
        for i, depth_name in enumerate(("fixture_depth_lzw.tif", "fixture_depth_deflate.tif")):
            shutil.copy(prog_jpg, os.path.join(tmp, "progressive", f"color{i}.jpg"))
            shutil.copy(os.path.join(IMREAD_DIR, depth_name), os.path.join(tmp, "progressive", f"depth{i}.tif"))
        lossless = os.path.join(tmp, "lossless")
        write_ppm(os.path.join(lossless, "color0.img"), color)
        write_bmp24(os.path.join(lossless, "color1.img"), color)
        for i in range(2):
            write_pgm16(os.path.join(lossless, f"depth{i}.img"), depth)
            for folder, _, _ in seqs.values():
                shutil.copy(pose, os.path.join(folder, f"pose{i}.yml"))
        check(np.array_equal(read_image(os.path.join(lossless, "color1.img"), "color"), color)
              and np.array_equal(read_image(os.path.join(lossless, "depth0.img"), "anydepth"), depth),
              "the full-frame BMP / PGM do not read back as the fixture's pixels")

        def argv(command, seq):
            folder, color_ext, depth_ext = seq
            return [command, "--model", "lagergehaeuse.ply", "--images", os.path.join(folder, f"color%d{color_ext}"),
                    "--depths", os.path.join(folder, f"depth%d{depth_ext}"), "--device", str(dev)] + (
                        ["--gt", "yml"] if command == "evaluate" else [])

        for seq_name, seq in seqs.items():
            for command in ("detect", "evaluate"):
                out, n, err = kept_launches(lambda: run_cli(argv(command, seq), EXAMPLE))
                text = re.sub(r"mean \d+\.\d ms \(\d+\.\d+ fps\)", "mean <t> ms (<f> fps)",
                              re.sub(r"in \d+\.\d ms", "in <t> ms", out))
                check(text.splitlines() == [str(v) for v in ref[f"{seq_name}_{command}_lines"]],
                      f"cli {command} over the {seq_name} sequence != JAX:\n{out}")
                check(n["coarse_scores"] == n["fine_scores"] == 2 and n["coarse_max"] == 0,
                      f"cli {command} over the {seq_name} sequence launches {n}")
                check(err["coarse_scores"] == err["fine_scores"] == 0, f"cli {command} {seq_name}: kernel != plain {err}")
                path = f"{seq_name} {command}"
                launches[path] = {"coarse": n["coarse_scores"] / 2, "fine": n["fine_scores"] / 2}
                phase(14, f"cli {command} over the {seq_name} sequence (2 frames: "
                          + ("progressive JPEG with LZW+predictor and Deflate TIFF depths" if seq_name == "progressive"
                             else "PPM and BMP with 16-bit PGM depths") + "): JAX's lines; launches a frame 2.1 "
                          f"{launches[path]['coarse']:g}, 2.2 {launches[path]['fine']:g}, max|kernel - plain| "
                          f"{max(err.values())}")

        # (c) host decode of the 640x480 fixture frame in each format
        frames = {"depth.tif (LZW+predictor)": os.path.join(IMREAD_DIR, "fixture_depth_lzw.tif"),
                  "depth.tif (Deflate)": os.path.join(IMREAD_DIR, "fixture_depth_deflate.tif"),
                  "depth.pgm (16-bit)": os.path.join(lossless, "depth0.img"),
                  "color.ppm": os.path.join(lossless, "color0.img"),
                  "color.bmp (24-bit)": os.path.join(lossless, "color1.img")}
        decode = {"color PNG": host_ms(lambda: read_image(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")),
                  "depth PNG": host_ms(lambda: read_image(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")),
                  "baseline JPEG 4:2:0 q95": host_ms(lambda: read_image(os.path.join(JPEG_DIR, "fixture_420.jpg"),
                                                                        "color")),
                  "progressive JPEG q80": host_ms(lambda: read_image(prog_jpg, "color"))}
        for label, path in frames.items():
            decode[label] = host_ms(lambda path=path, label=label: read_image(path, "anydepth" if "depth" in label
                                                                              else "color"))
        phase(14, "host decode of the 640x480 fixture frame on the card's host, median (min) ms of 20: " + ", ".join(
            f"{k} {v[0]:.3f} ({v[1]:.3f})" for k, v in decode.items()) + f" ({card})")

        # (d) cli evaluate's ms a frame over 3 progressive JPEG frames and 3
        # baseline ones (PNG depths), the 3-frame command less the 1-frame
        # command, in turns
        timed = {}
        for label, src in (("baseline", os.path.join(JPEG_DIR, "fixture_420.jpg")), ("progressive", prog_jpg)):
            folder = os.path.join(tmp, f"timed_{label}")
            os.makedirs(folder)
            for i in range(3):
                shutil.copy(src, os.path.join(folder, f"color{i}.jpg"))
                write_png(os.path.join(folder, f"depth{i}.png"), depth)
                shutil.copy(pose, os.path.join(folder, f"pose{i}.yml"))
            timed[label] = (folder, ".jpg", ".png")
        eval_ms = {"baseline": [], "progressive": []}
        for label in ("baseline", "progressive", "progressive", "baseline"):
            runs = []
            for max_frames in ("1", "0"):
                t0 = time.perf_counter()
                run_cli(argv("evaluate", timed[label]) + ["--max-frames", max_frames], EXAMPLE)
                runs.append((time.perf_counter() - t0) * 1e3)
            eval_ms[label].append((runs[1] - runs[0]) / 2)
        phase(14, "cli evaluate ms a frame (3 frames less 1, in turns baseline, progressive, progressive, "
                  f"baseline; 640x480 JPEG color, PNG depth): progressive {[round(v, 1) for v in eval_ms['progressive']]}, "
                  f"baseline {[round(v, 1) for v in eval_ms['baseline']]} ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


BENCH_TIMEOUT_S = 900
TOOL_TIMEOUT_S = 600
ONE_EACH = {"coarse_scores": 1, "fine_scores": 1, "coarse_max": 0}


def tools_phase(dev, card: str, cam, main_vsd: float, main_add: float) -> dict:
    """Phase 15: the measurement entry points on the card. Returns each
    tool's kernel launches a frame (a full match for profile_stages)."""
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.ops.detect_core import detect_frame
    from linemod_tpu_torch.tools import bench, bigbank_bench
    from linemod_tpu_torch.tools.fixture import OUT

    phase(15, "tools.bench in a process of its own, as a user runs it")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "linemod_tpu_torch.tools.bench"], cwd=REPO, capture_output=True,
                         text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"tools.bench exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    detail = json.loads(lines[-2])["detail"]
    gate = detail["gate"]
    phase(15, f"tools.bench ({seconds:.1f} s in its own process): metric {result['metric']}, gate VSD "
              f"{gate['vsd']:.5f} (phase 3: {main_vsd:.5f}), ADD {gate['add']:.4f} mm (phase 3: {main_add:.4f}); "
              f"headline launches a frame {detail['launches_a_frame']}")
    print(lines[-2])
    print(lines[-1], flush=True)
    check(set(result) == set(bench.RESULT_KEYS), f"tools.bench keys {sorted(result)}")
    check(all(result[k] is not None for k in bench.RESULT_KEYS), "tools.bench: a key is null")
    check(result["metric"] == "detector_fps_per_chip", f"tools.bench metric {result['metric']}")
    check(abs(gate["vsd"] - main_vsd) <= SCORE_ATOL and abs(gate["add"] - main_add) <= SCORE_ATOL,
          "tools.bench: VSD or ADD differs from phase 3's")
    check(detail["launches_a_frame"] == ONE_EACH, "tools.bench: 2.1 and 2.2 not once a frame")
    launches = {"bench": detail["launches_a_frame"]}

    def timed(name, argv=()):
        """Run tools.<name> in a process of its own, as a user runs it (a
        fresh process: a profiler session drops more records the more
        sessions its process has run); print its lines and return its last
        one, the results."""
        t_start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"linemod_tpu_torch.tools.{name}", *argv], cwd=REPO,
                              capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
        check(proc.returncode == 0, f"tools.{name} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                                    f"{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        print("\n".join(lines[:-1]))
        phase(15, f"tools.{' '.join([name, *argv])} ran in {time.perf_counter() - t_start:.1f} s in its own process")
        return json.loads(lines[-1])

    stages = timed("profile_stages")
    launches["profile_stages"] = stages["stages"][0]["launches"]
    check(stages["stages"][0]["name"] == "full match" and launches["profile_stages"] == ONE_EACH,
          "profile_stages: 2.1 and 2.2 not once a full match")
    check(all(row["device_ms"] is not None for row in stages["stages"]), "profile_stages: no device time")
    launches["profile_detect"] = timed("profile_detect")["launches_a_frame"]
    launches["profile_icp"] = timed("profile_icp")["launches_a_frame"]
    for row in timed("profile_multimodel")["multi"]:
        launches[f"profile_multimodel_{row['n_classes']}"] = row["launches_a_frame"]
    for tool in ("profile_detect", "profile_icp", "profile_multimodel_1", "profile_multimodel_2",
                 "profile_multimodel_3"):
        check(launches[tool] == ONE_EACH, f"{tool}: 2.1 and 2.2 not once a frame")
    for dual in (False, True):
        label = "subdiv 0" + (" dual" if dual else "")
        cache = bigbank_bench.cache_path(OUT, 0, dual)
        for path in (cache, cache + ".json"):  # generate on the card, never load an earlier run's bank
            if os.path.exists(path):
                os.remove(path)
        rows = timed("bigbank_bench", ("--subdivs", "0") + (("--dual",) if dual else ()))["configs"]
        (big,) = [r for r in rows if r["subdiv"] == 0 and r["dual_modality"] == dual]
        key = "bigbank_bench_s0" + ("_dual" if dual else "")
        launches[key] = big["launches_a_frame"]
        check(big["planned_templates"] == 1800 and big["n_templates"] > 0 and big["cut_exact"]
              and big["device_ms_a_frame"] is not None and big["generation_seconds"] is not None,
              f"bigbank_bench {label}: {big}")
        check(big["launches_a_frame"] == {"coarse_scores": 1, "fine_scores": 1, "coarse_max": 1},
              f"bigbank_bench {label}: 2.1, 2.2 and 2.3 not once a frame on the prefiltered cut")
        # the generated bank's prefiltered frame, each launch against its plain twin
        bank = TemplateBank.load(cache)
        state = bigbank_bench.bigbank_state(cam, bank, dev)
        features = state.off3_coarse.shape[1]
        check(bank.dual_modality == dual and state.cfg.dual_modality == dual and features == (128 if dual else 64),
              f"bigbank_bench {label}: the bank's layout (dual {bank.dual_modality}, F = {features})")
        frame = bigbank_bench.frame_inputs(cam, bank, dev)
        _, kept, err = kept_launches(lambda: detect_frame(state, *frame))
        phase(15, f"bigbank_bench {label} frame ({big['n_templates']} templates, F = {features}, t_fine "
                  f"{state.cfg.t_fine}): launches {kept}, max|kernel - plain| {err} ({card})")
        check(kept == big["launches_a_frame"] and max(err.values()) == 0, f"bigbank_bench {label}: a kernel != plain")
        del bank, state, frame
        torch.cuda.empty_cache()
    return launches


def quantizer_phase(dev, card: str, det, color, depth) -> dict:
    """Phase 2's quantizer (`csrc/quantize.cu`, `gradients.quantize_color_gradients`):
    both pyramid levels of the fixture frame, the kernel against the plain
    chain on the card bit for bit (orientations and magnitudes), the
    kernel's event and device ms beside its bound (bytes: the color read
    once, both outputs written once) and the plain version's; then the main
    path's launches a frame through `detect` (2: one a level). Returns the
    kernel's entry of the JSON line."""
    from linemod_tpu_torch.ops import gradients
    from linemod_tpu_torch.ops.extract import downsample2

    quantize = gradients.quantize_color_gradients
    colorf = torch.from_numpy(det.recenter(np.ascontiguousarray(color))).to(dev).float()
    levels = {
        "level 0": (lambda: quantize(colorf), lambda: gradients.quantize_color_gradients_plain(colorf)),
        "level 1": (lambda: quantize(colorf, half=True),
                    lambda: gradients.quantize_color_gradients_plain(downsample2(colorf))),
    }
    out = {}
    for label, (kernel, plain) in levels.items():
        (q, m), (pq, pm) = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(q, pq)
        bits = int((m.view(torch.int32) != pm.view(torch.int32)).sum())
        k_t, p_t = kernel_times(kernel), kernel_times(plain, PLAIN_LAUNCHES)
        moved = nbytes(colorf, q, m)
        bnd = bound(moved, 0)
        phase(2, f"quantizer {label}: {tuple(colorf.shape)} -> {tuple(q.shape)}; max|kernel-plain| {err}, "
                 f"magnitudes differing in their bits {bits}; kernel {fmt(k_t)}, plain {fmt(p_t)}, bound "
                 f"{bnd[0]:.6f} ms by {bnd[1]} ({moved} B) ({card})")
        check(err == 0 and bits == 0, f"quantizer {label}: kernel != plain")
        out[label] = {"max_abs_err": err, "ms": k_t[0], "device_ms": k_t[1], "plain_ms": p_t[0],
                      "plain_device_ms": p_t[1], "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": moved}
    frames = 8
    det.detect(color, depth, 1)
    torch.cuda.synchronize()
    quantize.launches = 0
    for _ in range(frames):
        det.detect(color, depth, 1)
    torch.cuda.synchronize()
    per_frame = quantize.launches / frames
    phase(2, f"quantizer launches a frame on the main path (detect, {frames} frames): {per_frame:g}")
    check(per_frame == 2, f"the main path launches the quantizer {per_frame:g} times a frame, want 2")
    return {"name": "gradient_quant", "route": "cuda", "source": "linemod_tpu_torch/csrc/quantize.cu",
            "replaces": "linemod_tpu/ops/gradients.py quantize_color_gradients (XLA operations, no Pallas kernel)",
            "launches": per_frame, "levels": out}


def card_and_build() -> str:
    """Phase 0 (the card's line, which it returns) and phase 1's build of
    every kernel source, with ptxas's registers and spills."""
    from linemod_tpu_torch.ops import cuda_lib

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    card = smi.splitlines()[0] if smi else "nvidia-smi unavailable"
    phase(0, f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_lib.build(cuda_lib.SOURCES)
    phase(1, f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, info in cuda_lib.build_info.items():
        print(f"  {name}: {info['path']} ({info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("  ptxas:", line.strip())
    return card


def quantizer_main() -> int:
    """`python3 chip_smoke.py --quantizer`: phases 0 and 1's build, then
    the quantizer's part of phase 2 alone and its JSON entry."""
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection
    from linemod_tpu_torch.utils.png import read_png

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_and_build()
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    det = PoseDetection(bank, cam, settings, props, dev)
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    print(json.dumps({"kernels": [quantizer_phase(dev, card, det, color, depth)]}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from linemod_tpu_torch.config import load_model_properties, load_settings
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.models.template_bank import TemplateBank, concat_banks, make_synthetic_bank
    from linemod_tpu_torch.ops import probes
    from linemod_tpu_torch.ops import matching as matching_mod
    from linemod_tpu_torch.ops import similarity_cuda as sc
    from linemod_tpu_torch.ops.detect_core import detect_frame
    from linemod_tpu_torch.ops.extract import downsample2
    from linemod_tpu_torch.ops.gradients import quantize_color_gradients
    from linemod_tpu_torch.ops.matching import (
        _planes_3d,
        _template_maxes,
        candidate_cut,
        candidate_cut_prefilter,
        coarse_similarity,
    )
    from linemod_tpu_torch.ops.metrics import OBJECT_DIAMETER, VSD_CORRECT
    from linemod_tpu_torch.ops.normals import quantize_normals
    from linemod_tpu_torch.ops.rasterizer import render_views
    from linemod_tpu_torch.pipeline.benchmark import Benchmark, model_vertices, read_ground_truth_pose, score_add
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection, make_match_config, resolve_prefilter_packed
    from linemod_tpu_torch.tools.coarse_max_split import scan_cases, synthetic_1280
    from linemod_tpu_torch.tools.fine_time import fine_cases, fine_edge_cases, fine_work
    from linemod_tpu_torch.utils.mesh_io import load_mesh
    from linemod_tpu_torch.utils.ply import load_ply
    from linemod_tpu_torch.utils.png import read_png

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_and_build()
    sc.load_library()
    probes.load_library()

    # -- phase 1: the banks
    cam, settings = load_settings(os.path.join(EXAMPLE, "linemod_settings.yml"))
    props = load_model_properties(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"))
    bank = TemplateBank.load(os.path.join(EXAMPLE, "banks", "lagergehaeuse.npz"))
    color = read_png(os.path.join(EXAMPLE, "benchmark", "img0.png"), "color")
    depth = read_png(os.path.join(EXAMPLE, "benchmark", "depth0.png"), "anydepth")
    ref = np.load(TORCH_REF)
    big_ref = np.load(BIGBANK_REF)
    det = PoseDetection(bank, cam, settings, props, dev)
    state = det.state
    cfg = state.cfg
    t0 = time.perf_counter()
    big_bank, _ = concat_banks(
        [bank, make_synthetic_bank(94350, seed=7, bbox_wh=64, image_wh=(640, 480))]
    )
    det_big = PoseDetection(big_bank, cam, settings, props, dev)
    big_state = det_big.state
    torch.cuda.synchronize()
    phase(1, f"{big_bank.num_templates}-template bank and its match state ({big_state.n_templates} "
             f"padded) built in {time.perf_counter() - t0:.2f} s")
    check(big_bank.num_templates == 96300 and big_state.n_templates == 96512, "96,300 bank size")
    t0 = time.perf_counter()
    dual_bank = TemplateBank.load(os.path.join(EXAMPLE, "banks_dual", "lagergehaeuse.npz"))
    det_dual = PoseDetection(dual_bank, cam, dataclasses.replace(settings, only_color_modality=False), props, dev)
    dual_state = det_dual.state
    dual_cfg = dual_state.cfg
    dual_ref = np.load(DUAL_REF)
    torch.cuda.synchronize()
    phase(1, f"dual bank ({dual_bank.num_templates} templates, {dual_state.n_templates} padded, "
             f"t_fine {dual_cfg.t_fine}) and its match state built in {time.perf_counter() - t0:.2f} s")
    check(dual_bank.num_templates == 1950 and dual_state.n_templates == 2048 and dual_cfg.dual_modality
          and dual_cfg.t_fine == 5, "dual bank and config")
    color_c = det.recenter(np.ascontiguousarray(color))
    colorf = torch.from_numpy(color_c).to(dev).float()
    depth_c = det.recenter(np.ascontiguousarray(depth))
    depthf = torch.from_numpy(depth_c.astype(np.float32)).to(dev)

    # -- phase 2: kernels against their plain versions
    fine_p = _planes_3d(colorf, cfg.t_fine, state.max_cells_fine)
    coarse_p = _planes_3d(downsample2(colorf), cfg.t_coarse, state.max_cells_coarse)
    big_coarse_p = _planes_3d(downsample2(colorf), cfg.t_coarse, big_state.max_cells_coarse)
    ch, cw = state.coarse_shape[:2]
    n, f = state.off3_coarse.shape[:2]
    nm = big_state.off3_coarse.shape[0]

    big, big_color = synthetic_1280(dev)
    big_cfg = big.cfg
    big_coarse = _planes_3d(downsample2(big_color), big_cfg.t_coarse, big.max_cells_coarse)
    bch, bcw = big.coarse_shape[:2]

    def live_lookups(off3, planes_, cells):
        """Lookups this run's data needs: features off the zero plane x cells."""
        return int((off3[..., 0] < planes_.shape[0] - 1).sum().item()) * cells

    # the coarse scan (2.1) at the shapes its paths give it: the main path,
    # the large-bank rescan of the 1,024 templates the prefiltered cut
    # selects on this frame, a streaming chunk, and 1280x960; the rescan and
    # the chunk take the state's plan cut by rows on the card
    scan_times, err_c = {}, 0
    for label, (planes_s, st_s) in scan_cases(dev, state, coarse_p, big_state, big_coarse_p, big,
                                              big_color).items():
        sch, scw = st_s.coarse_shape[:2]
        plan_s = st_s.coarse_plan
        args_s = (planes_s, st_s.off3_coarse, sch, scw)
        err_s = max_abs_err(sc.coarse_scores(*args_s, plan=plan_s), sc.coarse_scores_plain(*args_s))
        scan_times[label] = kernel_times(lambda a=args_s, p=plan_s: sc.coarse_scores(*a, plan=p))
        split = sc.coarse_split(plan_s, dev)
        active = sc.active_clusters(dev, split, plan_s.scan_smem())
        lookups = live_lookups(st_s.off3_coarse, planes_s, sch * scw)
        phase(2, f"coarse_scores, {label}: planes {tuple(planes_s.shape)} x {tuple(st_s.off3_coarse.shape)} "
                 f"-> [{st_s.off3_coarse.shape[0]}, {sch}, {scw}] max|kernel-plain| {err_s}; kernel "
                 f"{fmt(scan_times[label])} ({card})")
        groups = plan_s.groups(sc.SCAN_UNITS_PER_BLOCK)
        print(f"  design: {sc.SCAN_UNITS_PER_BLOCK} templates of one of {plan_s.row_bands * plan_s.col_bands} "
              f"bands a group, {groups} groups x split S {split} = {groups * split} blocks "
              f"({active} clusters of {split} at once), {plan_s.chunks} chunks of {plan_s.chunk_planes} "
              f"planes, {plan_s.staged_bytes(sc.SCAN_UNITS_PER_BLOCK)[1]} B staged in all, {lookups} lookups, "
              f"{lookups / scan_times[label][0] / 1e9:.3f} G lookups/ms")
        err_c = max(err_c, err_s)
    check(err_c == 0, "coarse_scores kernel != plain")
    quantizer = quantizer_phase(dev, card, det, color, depth)

    coarse_args = (coarse_p, state.off3_coarse, ch, cw)
    # the fine refine (2.2) at its four shapes: the main path's (the
    # fixture's candidates), 1280x960, the dual shape (synthetic) and K=2,048;
    # then its edge cases; the bound counts the distinct plane bytes the
    # windows read, with the whole planes' figure beside it
    fine_shapes = fine_cases(dev, state, fine_p, coarse_p, int(bank.bbox[:, 2:4].max()), big, big_color)
    fine_args = next(iter(fine_shapes.values()))  # the main path's: the frame's cut
    _, _, cand_t, base_yx, win = fine_args
    k = cand_t.shape[0]
    err_f, fine_times, fine_bounds = 0, {}, {}
    for label, args_f in {**fine_shapes, **fine_edge_cases(dev)}.items():
        got_f = sc.fine_scores(*args_f)
        err = max_abs_err(got_f, sc.fine_scores_plain(*args_f))
        err_f = max(err_f, err)
        lanes_row, slices = sc.fine_layout(args_f[4])
        shape_f = (f"planes {tuple(args_f[0].shape)} x {tuple(args_f[1].shape)}, K={args_f[2].shape[0]}, "
                   f"win {args_f[4]} ({lanes_row} lanes a row, {slices} slices)")
        if label.startswith("planes of 4"):
            check(int(got_f.min()) == int(got_f.max()) == 4 * args_f[1].shape[1], f"fine edge case {label}")
        if label not in fine_shapes:
            print(f"  fine edge case {label}: {shape_f}; max|kernel-plain| {err}, max {int(got_f.max())}")
            continue
        work = fine_work(*args_f)
        fine_times[label] = kernel_times(lambda a=args_f: sc.fine_scores(*a))
        fine_bounds[label] = bound(work["bytes"], work["adds"])
        whole = bound(work["whole_bytes"], work["adds"])
        phase(2, f"fine_scores, {label}: {shape_f}; max|kernel-plain| {err}; kernel {fmt(fine_times[label])}; "
                 f"bound {fine_bounds[label][0]:.6f} ms by {fine_bounds[label][1]} ({work['touched']} distinct "
                 f"plane bytes, {work['bytes']} B, {work['adds']} adds; with the whole planes "
                 f"{whole[0]:.6f} ms) ({card})")
    check(err_f == 0, "fine_scores kernel != plain")
    torch.cuda.synchronize()
    times = {
        "coarse": (next(iter(scan_times.values())),
                   kernel_times(lambda: sc.coarse_scores_plain(*coarse_args), PLAIN_LAUNCHES)),
        "fine": (fine_times[next(iter(fine_shapes))],
                 kernel_times(lambda: sc.fine_scores_plain(*fine_args), PLAIN_LAUNCHES)),
    }
    bounds = {
        "coarse": bound(nbytes(coarse_p, state.off3_coarse) + 4 * n * ch * cw,
                        live_lookups(state.off3_coarse, coarse_p, ch * cw) / 4),
        "fine": fine_bounds[next(iter(fine_shapes))],
    }
    # the nearest single PyTorch call: embedding_bag's sum over a materialised
    # [rows, F] index into the planes as a float column (index built untimed)
    coarse_idx = (sc._flat_offsets(coarse_p, state.off3_coarse)[:, None, :]
                  + (torch.arange(ch, device=dev)[:, None] * coarse_p.shape[2]
                     + torch.arange(cw, device=dev)[None, :]).reshape(1, -1, 1)).reshape(-1, f)
    sub = (torch.arange(win, device=dev)[:, None] * fine_p.shape[2]
           + torch.arange(win, device=dev)[None, :]).reshape(1, -1, 1)
    fine_base = (base_yx[:, 0].long() * fine_p.shape[2] + base_yx[:, 1].long())[:, None, None]
    fine_idx = (sc._flat_offsets(fine_p, state.off3_fine[cand_t.long()])[:, None, :]
                + fine_base + sub).reshape(-1, f)
    coarse_w = coarse_p.reshape(-1, 1).float()
    fine_w = fine_p.reshape(-1, 1).float()
    emb = torch.nn.functional.embedding_bag
    lib_c = emb(coarse_idx, coarse_w, mode="sum").reshape(n, ch, cw)
    lib_f = emb(fine_idx, fine_w, mode="sum").reshape(k, win, win)
    check(max_abs_err(lib_c, sc.coarse_scores(*coarse_args, plan=state.coarse_plan)) == 0,
          "embedding_bag != coarse kernel")
    check(max_abs_err(lib_f, sc.fine_scores(*fine_args)) == 0, "embedding_bag != fine kernel")
    library = {
        "coarse": kernel_times(lambda: emb(coarse_idx, coarse_w, mode="sum"), PLAIN_LAUNCHES),
        "fine": kernel_times(lambda: emb(fine_idx, fine_w, mode="sum")),
    }
    del coarse_idx, fine_idx, lib_c, lib_f
    phase(2, "fixture shapes: the kernels, their plain versions and their library calls")
    for name, (k_t, p_t) in times.items():
        print(f"  {name}: kernel {fmt(k_t)}, plain {fmt(p_t)}, embedding_bag {fmt(library[name])}, "
              f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]} ({card})")

    # the masked max at the 96,300 bank's state and at 1280x960; some
    # templates get bounds that fit no cell, so -1 is exercised
    def no_fit(lim_t, rows):
        lim_t = lim_t.clone()
        lim_t[rows[0]] = 0
        lim_t[rows[1], 0] = 0
        lim_t[rows[2], 1] = -3
        return lim_t

    plan = big_state.coarse_plan
    max_lim = no_fit(big_state.lim_coarse, (5, 40000, 96299))
    max_args = (big_coarse_p, big_state.off3_coarse, max_lim, ch, cw)
    got_max = sc.coarse_max(*max_args, plan=plan)
    err_m = max_abs_err(got_max, sc.coarse_max_plain(*max_args))
    check(bool((got_max[[5, 40000, 96299]] == -1).all()), "no-fit templates must give -1")
    max_times = (kernel_times(lambda: sc.coarse_max(*max_args, plan=plan)),
                 kernel_times(lambda: sc.coarse_max_plain(*max_args), PLAIN_LAUNCHES))
    # what this run's data needs: each template's features off the zero
    # plane, at each cell of its fit box, 4 cells per packed add
    live = (big_state.off3_coarse[..., 0] < big_coarse_p.shape[0] - 1).sum(1)
    lookups = fitting_cells(max_lim, ch, cw, live)
    bounds["coarse_max"] = bound(nbytes(big_coarse_p, big_state.off3_coarse, max_lim) + 4 * nm, lookups / 4)
    big_max_args = (big_coarse, big.off3_coarse, no_fit(big.lim_coarse, (0, 1, 2047)), bch, bcw)
    err_bm = max_abs_err(sc.coarse_max(*big_max_args, plan=big.coarse_plan), sc.coarse_max_plain(*big_max_args))
    big_max_t = kernel_times(lambda: sc.coarse_max(*big_max_args, plan=big.coarse_plan))
    group, staged = plan.staged_bytes()
    phase(2, f"coarse_max: fixture coarse planes x {tuple(big_state.off3_coarse.shape)} -> [{nm}] "
             f"max|kernel-plain| {err_m}; kernel {fmt(max_times[0])}, plain {fmt(max_times[1])}, "
             f"bound {bounds['coarse_max'][0]:.4f} ms by {bounds['coarse_max'][1]}; "
             f"1280x960 x 2048 max|kernel-plain| {err_bm}, kernel {fmt(big_max_t)}, "
             f"{big.coarse_plan.chunks} chunks ({card})")
    print(f"  coarse_max design: {sc.UNITS_PER_BLOCK} templates of one of {plan.row_bands * plan.col_bands} "
          f"bands a group, {plan.chunks} chunks of {plan.chunk_planes} planes, staged rows {plan.stage_rows} x "
          f"{4 * plan.pitch} B, {group} B staged a group, {staged} B staged in all (~ the L2 reads), "
          f"{lookups} lookups, {lookups / max_times[0][0] / 1e9:.3f} G lookups/ms")
    check(err_m == 0 and err_bm == 0, "coarse_max kernel != plain")

    # the edge cases of both coarse kernels on the fixture's coarse planes
    rng_e = np.random.default_rng(11)
    n_e, p_e = 4096, big_coarse_p.shape[0] - 1

    def edge_bank(f_e, one_plane=False, shifts=True):
        planes_e = rng_e.integers(0, p_e, (n_e, 1 if one_plane else f_e)).repeat(f_e if one_plane else 1, 1)
        sy = rng_e.integers(0, 8, (n_e, f_e)) if shifts else np.zeros((n_e, f_e), np.int64)
        sx = rng_e.integers(0, 8, (n_e, f_e)) if shifts else np.zeros((n_e, f_e), np.int64)
        lim_e = np.stack([rng_e.integers(1, ch + 1, n_e), rng_e.integers(1, cw + 1, n_e)], 1)
        lim_e[:4] = [[99, 99], [0, 5], [-3, 4], [5, -1]]
        return (torch.from_numpy(np.stack([planes_e, sy, sx], -1).astype(np.int32)).to(dev),
                torch.from_numpy(lim_e.astype(np.int32)).to(dev))

    full4 = torch.zeros_like(big_coarse_p)
    full4[:-1, :ch, :cw] = 4
    narrow_off3, narrow_lim = edge_bank(64)
    narrow_lim[4:, 1] = torch.arange(n_e - 4, device=dev, dtype=torch.int32) % 7 + 1
    zero_off3, zero_lim = edge_bank(64)
    zero_off3[:, ::2, 0] = p_e
    zero_off3[7, :, 0] = p_e
    edges = {
        "planes of 4, F=64 (256)": (full4, *edge_bank(64, shifts=False)),
        "planes of 4, F=128 (512)": (full4, *edge_bank(128, shifts=False)),
        "all 64 features on one plane": (big_coarse_p, *edge_bank(64, one_plane=True)),
        "F=128": (big_coarse_p, *edge_bank(128)),
        "half the features on the zero plane": (big_coarse_p, zero_off3, zero_lim),
        "fit-box widths 1-7, sx 0-7": (big_coarse_p, narrow_off3, narrow_lim),
    }
    for name, (planes_e, off3_e, lim_e) in edges.items():
        got_e = sc.coarse_max(planes_e, off3_e, lim_e, ch, cw)
        err_e = max_abs_err(got_e, sc.coarse_max_plain(planes_e, off3_e, lim_e, ch, cw))
        ok_e = err_e == 0 and bool((got_e[1:4] == -1).all()) and int(got_e[0]) >= 0
        got_s = sc.coarse_scores(planes_e, off3_e, ch, cw)
        err_s = max_abs_err(got_s, sc.coarse_scores_plain(planes_e, off3_e, ch, cw))
        if name.startswith("planes of 4"):
            ok_e = ok_e and int(got_e.max()) == int(got_s.max()) == 4 * off3_e.shape[1]
        print(f"  edge case {name}: {n_e} templates, lim beyond/0/negative included; coarse_max "
              f"max|kernel-plain| {err_e}, max {int(got_e.max())}; coarse_scores max|kernel-plain| "
              f"{err_s}, max {int(got_s.max())}")
        check(ok_e and err_s == 0, f"edge case {name}")
        err_m = max(err_m, err_e)
        err_c = max(err_c, err_s)

    # the three kernels at the dual fixture's shapes: the frame's real planes
    # of color gradients and depth normals (coarse [1025, rows, stride], fine
    # [401, rows, stride]), the dual state's triplets and plan, and the dual
    # cut's candidates at window 4
    dual_fine_p = _planes_3d(colorf, dual_cfg.t_fine, dual_state.max_cells_fine, depthf)
    dual_coarse_p = _planes_3d(downsample2(colorf), dual_cfg.t_coarse, dual_state.max_cells_coarse,
                               depthf[::2, ::2])
    dch, dcw = dual_state.coarse_shape[:2]
    dn = dual_state.off3_coarse.shape[0]
    dplan = dual_state.coarse_plan
    dual_scan_args = (dual_coarse_p, dual_state.off3_coarse, dch, dcw)
    dual_max_args = (dual_coarse_p, dual_state.off3_coarse, dual_state.lim_coarse, dch, dcw)
    _, dcand_t, dgy, dgx = candidate_cut(coarse_similarity(dual_state, dual_coarse_p), dcw, dual_cfg.top_k)
    dspan = 2 * dual_cfg.t_coarse
    dual_fine_args = (dual_fine_p, dual_state.off3_fine, dcand_t.int(),
                      torch.stack([dgy * dspan // dual_cfg.t_fine, dgx * dspan // dual_cfg.t_fine], 1).int(),
                      -(-dspan // dual_cfg.t_fine))
    dual_err = {
        "coarse": max_abs_err(sc.coarse_scores(*dual_scan_args, plan=dplan), sc.coarse_scores_plain(*dual_scan_args)),
        "coarse_max": max_abs_err(sc.coarse_max(*dual_max_args, plan=dplan), sc.coarse_max_plain(*dual_max_args)),
        "fine": max_abs_err(sc.fine_scores(*dual_fine_args), sc.fine_scores_plain(*dual_fine_args)),
    }
    dual_times = {
        "coarse": (kernel_times(lambda: sc.coarse_scores(*dual_scan_args, plan=dplan)),
                   kernel_times(lambda: sc.coarse_scores_plain(*dual_scan_args), PLAIN_LAUNCHES)),
        "coarse_max": (kernel_times(lambda: sc.coarse_max(*dual_max_args, plan=dplan)),
                       kernel_times(lambda: sc.coarse_max_plain(*dual_max_args), PLAIN_LAUNCHES)),
        "fine": (kernel_times(lambda: sc.fine_scores(*dual_fine_args)),
                 kernel_times(lambda: sc.fine_scores_plain(*dual_fine_args), PLAIN_LAUNCHES)),
    }
    dual_work = fine_work(*dual_fine_args)
    dual_live = (dual_state.off3_coarse[..., 0] < dual_coarse_p.shape[0] - 1).sum(1)
    dual_lookups = live_lookups(dual_state.off3_coarse, dual_coarse_p, dch * dcw)
    dual_max_lookups = fitting_cells(dual_state.lim_coarse, dch, dcw, dual_live)
    dual_bounds = {
        "coarse": bound(nbytes(dual_coarse_p, dual_state.off3_coarse) + 4 * dn * dch * dcw, dual_lookups / 4),
        "coarse_max": bound(nbytes(dual_coarse_p, dual_state.off3_coarse, dual_state.lim_coarse) + 4 * dn,
                            dual_max_lookups / 4),
        "fine": bound(dual_work["bytes"], dual_work["adds"]),
    }
    dual_split = sc.coarse_split(dplan, dev)
    dual_groups = dplan.groups(sc.SCAN_UNITS_PER_BLOCK)
    shapes = {
        "coarse": f"coarse_scores: planes {tuple(dual_coarse_p.shape)} x {tuple(dual_state.off3_coarse.shape)} "
                  f"-> [{dn}, {dch}, {dcw}]",
        "coarse_max": f"coarse_max: the same -> [{dn}]",
        "fine": f"fine_scores: planes {tuple(dual_fine_p.shape)} x {tuple(dual_state.off3_fine.shape)}, "
                f"K={dcand_t.shape[0]}, win {dual_fine_args[4]} ({dual_work['touched']} distinct plane bytes)",
    }
    phase(2, "dual fixture shapes (color gradients and depth normals): the kernels and their plain versions")
    for name in ("coarse", "coarse_max", "fine"):
        print(f"  {shapes[name]}: max|kernel-plain| {dual_err[name]}; kernel {fmt(dual_times[name][0])}, plain "
              f"{fmt(dual_times[name][1])}, bound {dual_bounds[name][0]:.6f} ms by {dual_bounds[name][1]} ({card})")
    print(f"  scan design: {sc.SCAN_UNITS_PER_BLOCK} templates of one of {dplan.row_bands * dplan.col_bands} bands "
          f"a group, {dual_groups} groups x split S {dual_split} = {dual_groups * dual_split} blocks, "
          f"{dplan.chunks} chunks of {dplan.chunk_planes} planes, staged rows {dplan.stage_rows} x "
          f"{4 * dplan.pitch} B, {dplan.staged_bytes(sc.SCAN_UNITS_PER_BLOCK)[1]} B staged in all, "
          f"{dual_lookups} lookups, {dual_lookups / dual_times['coarse'][0][0] / 1e9:.3f} G lookups/ms")
    print(f"  masked max design: {sc.UNITS_PER_BLOCK} templates a group, {dplan.groups()} groups, "
          f"{dplan.staged_bytes()[0]} B staged a group, {dplan.staged_bytes()[1]} B in all, "
          f"{dual_max_lookups} lookups, {dual_max_lookups / dual_times['coarse_max'][0][0] / 1e9:.3f} G lookups/ms")
    check(dplan.planes_shape[0] == 1025 and dual_fine_p.shape[0] == 401
          and tuple(dual_state.off3_coarse.shape) == (2048, 128, 3), "the dual shapes")
    check(max(dual_err.values()) == 0, "a kernel != plain at the dual shapes")

    # -- phase 3: the main path, the fixture end to end
    q0 = quantize_color_gradients(colorf)[0].cpu().numpy()
    q1 = quantize_color_gradients(downsample2(colorf))[0].cpu().numpy()
    mism0 = int((q0 != ref["quant0"]).sum())
    mism1 = int((q1 != ref["quant1"]).sum())
    check(np.array_equal(ref["quant0"], np.load(GOLDEN)["quant"]), "golden quant maps disagree")
    phase(3, f"quantized maps vs golden: {mism0} of {q0.size} level-0 and {mism1} of {q1.size} "
             f"level-1 pixels differ")
    check(mism0 == 0 and mism1 == 0, "the card's quantized maps differ from the golden")

    # no path may build a kernel plan per frame: the plans built from here
    # on are counted (the states built theirs in phase 1)
    plans_built = []
    build_plan = sc.coarse_max_plan

    def counting_plan(*args, **kwargs):
        plans_built.append(tuple(args[0].shape))
        return build_plan(*args, **kwargs)

    sc.coarse_max_plan = matching_mod.coarse_max_plan = counting_plan
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    handle = det.detect_submit(color, depth)
    packed = handle[0].cpu().numpy()
    poses = det.detect_collect(handle, 1)
    launches = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches}
    phase(3, f"main path launches: coarse_scores {launches['coarse']}, fine_scores {launches['fine']}, "
             f"coarse_max {sc.coarse_max.launches}; kernel plans built {len(plans_built)}")
    check(launches["coarse"] > 0 and launches["fine"] > 0, "a kernel was not launched on the main path")
    check(not plans_built, "the main path built a kernel plan")

    ints_equal = np.array_equal(packed[:, [0, 1, 2, 4]], ref["packed"][:, [0, 1, 2, 4]])
    sim_err = float(np.abs(packed[:, 3] - ref["packed"][:, 3]).max())
    n_valid = int(packed[:, 4].sum())
    phase(3, f"packed {list(packed.shape)} vs JAX reference: ints equal {ints_equal}, "
             f"max|sim diff| {sim_err:.3g}, {n_valid} valid")
    check(packed.shape == (512, 5) and ints_equal and sim_err <= SIM_ATOL,
          "packed candidates differ from the JAX reference")
    top = packed[packed[:, 4] > 0.5][:8]
    top_err = float(np.abs(top - np.load(GOLDEN)["top_matches"]).max())
    phase(3, f"top 8 vs golden top_matches: max|diff| {top_err:.3g}")
    check(top.shape == (8, 5) and top_err <= SIM_ATOL, "top 8 differ from the golden")

    gt = read_ground_truth_pose(os.path.join(EXAMPLE, "benchmark", "pose0.yml"))
    verts = model_vertices(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply"), dev)

    def check_pose(poses_, want, label, n_phase):
        """The pose gate; returns the pose's ADD."""
        check(len(poses_) == 1, f"{label}: {len(poses_)} poses detected")
        pose = poses_[0]
        dt = float(np.abs(pose.translation - want["translation"]).max())
        dq = float(np.abs(pose.quaternion - want["quaternion"]).max())
        add = score_add(verts, gt, pose)
        phase(n_phase, f"{label} pose t={np.round(pose.translation, 3).tolist()} mm: max|dt| {dt:.3g} mm, "
              f"max|dq| {dq:.3g} vs JAX; ADD {add:.3f} mm vs ground truth")
        check(dt <= 0.5 and dq <= 1e-4, f"{label}: pose differs from the JAX pose")
        check(add <= OBJECT_DIAMETER, f"{label}: ADD {add} mm > {OBJECT_DIAMETER}")
        return add

    main_add = check_pose(poses, ref, "main path", 3)

    # the pose scored with VSD on the card; the card's render of the ground
    # truth against JAX's
    bench = Benchmark(load_ply(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")), cam, dev)
    scene = depth_c.astype(np.float32)

    def check_vsd(pose, want, label, n_phase):
        """The VSD gate; returns the pose's VSD."""
        vsd = bench.score_vsd(scene, gt, pose)
        phase(n_phase, f"{label} pose VSD {vsd:.5f} vs ground truth (JAX's {float(want):.5f})")
        check(vsd < VSD_CORRECT, f"{label}: VSD {vsd} >= {VSD_CORRECT}")
        check(abs(vsd - float(want)) <= SCORE_ATOL, f"{label}: VSD differs from JAX's")
        return vsd

    main_vsd = check_vsd(poses[0], dual_ref["color_vsd"], "main path", 3)
    render0 = bench.render(gt).cpu().numpy()
    want0 = dual_ref["render0"]
    covered = int((want0 > 0).sum())
    cov_diff = int(((render0 > 0) != (want0 > 0)).sum())
    both = (render0 > 0) & (want0 > 0)
    depth_diff = float(np.abs(render0 - want0)[both].max())
    render_ms = cuda_ms(lambda: bench.render(gt), reps=5)
    views = render_views(bench.marr, gt.rotation_matrix()[None], gt.translation[None], cam)
    phase(3, f"render of pose0 vs JAX: {cov_diff} of {covered} covered pixels differ in coverage, max|depth "
             f"diff| {depth_diff:.4f} mm where both cover; {render_ms:.3f} ms a render (median of 5; {card}); "
             f"render_views equals the render: {np.array_equal(views[0].cpu().numpy(), render0)}")
    check(cov_diff <= RENDER_COVERAGE * covered and depth_diff <= RENDER_ATOL_MM, "the render differs from JAX's")
    check(views.shape == (1, cam.height, cam.width) and np.array_equal(views[0].cpu().numpy(), render0),
          "render_views differs from the single render")

    # -- phase 4: a few requests on the main path
    def frame_program(detector):
        """The detector's per-frame device program on the fixture frame,
        uploaded once: fn(state=detector.state) -> packed tensor."""
        color_t, depth_t = detector.upload(detector.recenter(color), detector.recenter(depth))
        return lambda st=detector.state: detect_frame(st, color_t, depth_t)

    def request_times(detector, reps):
        dev_ms, post_ms, detect_ms = [], [], []
        depth_c = detector.recenter(np.ascontiguousarray(depth))
        program = frame_program(detector)
        for _ in range(reps):
            t0 = time.perf_counter()
            detector.detect(color, depth, 1)
            torch.cuda.synchronize()
            detect_ms.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            packed_t = program()
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            detector.detect_collect((packed_t, color_c, depth_c), 1)
            post_ms.append((time.perf_counter() - t0) * 1e3)
        return {k_: statistics.median(v) for k_, v in
                (("device", dev_ms), ("post", post_ms), ("detect", detect_ms))}

    def report_profile(n_phase, label, detector, device_ms):
        busy, count, top = profile_frames(frame_program(detector))
        phase(n_phase, f"{label} profile (torch.profiler, 5 frames): " + busy_text(busy, count, device_ms,
                                                                                  "detect_frame")
                       + "; top: " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top))

    frame = torch.from_numpy(color_c).to(dev)
    med = request_times(det, REPS)
    phase(4, f"{REPS} detect calls: detect_frame device {med['device']:.3f} ms, host post "
             f"{med['post']:.3f} ms, whole detect {med['detect']:.3f} ms (medians; {card})")
    report_profile(4, "main path", det, med["device"])

    # -- phase 5: the large-bank path
    big_cfg5 = big_state.cfg
    check((big_cfg5.prefilter_sel, big_cfg5.scan_chunk) == (1024, 4096), f"large-bank config {big_cfg5}")
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    plans_built.clear()
    handle = det_big.detect_submit(color, depth)
    big_packed = handle[0].cpu().numpy()
    big_poses = det_big.detect_collect(handle, 1)
    big_launches = {"coarse_max": sc.coarse_max.launches, "coarse": sc.coarse_scores.launches,
                    "fine": sc.fine_scores.launches}
    phase(5, f"large-bank path launches: {big_launches}, retries {det_big.retries}")
    check(min(big_launches.values()) > 0, "a kernel was not launched on the large-bank path")
    check(det_big.retries == 0, "the fixture frame's prefiltered cut was not proved exact")
    ints_equal = np.array_equal(big_packed[:, [0, 1, 2, 4]], big_ref["packed"][:, [0, 1, 2, 4]])
    sim_err = float(np.abs(big_packed[:, 3] - big_ref["packed"][:, 3]).max())
    phase(5, f"packed {list(big_packed.shape)} vs JAX golden: ints equal {ints_equal}, max|sim diff| "
             f"{sim_err:.3g}, cut_exact {big_packed[-1, 0]:.0f}, {int(big_packed[:, 4].sum())} valid")
    check(big_packed.shape == (513, 5) and ints_equal and sim_err <= SIM_ATOL and big_packed[-1, 0] == 1.0,
          "large-bank packed candidates differ from the JAX golden")
    maxes = _template_maxes(big_state, big_coarse_p).cpu().numpy()
    cut = candidate_cut_prefilter(big_state, big_coarse_p, big_cfg5.top_k)
    cut_equal = {name: np.array_equal(a.cpu().numpy(), big_ref[name].astype(a.cpu().numpy().dtype))
                 for name, a in zip(("top_sim", "cand_t", "cand_gy", "cand_gx"), cut[:4])}
    phase(5, f"template maxes {list(maxes.shape)} equal the golden's: {np.array_equal(maxes, big_ref['maxes'])}; "
             f"cut arrays equal: {cut_equal}; exact {bool(cut[4])}")
    check(np.array_equal(maxes, big_ref["maxes"]) and all(cut_equal.values()) and bool(cut[4]),
          "template maxes or cut arrays differ from the JAX golden")
    check_pose(big_poses, big_ref, "large-bank", 5)

    other, cut_launches = {}, {}
    for label, over in (("streaming", dict(prefilter_sel=0, scan_chunk=4096)),
                        ("dense", dict(prefilter_sel=0, scan_chunk=0))):
        st = dataclasses.replace(big_state, cfg=dataclasses.replace(big_cfg5, **over))
        sc.coarse_scores.launches = 0
        got = detect_frame(st, frame).cpu().numpy()
        cut_launches[label] = sc.coarse_scores.launches
        check(np.array_equal(got, big_packed[:-1]), f"the {label} cut differs from the prefiltered cut")
        other[label] = cuda_ms(lambda st=st: detect_frame(st, frame), reps=3)
    chunk = min(big_cfg5.scan_chunk, nm)
    while nm % chunk:  # candidate_cut_streaming's chunk: a divisor of N
        chunk -= 1
    phase(5, f"the streaming and dense cuts give the prefiltered cut's packed [512, 5] exactly; "
             f"coarse_scores launches a frame: streaming {cut_launches['streaming']} (chunks of {chunk}), "
             f"dense {cut_launches['dense']}; kernel plans built on the large-bank paths {len(plans_built)}; "
             f"one frame: streaming {other['streaming']:.3f} ms, dense {other['dense']:.3f} ms "
             f"(CUDA events, median of 3; {card})")
    check(cut_launches == {"streaming": nm // chunk, "dense": 1}, "the cuts' coarse_scores launches")
    check(not plans_built, "a large-bank path built a kernel plan")
    sc.coarse_max_plan = matching_mod.coarse_max_plan = build_plan
    big_med = request_times(det_big, REPS)
    phase(5, f"{REPS} large-bank detect calls: detect_frame device {big_med['device']:.3f} ms, host post "
             f"{big_med['post']:.3f} ms, whole detect {big_med['detect']:.3f} ms (medians; {card})")
    report_profile(5, "large-bank path", det_big, big_med["device"])

    # a saturated cut: identical templates tie every maximum at the selection
    # boundary, threshold 0 keeps it above the threshold
    sat_cam = CameraParameters(fx=500.0, fy=500.0, cx=160.0, cy=120.0, width=320, height=240)
    sat_settings = TemplateSettings(detector_threshold=0.0, use_depth_improvement=False)
    sat_bank = make_synthetic_bank(64, seed=9, bbox_wh=48, image_wh=(320, 240))
    for name in ("feat0", "valid0", "feat1", "valid1"):
        getattr(sat_bank, name)[:] = getattr(sat_bank, name)[:1]
    sat_cfg = dataclasses.replace(make_match_config(sat_cam, sat_settings, 64),
                                  prefilter_sel=20, top_k=16, scan_chunk=16)
    det_sat = PoseDetection(sat_bank, sat_cam, sat_settings, ModelProperties(), dev, cfg=sat_cfg)
    sat_color = np.random.default_rng(0).uniform(0, 255, (240, 320, 3)).astype(np.uint8)
    sat_packed = det_sat.detect_submit(sat_color, np.zeros((240, 320), np.uint16))[0].cpu().numpy()
    resolved = resolve_prefilter_packed(sat_packed, det_sat, sat_color)
    streaming = detect_frame(det_sat.exact_state, torch.from_numpy(sat_color).to(dev)).cpu().numpy()
    phase(5, f"saturated bank: cut_exact {sat_packed[-1, 0]:.0f}, retries {det_sat.retries}, "
             f"result equals the streaming cut's: {np.array_equal(resolved, streaming)}")
    check(sat_packed[-1, 0] == 0.0 and det_sat.retries == 1 and np.array_equal(resolved, streaming),
          "the saturated frame was not retried on the streaming cut")

    # -- phase 6: the dual path (color gradients and depth normals)
    nq = [quantize_normals(d)[0].cpu().numpy() for d in (depthf, depthf[::2, ::2])]
    nmism = [int((q != dual_ref[k]).sum()) for q, k in zip(nq, ("nquant0", "nquant1"))]
    phase(6, f"normal maps vs golden: {nmism[0]} of {nq[0].size} level-0 and {nmism[1]} of {nq[1].size} "
             f"level-1 pixels differ")
    check(nmism == [0, 0], "the card's normal maps differ from the golden")
    sc.coarse_max_plan = matching_mod.coarse_max_plan = counting_plan
    plans_built.clear()
    sc.coarse_scores.launches = sc.fine_scores.launches = sc.coarse_max.launches = 0
    handle = det_dual.detect_submit(color, depth)
    dual_packed = handle[0].cpu().numpy()
    dual_poses = det_dual.detect_collect(handle, 1)
    dual_launches = {"coarse": sc.coarse_scores.launches, "fine": sc.fine_scores.launches,
                     "coarse_max": sc.coarse_max.launches}
    phase(6, f"dual path launches: coarse_scores {dual_launches['coarse']}, fine_scores {dual_launches['fine']}, "
             f"coarse_max {dual_launches['coarse_max']}; kernel plans built {len(plans_built)}")
    check(dual_launches == {"coarse": 1, "fine": 1, "coarse_max": 0}, "the dual path's kernel launches")
    ints_equal = np.array_equal(dual_packed[:, [0, 1, 2, 4]], dual_ref["packed"][:, [0, 1, 2, 4]])
    sim_err = float(np.abs(dual_packed[:, 3] - dual_ref["packed"][:, 3]).max())
    phase(6, f"packed {list(dual_packed.shape)} vs JAX golden: ints equal {ints_equal}, max|sim diff| "
             f"{sim_err:.3g}, {int(dual_packed[:, 4].sum())} valid")
    check(dual_packed.shape == (512, 5) and ints_equal and sim_err <= SIM_ATOL,
          "dual packed candidates differ from the JAX golden")
    check_pose(dual_poses, dual_ref, "dual", 6)
    check_vsd(dual_poses[0], dual_ref["vsd"], "dual", 6)
    dual_add = score_add(verts, gt, dual_poses[0])
    check(abs(dual_add - float(dual_ref["add"])) <= SCORE_ATOL, "dual: ADD differs from JAX's")

    program = frame_program(det_dual)
    dual_cut_launches = {}
    for label, over in (("prefiltered", dict(prefilter_sel=1024, scan_chunk=4096)),
                        ("streaming", dict(scan_chunk=512))):
        st = dataclasses.replace(dual_state, cfg=dataclasses.replace(dual_cfg, **over))
        sc.coarse_scores.launches = sc.coarse_max.launches = 0
        got = program(st).cpu().numpy()
        dual_cut_launches[label] = (sc.coarse_max.launches, sc.coarse_scores.launches)
        if label == "prefiltered":
            check(got.shape == (513, 5) and got[-1, 0] == 1.0, "the dual prefiltered cut was not proved exact")
            got = got[:-1]
        check(np.array_equal(got, dual_packed), f"the dual {label} cut differs from the dense cut")
    maxes = _template_maxes(dual_state, dual_coarse_p).cpu().numpy()
    phase(6, f"the forced prefiltered (cut_exact 1) and streaming cuts give the dense packed [512, 5] exactly; "
             f"(coarse_max, coarse_scores) launches: {dual_cut_launches}; kernel plans built {len(plans_built)}; "
             f"template maxes {list(maxes.shape)} equal the golden's: {np.array_equal(maxes, dual_ref['maxes'])}")
    check(dual_cut_launches == {"prefiltered": (1, 1), "streaming": (0, dn // 512)}, "the dual cuts' launches")
    check(not plans_built, "a dual path built a kernel plan")
    check(np.array_equal(maxes, dual_ref["maxes"]), "dual template maxes differ from the JAX golden")
    sc.coarse_max_plan = matching_mod.coarse_max_plan = build_plan

    # a saturated dual bank: 64 copies of one fixture template, threshold 0
    dsat_bank = dataclasses.replace(dual_bank)
    for name in ("feat0", "valid0", "feat1", "valid1", "nfeat0", "nvalid0", "nfeat1", "nvalid1",
                 "bbox", "quat", "z", "median_depth", "hull"):
        setattr(dsat_bank, name, getattr(dual_bank, name)[np.full(64, 700)])
    dsat_settings = TemplateSettings(detector_threshold=0.0, use_depth_improvement=False, only_color_modality=False)
    dsat_cfg = dataclasses.replace(make_match_config(sat_cam, dsat_settings, 64, dual_modality=True),
                                   prefilter_sel=20, top_k=16, scan_chunk=16)
    det_dsat = PoseDetection(dsat_bank, sat_cam, dsat_settings, ModelProperties(), dev, cfg=dsat_cfg)
    dsat_depth = np.random.default_rng(1).uniform(500, 700, (240, 320)).astype(np.uint16)
    dsat_packed = det_dsat.detect_submit(sat_color, dsat_depth)[0].cpu().numpy()
    resolved = resolve_prefilter_packed(dsat_packed, det_dsat, sat_color, dsat_depth)
    streaming = detect_frame(det_dsat.exact_state, *det_dsat.upload(sat_color, dsat_depth)).cpu().numpy()
    phase(6, f"saturated dual bank: cut_exact {dsat_packed[-1, 0]:.0f}, retries {det_dsat.retries}, result "
             f"equals the streaming cut's: {np.array_equal(resolved, streaming)}, {int(streaming[:, 4].sum())} valid")
    check(dsat_packed[-1, 0] == 0.0 and det_dsat.retries == 1 and np.array_equal(resolved, streaming),
          "the saturated dual frame was not retried on the streaming cut")

    dual_med = request_times(det_dual, REPS)
    phase(6, f"{REPS} dual detect calls: detect_frame_dual device {dual_med['device']:.3f} ms, host post "
             f"{dual_med['post']:.3f} ms, whole detect {dual_med['detect']:.3f} ms (medians; {card})")
    report_profile(6, "dual path", det_dual, dual_med["device"])

    # -- phases 7 and 8: ICP on, and two classes in one bank
    icp_launches = icp_phase(dev, card, cam, settings, bank, props, color, depth)
    multi = multi_phase(dev, card, cam, settings, bank, props, color, depth, colorf)

    # -- phase 9: offline template generation on the card
    gen_launches = generate_phase(dev, card, cam, settings, props,
                                  load_mesh(os.path.join(EXAMPLE, "models", "lagergehaeuse.ply")), color, depth)

    # -- phase 10: the command line, the accuracy protocol and registration
    cli_launches = tooling_phase(dev, card, bank, float(dual_ref["color_vsd"]))

    # -- phase 11: the sharded path, in worlds of 1, 2 and 4 ranks on the card
    def pose_gate(packed_, label):
        poses_ = det.detect_collect((torch.from_numpy(packed_), color_c, depth_c), 1)
        check_pose(poses_, ref, label, 11)
        check_vsd(poses_[0], dual_ref["color_vsd"], label, 11)

    sharded = sharded_phase(card, ref, big_ref, dual_ref, pose_gate)

    # -- phase 12: the host-side ingest routes and the cut opt-ins
    ingest = ingest_phase(dev, card, det, det_big, det_dual, {"fixture": ref, "96300": big_ref, "dual": dual_ref},
                          color, depth, check_pose)

    # -- phase 13: JPEG frames and the ArUco ground-truth capture
    jpeg_launches = jpeg_aruco_phase(dev, card)

    # -- phase 14: the other frame formats
    imread_launches = imread_phase(dev, card)

    # -- phase 15: the measurement entry points
    tool_launches = tools_phase(dev, card, cam, main_vsd, main_add)

    # -- phase 16: the probes
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (16, 256), dtype=np.uint8)).to(dev)
    shifts = [(0, 0), (3, 17), (15, 255), (8, 128)]
    for fn in (probes.bitcast_u8_to_i32, probes.bitcast_i32_to_u8, probes.roll2d_u8):
        fn.launches = 0
    words = probes.bitcast_u8_to_i32(x)
    back = probes.bitcast_i32_to_u8(words)
    rolled = [probes.roll2d_u8(x, sy, sx) for sy, sx in shifts]
    probe_launches = {fn.__name__: fn.launches for fn in
                      (probes.bitcast_u8_to_i32, probes.bitcast_i32_to_u8, probes.roll2d_u8)}
    check(min(probe_launches.values()) > 0, "a probe kernel was not launched")
    err_p1 = max(max_abs_err(words, probes.bitcast_u8_to_i32_plain(x)),
                 max_abs_err(back, probes.bitcast_i32_to_u8_plain(words)), max_abs_err(back, x))
    err_p2 = max(max_abs_err(r, probes.roll2d_u8_plain(x, sy, sx)) for r, (sy, sx) in zip(rolled, shifts))
    host = x.cpu().numpy()
    check(all(np.array_equal(r.cpu().numpy(), np.roll(np.roll(host, sy, 0), sx, 1))
              for r, (sy, sx) in zip(rolled, shifts)), "roll2d_u8 != np.roll")
    sy, sx = shifts[1]
    probe_ms = {
        "bitcast_u8_to_i32": (kernel_times(lambda: probes.bitcast_u8_to_i32(x)),
                              kernel_times(lambda: probes.bitcast_u8_to_i32_plain(x)),
                              kernel_times(lambda: x.view(4, 4, 256).transpose(1, 2).contiguous())),
        "bitcast_i32_to_u8": (kernel_times(lambda: probes.bitcast_i32_to_u8(words)),
                              kernel_times(lambda: probes.bitcast_i32_to_u8_plain(words)),
                              kernel_times(lambda: words.view(torch.uint8).view(4, 256, 4).transpose(1, 2)
                                           .contiguous())),
        "roll2d_u8": (kernel_times(lambda: probes.roll2d_u8(x, sy, sx)),
                      kernel_times(lambda: probes.roll2d_u8_plain(x, sy, sx)),
                      kernel_times(lambda: torch.roll(x, (sy, sx), (0, 1)))),
    }
    check(torch.equal(x.view(4, 4, 256).transpose(1, 2).contiguous().view(torch.int32)[..., 0], words)
          and torch.equal(words.view(torch.uint8).view(4, 256, 4).transpose(1, 2).reshape(16, 256), x),
          "the permuted copies are not the bitcasts")
    phase(16, f"probe launches {probe_launches}; P1 max|kernel-plain| {err_p1}, P2 max|kernel-plain| {err_p2}")
    for name, (k_t, p_t, l_t) in probe_ms.items():
        print(f"  {name}: kernel {fmt(k_t)}, plain {fmt(p_t)}, library {fmt(l_t)} ({card})")
    check(err_p1 == 0 and err_p2 == 0, "probe kernel != plain")

    # -- phase 17: results
    def sharded_launches(i):
        """Phase 11's launches a frame a rank of kernel i (2.1, 2.2, 2.3)
        and its max|kernel - plain| over every rank's launches, by world and
        path."""
        return {world: {path: {"launches": n[i], "max_abs_err": e[i]} for path, (n, e) in paths.items()}
                for world, paths in sharded.items()}

    def ingest_launches(name):
        """Phase 12's launches a frame of kernel `name` and its max|kernel -
        plain|, by path: the host-quantize and delta routes and the cut
        opt-ins."""
        groups = {"quant": ("quant", "quant 96,300", "host-quantize route detect"),
                  "delta": ("delta", "dual delta", "batch delta", "delta route detect"),
                  "cut_opt_ins": ("approx_topk", "guarded_cut")}
        return {group: {path: {"launches": ingest[path]["launches"][name], "max_abs_err": ingest[path]["max_abs_err"][name]}
                        for path in paths} for group, paths in groups.items()}

    def entry(name, source, replaces, n_launches, err, k_t, p_t, bnd, lib_t):
        return {"name": name, "route": "cuda", "source": f"linemod_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": err, "ms": k_t[0],
                "device_ms": k_t[1], "plain_ms": p_t[0], "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None if lib_t is None else lib_t[0]}

    def dual(name, n_launches):
        """The kernel at the dual fixture's shapes; `launches` counts a dual
        frame's (the dense cut: the masked max runs only when forced)."""
        (k_t, p_t), bnd = dual_times[name], dual_bounds[name]
        return {"launches": n_launches, "max_abs_err": dual_err[name], "ms": k_t[0], "device_ms": k_t[1],
                "plain_ms": p_t[0], "bound_ms": bnd[0], "bound_by": bnd[1]}

    pallas = "linemod_tpu/ops/similarity_pallas.py"
    p1_bound = bound(2 * x.numel(), 0)
    kernels = [
        {**entry("coarse_scores", "similarity.cu", f"{pallas}:77", launches["coarse"], max(err_c, dual_err["coarse"]),
                 *times["coarse"], bounds["coarse"], library["coarse"]),
         "dual": dual("coarse", dual_launches["coarse"]), "icp": {"launches": icp_launches["coarse"]},
         "multi": multi["coarse"], "generated": {"launches": gen_launches["coarse"]},
         "cli_launches_a_frame": {path: n_["coarse"] for path, n_ in cli_launches.items()},
         "jpeg_launches_a_frame": {path: n_["coarse"] for path, n_ in jpeg_launches.items()},
         "imread_launches_a_frame": {path: n_["coarse"] for path, n_ in imread_launches.items()},
         "tools_launches_a_frame": {tool: n_["coarse_scores"] for tool, n_ in tool_launches.items()},
         "sharded": sharded_launches(0), **ingest_launches("coarse_scores")},
        {**entry("fine_scores", "similarity.cu", f"{pallas}:262", launches["fine"], max(err_f, dual_err["fine"]),
                 *times["fine"], bounds["fine"], library["fine"]),
         "dual": dual("fine", dual_launches["fine"]), "icp": {"launches": icp_launches["fine"]},
         "multi": multi["fine"], "generated": {"launches": gen_launches["fine"]},
         "cli_launches_a_frame": {path: n_["fine"] for path, n_ in cli_launches.items()},
         "jpeg_launches_a_frame": {path: n_["fine"] for path, n_ in jpeg_launches.items()},
         "imread_launches_a_frame": {path: n_["fine"] for path, n_ in imread_launches.items()},
         "tools_launches_a_frame": {tool: n_["fine_scores"] for tool, n_ in tool_launches.items()},
         "sharded": sharded_launches(1), **ingest_launches("fine_scores")},
        {**entry("coarse_max", "similarity.cu", f"{pallas}:160", big_launches["coarse_max"],
                 max(err_m, err_bm, dual_err["coarse_max"]), *max_times, bounds["coarse_max"], None),
         "dual": dual("coarse_max", dual_launches["coarse_max"]),
         "icp": {"launches": icp_launches["coarse_max"]}, "sharded": sharded_launches(2),
         "tools_launches_a_frame": {tool: n_["coarse_max"] for tool, n_ in tool_launches.items()},
         **ingest_launches("coarse_max")},
        quantizer,
        entry("bitcast_u8_to_i32", "probes.cu", "scripts/test_bitcast.py:23",
              probe_launches["bitcast_u8_to_i32"], err_p1, *probe_ms["bitcast_u8_to_i32"][:2], p1_bound,
              probe_ms["bitcast_u8_to_i32"][2]),
        entry("bitcast_i32_to_u8", "probes.cu", "scripts/test_bitcast.py:23",
              probe_launches["bitcast_i32_to_u8"], err_p1, *probe_ms["bitcast_i32_to_u8"][:2], p1_bound,
              probe_ms["bitcast_i32_to_u8"][2]),
        entry("roll2d_u8", "probes.cu", "scripts/test_u8_roll.py:26", probe_launches["roll2d_u8"], err_p2,
              *probe_ms["roll2d_u8"][:2], bound(2 * x.numel(), 0), probe_ms["roll2d_u8"][2]),
    ]
    phase(17, "seconds from the start to each phase's first line: "
              + ", ".join(f"{n} {t:.1f}" for n, t in sorted(PHASE_AT.items())))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(sys.argv[2]))
    sys.exit(quantizer_main() if sys.argv[1:2] == ["--quantizer"] else main())
