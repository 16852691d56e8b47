"""One cell, once: set-up, the measured window, the traced stretch, the
check against the plain reference, and the metrics.

The program under test is `linemod_tpu_torch` (imported only here, inside
the functions that drive it). From it the harness takes the system under
test (`PoseDetection` and its entry points), its kernel names and launch
counters, and one hook: the packed candidates each frame's collection
resolves (`pipeline/pose_detection.resolve_prefilter_packed`, the proof
row sliced off and a retried frame's rows in place), recorded as they are
produced so that the check compares what the timed path used.

The check, once the window has closed and the program's state is freed:
the seed's own frames, which the window sent once each, and a sample,
drawn from the seed, of the frames it cycled go through the plain
reference (`reference/`), and every answer of the window to one of those
frames is compared with it: each packed row (template id, x, y, similarity
and valid bit, exactly) and the frame's poses (translation, quaternion and
box, exactly). Three numbers, each with its limit:

- `rows_off`: packed rows that differ from the reference's (limit 0);
- `poses_off`: answers whose poses differ (limit 0);
- `missing`: frames sent in the window whose answer never came (limit 0).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import os
import time

import numpy as np
import torch

from . import counts, inputs
from .reference import match as ref_match
from .reference import post as ref_post

LIMITS = {"rows_off": 0, "poses_off": 0, "missing": 0}
# the profiler's session: one-cycle sleep kernels on each side of the
# traced frames, where a session's lost first records fall; sessions tried
GUARD_LAUNCHES = 1024
TRACE_ATTEMPTS = 3
# the scan kernels' names in the device trace
KERNEL_NAMES = {"coarse_scores": "coarse_kernel<true>", "coarse_max": "coarse_kernel<false>",
                "fine_scores": "fine_kernel<"}
POST_MIN_S = 0.25
WARM_FRAMES = 8


@dataclasses.dataclass
class Window:
    sent: list  # pool index of each frame sent, in order
    answers: list  # each answered frame's poses, in order
    packed: list  # each answered frame's resolved packed candidates
    seconds: float  # from the first frame handed over to the last answer
    latencies: list  # seconds from handing a frame over to its poses (cycle)


@dataclasses.dataclass
class Trace:
    frames: int
    ops: list  # (name, start_us, duration_us) of the device operations, by start
    steady: list  # the ops of the steady part of the stream


@dataclasses.dataclass
class Run:
    """What the metric readers read (portbench/metrics/<name>.py)."""

    setup_s: float
    window: Window
    trace: Trace | None = None
    post_ms: float | None = None
    submit_s: list = dataclasses.field(default_factory=list)  # host s of each detect_submit (trace on)
    bounds: dict = dataclasses.field(default_factory=dict)  # kernel -> bound seconds per traced frame


class Recorder:
    """Records the packed arrays the program resolves while `active`."""

    def __init__(self):
        self.active = False
        self.packed = []

    def install(self):
        from linemod_tpu_torch.pipeline import pose_detection

        original = pose_detection.resolve_prefilter_packed

        def recording(packed, owner, color_c, depth_c=None):
            out = original(packed, owner, color_c, depth_c)
            if self.active:
                self.packed.append(out)
            return out

        pose_detection.resolve_prefilter_packed = recording
        self._restore = lambda: setattr(pose_detection, "resolve_prefilter_packed", original)

    def uninstall(self):
        self._restore()


def load_module(path: str):
    """A reader or other module of the benchmark, by file path."""
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_detector(config: dict, mix: dict, bank: dict, device):
    """The port's PoseDetection of the configuration's bank, settings and
    model, with the mix's camera."""
    from linemod_tpu_torch.config import CameraParameters, ModelProperties, TemplateSettings
    from linemod_tpu_torch.models.template_bank import TemplateBank
    from linemod_tpu_torch.pipeline.pose_detection import PoseDetection

    model = config["model"]
    props = ModelProperties(
        lower_color_range=tuple(model["lower_color_range"]),
        upper_color_range=tuple(model["upper_color_range"]),
        rotationally_symmetrical=bool(model["rotationally_symmetrical"]),
        planes_of_symmetry=tuple(model["planes_of_symmetry"]),
    )
    tb = TemplateBank(class_id=model["file"], dual_modality=inputs.dual(config), **bank)
    return PoseDetection(tb, CameraParameters(**inputs.camera(config, mix)),
                         TemplateSettings(**config["settings"]), props, device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_loop(det, pool: list, keys, mix: dict) -> tuple:
    """The mix's loop over the pool frames `keys` yields: the stream hands
    them to `detect_stream` (and takes the frames in flight once `keys`
    ends), the cycle calls `detect` a frame at a time. Returns (answers,
    latencies in s (the cycle's), each answer's perf_counter time)."""
    answers, latencies, stamps = [], [], []
    if mix["loop"] == "stream":
        for poses in det.detect_stream((pool[k] for k in keys), num_objects=1,
                                       pipeline_depth=int(mix["pipeline_depth"])):
            answers.append(poses)
            stamps.append(time.perf_counter())
    elif mix["loop"] == "cycle":
        for k in keys:
            t = time.perf_counter()
            answers.append(det.detect(*pool[k], num_objects=1))
            stamps.append(time.perf_counter())
            latencies.append(stamps[-1] - t)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return answers, latencies, stamps


def drive(det, pool: list, order: list, mix: dict, seconds: float, once: list = ()) -> tuple:
    """The mix's loop over `order` (pool indices, cycled), with the pool
    frames `once` sent once each, every second frame from the window's
    start, frames handed over until `seconds` have passed: returns (sent,
    answers, window seconds, latencies, each answer's seconds into the
    window)."""
    sent = []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def keys():
        i = j = 0
        while time.perf_counter() < deadline:
            if j < len(once) and len(sent) % 2:
                sent.append(once[j])
                j += 1
            else:
                sent.append(order[i % len(order)])
                i += 1
            yield sent[-1]

    answers, latencies, stamps = run_loop(det, pool, keys(), mix)
    return sent, answers, time.perf_counter() - t0, latencies, [s - t0 for s in stamps]


def chunk_rates(stamps: list, chunk: float = 2.0) -> list:
    """Answers a second in each whole `chunk` seconds of the window."""
    counts = [0] * int(stamps[-1] // chunk) if stamps else []
    for s in stamps:
        if int(s // chunk) < len(counts):
            counts[int(s // chunk)] += 1
    return [c / chunk for c in counts]


def timed(fn, spans: list):
    """fn with the host seconds of each call appended to spans."""
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        spans.append(time.perf_counter() - t)
        return out

    return wrapper


def trace_stretch(det, pool: list, order: list, mix: dict) -> Trace | None:
    """The mix's loop over `order` inside a profiler session of device
    activity, GUARD_LAUNCHES sleep kernels on each side; the first of
    TRACE_ATTEMPTS sessions whose records are complete (a guard's record
    on each side of the frames', which split evenly into the frames), else
    None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GUARD_LAUNCHES):
                torch.cuda._sleep(1)
            run_loop(det, pool, order, mix)
            for _ in range(GUARD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        records = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        ops = [(e.name, e.time_range.start, e.time_range.elapsed_us())
               for e in records if "spin_kernel" not in e.name]
        guards = [e.time_range.start for e in records if "spin_kernel" in e.name]
        del prof, records
        n = len(order)
        if ops and not len(ops) % n and any(g < ops[0][1] for g in guards) \
                and any(g > ops[-1][1] for g in guards):
            per = len(ops) // n
            depth = int(mix["pipeline_depth"])
            lo, hi = (depth + 1) * per, (n - depth - 1) * per
            steady = ops[lo:hi] if hi - lo >= 4 * per else ops
            return Trace(frames=n, ops=ops, steady=steady)
    return None


def busy_window_s(ops: list) -> tuple:
    """(busy seconds: the union of the ops' intervals, window seconds: the
    first start to the last end)."""
    busy, end = 0.0, None
    for _, start, dur in ops:
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    first = ops[0][1]
    last = max(s + d for _, s, d in ops)
    return busy / 1e6, (last - first) / 1e6


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the steady stretch named by the operation they follow
    (the host was enqueueing the next one, or collecting a frame)."""
    by_name: dict = {}
    for name, _, dur in trace.ops:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + dur / 1e6
    gaps = []
    for (name, start, dur), (_, nxt, _) in zip(trace.steady, trace.steady[1:]):
        if nxt > start + dur:
            gaps.append((f"after {name[:90]}", (nxt - start - dur) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def post_ms(det, pool: list, order: list, device) -> float:
    """Mean host ms of detect_collect on packed arrays already on the host
    (the pool frames `order`), after one pass that warms the hull cache."""
    fetched = []
    for k in order:
        packed, color_c, depth_c = det.detect_submit(*pool[k])
        fetched.append((packed.cpu(), color_c, depth_c))
    for f in fetched:
        det.detect_collect(f, 1)
    _sync(device)
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < POST_MIN_S:
        for f in fetched:
            det.detect_collect(f, 1)
        calls += len(fetched)
    return (time.perf_counter() - t0) / calls * 1e3


def reference_frames(config: dict, mix: dict, bank: dict, pool: list, frames: list, device,
                     precision: str = "float32") -> tuple:
    """({pool index: (packed, poses, match.FrameResult)}, the reference's
    padded bank) of the plain reference over `frames`."""
    ref_bank = ref_match.make_bank(bank, device, inputs.dual(config))
    cam = inputs.camera(config, mix)
    cache: dict = {}
    out = {}
    for k in frames:
        color, depth = (ref_post.recenter(a, cam) for a in pool[k])
        fr = ref_match.match_frame(ref_bank, torch.as_tensor(color, device=device),
                                   float(config["settings"]["detector_threshold"]), int(config["top_k"]),
                                   precision, torch.as_tensor(depth.astype(np.float32), device=device))
        poses = ref_post.frame_poses(fr.packed, bank, config["settings"], config["model"], cam,
                                     color, depth, 1, cache)
        out[k] = (fr.packed, poses, fr)
    return out, ref_bank


def same_poses(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    return all(np.array_equal(g.translation, t) and np.array_equal(g.quaternion, q)
               and tuple(int(v) for v in g.bounding_box) == tuple(b) for g, (t, q, b) in zip(got, want))


def compare(window: Window, ref: dict) -> dict:
    """The check's numbers (see the module docstring) and how many answers
    were compared."""
    rows_off = poses_off = compared = 0
    for k, packed, poses in zip(window.sent, window.packed, window.answers):
        if k not in ref:
            continue
        compared += 1
        want_packed, want_poses = ref[k][0], ref[k][1]
        if packed.shape != want_packed.shape:
            rows_off += max(packed.shape[0], want_packed.shape[0])
        else:
            rows_off += int(np.any(packed != want_packed, axis=1).sum())
        poses_off += int(not same_poses(poses, want_poses))
    missing = len(window.sent) - min(len(window.answers), len(window.packed))
    return {"rows_off": rows_off, "poses_off": poses_off, "missing": missing, "compared": compared}


def kernel_bounds(config: dict, mix: dict, bank: dict, ref_bank, ref: dict, traced: list) -> dict:
    """Each scan kernel's bound in seconds for each traced frame."""
    geo = counts.Geometry(bank["bbox"], int(mix["width"]), int(mix["height"]), inputs.dual(config))
    live1 = ref_bank.valid1.sum(1)
    rescan = int(config.get("rescan_templates", 0))
    out = {"fine_scores": [], "coarse_scores": []}
    for k in traced:
        fr = ref[k][2]
        out["fine_scores"].append(counts.bound_s(*counts.fine_scores_work(
            geo, ref_bank.feat0, ref_bank.valid0, fr.cand_t, fr.cand_gy, fr.cand_gx)))
        live = counts.rescan_live(fr.template_max, live1, rescan) if rescan else live1.cpu().numpy()
        out["coarse_scores"].append(counts.bound_s(*counts.coarse_scores_work(geo, live)))
    if rescan:
        wh = ref_bank.wh.cpu().numpy()
        out["coarse_max"] = [counts.bound_s(*counts.coarse_max_work(geo, live1.cpu().numpy(), wh))] * len(traced)
    return out


def load_cell(manifest: dict, cell: dict) -> tuple:
    """(configuration, traffic mix) of a cell, found by their names."""
    config = inputs.load_json(inputs.repo_path(next(
        c["file"] for c in manifest["configs"] if c["name"] == cell["config"])))
    mix = inputs.load_json(os.path.join(inputs.ROOT, "traffic", f"{cell['traffic']}.json"))
    return config, mix


def run_cell(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Everything of one run but the chip check, the final look for JAX
    and the printing: {"run": Run, "numbers": the check's numbers,
    "memory_peak": bytes, "inputs": (bank, pool, checked frames), "ref":
    the reference's answers}."""
    marks = [("start", t_start), ("imports", time.perf_counter())]
    rngs = inputs.streams(seed)
    bank = inputs.make_bank(config, rngs["fillers"])
    marks.append(("bank", time.perf_counter()))
    pool, order, once = inputs.window_frames(mix, rngs["frames"])
    marks.append(("pool", time.perf_counter()))
    sampled = inputs.sample(len(order), int(mix["check_frames"]), rngs["sample"])
    checked = sampled + once
    traced = sampled * int(mix["trace_repeats"])

    det = port_detector(config, mix, bank, device)
    marks.append(("detector", time.perf_counter()))
    rec = Recorder()
    rec.install()
    try:
        run_loop(det, pool, order[:WARM_FRAMES], mix)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", t_start + setup_s))
        log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])))
        spans = []
        if trace:
            det.detect_submit = timed(det.detect_submit, spans)
        rec.active = True
        sent, answers, window_s, latencies, stamps = drive(det, pool, order, mix, seconds, once)
        rec.active = False
        if trace:
            del det.detect_submit
        window = Window(sent, answers, rec.packed, window_s, latencies)
        log(f"window: {len(answers)} of {len(sent)} frames answered in {window_s:.3f} s; answers/s by 2 s: "
            + " ".join(f"{r:g}" for r in chunk_rates(stamps)))
        run = Run(setup_s=setup_s, window=window, submit_s=spans)
        memory_peak = 0
        if trace:
            if torch.device(device).type == "cuda":
                run.trace = trace_stretch(det, pool, traced, mix)
            run.post_ms = post_ms(det, pool, sampled, device)
        if torch.device(device).type == "cuda":
            _sync(device)
            memory_peak = int(torch.cuda.max_memory_allocated(device))
    finally:
        rec.uninstall()
    del det
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref, ref_bank = reference_frames(config, mix, bank, pool, checked, device)
    numbers = compare(window, ref)
    log(f"reference: {len(checked)} frames in {time.perf_counter() - t_ref:.3f} s, "
        f"{numbers['compared']} answers compared")
    if trace:
        run.bounds = kernel_bounds(config, mix, bank, ref_bank, ref, traced)
    return {"run": run, "numbers": numbers, "memory_peak": memory_peak,
            "inputs": (bank, pool, checked), "ref": ref}


def metrics_for(manifest: dict, cell: dict, trace: bool, run: Run) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (trace
    off) or per-layer metrics (trace on), each read by
    portbench/metrics/<name>.py; a reader that finds nothing is left out."""
    group = manifest["per_layer" if trace else "end_to_end"]
    out = {}
    for m in group:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        reader = load_module(os.path.join(inputs.ROOT, "metrics", f"{m['name']}.py"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def kernel_share(run: Run, kernel: str) -> float | None:
    """100 x the kernel's bound over its device time, both summed over the
    traced frames; None where the trace has no record of it, or not one a
    frame (a retried frame scans again)."""
    if run.trace is None or kernel not in run.bounds:
        return None
    times = [d for name, _, d in run.trace.ops if KERNEL_NAMES[kernel] in name]
    if len(times) != run.trace.frames:
        return None
    return 100.0 * sum(run.bounds[kernel]) / (sum(times) / 1e6)

