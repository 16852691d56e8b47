"""Run one cell of the benchmark of `linemod_tpu_torch` once, on one card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`portbench/configs/<config>.json`) and a traffic mix
(`portbench/traffic/<traffic>.json`); each metric is read by
`portbench/metrics/<metric>.py`. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device` and, with --trace 1, `breakdown`; last, `check`: each number the
check compares with its limit, which also end standard error.

Before numpy or torch is imported, the process fixes its thread pools
(intra-op, OpenMP, BLAS) at one thread, and says so on standard error: one
Python thread submits and collects the frames.

Exits 3 without a result where torch sees no CUDA card or fewer cards than
the cell asks for; exits 4 without a result where `jax`, `jaxlib`, `flax`
or `linemod_tpu` were imported in this process.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "linemod_tpu")
THREADS = 1  # each thread pool of the process
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def fix_thread_pools() -> bool:
    """Every thread pool at THREADS, through the environment that numpy's
    BLAS and torch read when they are imported; returns whether neither
    was imported yet."""
    for k in THREAD_ENV:
        os.environ[k] = str(THREADS)
    return not ({"numpy", "torch"} & set(sys.modules))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card(device_index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[device_index].strip() if lines else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    before = fix_thread_pools()
    print(f"host: thread pools at {THREADS}, set before numpy and torch: {before}", file=sys.stderr)

    from portbench import inputs

    manifest = inputs.load_json(os.path.join(inputs.REPO, "BENCHMARK.json"))
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    from portbench import harness

    device = torch.device("cuda", 0)
    config, mix = harness.load_cell(manifest, cell)
    out = harness.run_cell(config, mix, args.seed, args.seconds, bool(args.trace), device, _T_START,
                           log=lambda s: print(s, file=sys.stderr))
    run, numbers = out["run"], out["numbers"]
    metrics = harness.metrics_for(manifest, cell, bool(args.trace), run)
    check = {k: {"value": numbers[k], "limit": lim} for k, lim in harness.LIMITS.items()}
    correct = all(numbers[k] <= lim for k, lim in harness.LIMITS.items())
    result = {
        "correct": correct,
        "attempted": len(run.window.sent),
        "failed": numbers["missing"],
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
                   "memory_peak_bytes": out["memory_peak"], "card": card(0)},
    }
    if args.trace:
        if run.trace is None:
            print("the profiler kept no complete session: busy_s and the device metrics not measured",
                  file=sys.stderr)
        else:
            busy, window = harness.busy_window_s(run.trace.steady)
            result["device"]["busy_s"], result["device"]["window_s"] = busy, window
            result["breakdown"] = harness.breakdown(run.trace)
    result["check"] = check

    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"compared {numbers['compared']} answers of {len(run.window.sent)} frames", file=sys.stderr)
    for k, v in check.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
