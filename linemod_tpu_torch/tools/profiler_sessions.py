"""Profiler dropouts on the card: one fixed call of 20 device kernels, each a
different elementwise op on a 4,096-float tensor, profiled in successive
torch.profiler sessions of one process (device activity only, as
`tools.timing.device_profile` records it).

    python -m linemod_tpu_torch.tools.profiler_sessions

SESSIONS sessions take four kinds in turn: "bare" (enter the session,
launch the 20 kernels, synchronize, leave), "host-wait" (the same with the
host sleeping HOST_WAIT_S after entering and again after the synchronize,
before leaving), "guards" (the session `device_profile` reads,
`timing._session_records`: GUARD_LAUNCHES sleep kernels on each side of
the call) and "guarded" (the guards after a host wait of HOST_WAIT_S).
After the first half of the sessions the process idles IDLE_S seconds, so
that a loss that grows with the process's age and one that grows with its
session count can be told apart.

For each session it prints the records kept of the 20, the positions of the
calls whose records are missing (the kernels' names tell them apart), the
first record's start and the last record's end in microseconds from the
session's trace start, the host clock's first launch and leaving the
session in microseconds from entering it (bare and host-wait sessions),
and whether a guards or guarded session passes `device_profile`'s checks.
The last line is a JSON summary; PERF.md §7 gives what the H100 showed.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import timing

KINDS = ("bare", "host-wait", "guards", "guarded")
SESSIONS = 40  # ten of each kind, five before the idle and five after
IDLE_S = 30.0
HOST_WAIT_S = 0.05
OPS = ("neg", "abs", "exp", "sin", "cos", "sqrt", "tanh", "sigmoid", "log1p", "expm1", "floor", "ceil",
       "round", "trunc", "reciprocal", "rsqrt", "erf", "atan", "sinh", "cosh")


def fixed_call(x: torch.Tensor):
    """The 20-launch call: each op once on x, in OPS's order."""
    return [getattr(torch, op)(x) for op in OPS]


def one_session(x: torch.Tensor, wait_s: float) -> dict:
    """Profile fixed_call once; the kept records' names in launch order and
    the device and host times relative to the trace start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entered = time.perf_counter_ns()
        if wait_s:
            time.sleep(wait_s)
        launched = time.perf_counter_ns()
        fixed_call(x)
        torch.cuda.synchronize()
        if wait_s:
            time.sleep(wait_s)
        leaving = time.perf_counter_ns()
    results = prof.profiler.kineto_results
    start = results.trace_start_ns()
    records = sorted((e for e in results.events() if e.device_type() == DeviceType.CUDA), key=lambda e: e.start_ns())
    return {
        "names": [e.name() for e in records],
        "first_start_us": (records[0].start_ns() - start) / 1e3 if records else None,
        "last_end_us": (records[-1].end_ns() - start) / 1e3 if records else None,
        "host_launch_us": (launched - entered) / 1e3,
        "host_leave_us": (leaving - entered) / 1e3,
    }


def op_of(name: str) -> int | None:
    """The position in OPS of the op whose kernel a record names (ATen's
    "<op>_kernel..." functions, abs's AbsFunctor; the longest such op,
    since "sqrt_kernel" is inside "rsqrt_kernel"), or None."""
    if "AbsFunctor" in name:
        return OPS.index("abs")
    hits = [op for op in OPS if f"{op}_kernel" in name]
    return OPS.index(max(hits, key=len)) if hits else None


def guarded_session(x: torch.Tensor, wait_s: float) -> dict:
    """One session as `tools.timing.device_profile` takes it, after a host
    wait of `wait_s` (none in device_profile's): the calls' records, times
    relative to the trace start, and whether they pass its checks."""
    ops, guards = timing._session_records(lambda: fixed_call(x), 1, wait_s)
    return {"names": [e.name for e in ops], "first_start_us": ops[0].time_range.start if ops else None,
            "last_end_us": ops[-1].time_range.end if ops else None, "host_launch_us": None, "host_leave_us": None,
            "complete": timing._complete(ops, guards, 1)}


def run() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_sessions profiles the card, and torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    x = torch.rand(4096, device=dev) + 0.5
    fixed_call(x)
    torch.cuda.synchronize()
    rows = []
    for i in range(SESSIONS):
        if i == SESSIONS // 2:
            print(f"idle {IDLE_S:g} s", flush=True)
            time.sleep(IDLE_S)
        kind = KINDS[i % len(KINDS)]
        if kind in ("guards", "guarded"):
            s = guarded_session(x, 0.0 if kind == "guards" else HOST_WAIT_S)
        else:
            s = one_session(x, 0.0 if kind == "bare" else HOST_WAIT_S)
        positions = [op_of(n) for n in s["names"]]
        missing = [p for p in range(len(OPS)) if p not in positions]
        row = {"session": i + 1, "kind": kind, "kept": len(s["names"]), "missing": missing,
               "unnamed": [n[:80] for n, p in zip(s["names"], positions) if p is None],
               **{k: v for k, v in s.items() if k != "names"}}
        rows.append(row)

        def us(v):
            return "none" if v is None else f"{v:.1f}"

        print(f"session {i + 1:2d} ({kind:9s}): kept {row['kept']:2d} of {len(OPS)}, missing calls {missing}; "
              f"device first start {us(row['first_start_us'])} us, last end {us(row['last_end_us'])} us; host "
              f"launch {us(row['host_launch_us'])} us, leave {us(row['host_leave_us'])} us (from the trace start "
              f"and from entering)" + (f"; checks passed {row['complete']}" if "complete" in row else "")
              + (f"; records of no op: {row['unnamed']}" if row["unnamed"] else ""), flush=True)
    return {"tool": "profiler_sessions", "device": timing.card_name(dev), "launches_a_call": len(OPS),
            "idle_s": IDLE_S, "wait_s": HOST_WAIT_S, "sessions": rows}


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
