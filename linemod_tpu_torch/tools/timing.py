"""Kernel and stage times on one NVIDIA GPU, without the host's enqueue in them.

- `event_ms(fn, reps)`: CUDA events around `reps` back-to-back calls of
  fn(), divided by reps. The device first runs a sleep kernel long enough
  for the host to enqueue every call, so the events time the device's
  work, not the Python wrapper's checks and launch. A call of more
  launches than the driver's pending-launch queue holds (a whole frame:
  ~1,550) blocks the host mid-sleep, and the events then time the enqueue.
- `device_ms(fn, reps)`: torch.profiler's CUPTI records of `reps` calls:
  the median over calls of the device time of each call's kernels and
  copies (the records are split into calls by order, so every call must
  launch the same number of device operations). `device_profile` also
  gives the device operations a call. A session may lose the records of
  the first kernels launched in it (two to four, more often once its
  process has idled), never a later one alone, and a host wait before
  them does not prevent it (`tools/profiler_sessions`, PERF.md §7). So
  `device_profile` (through `device_records`) launches guard kernels
  before and after the calls, tries another session where records are
  missing, and gives None (not measured) after ATTEMPTS.
- `host_ms(fn, reps, device)`: the host clock around synchronised calls;
  `profile_call` the profiler's numbers on the card, the host clock's on
  the CPU.
- `reset_launches()`, `launches(per)`: the scan kernels' launch counts
  (ops/similarity_cuda's wrappers count each launch).
- `card_name(device)`: the card's name and power limit as nvidia-smi gives
  them, or "cpu".

All warm up first. Used by `chip_smoke.py`, the split tool and the
measurement entry points (`tools/bench.py`, `tools/profile_*.py`).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from ..ops import similarity_cuda as sc

KERNELS = ("coarse_scores", "fine_scores", "coarse_max")
# the sleep kernel counts clock cycles; at most the H100's 1.98 GHz boost
# clock, so a sleep of this many cycles a second lasts at least that long
_CYCLES_PER_S = 1.98e9


def event_ms(fn, reps: int = 50) -> float:
    """Mean device ms of one fn() call over `reps` calls queued behind a
    sleep, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * host_s + 1e-3, 1.0) * _CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# sleep kernels of one cycle launched before and after the profiled calls:
# the loss at a session's start falls on them. tools/profiler_sessions on
# the H100, 20 launches a session: sessions with them kept all 20 of the
# calls' records in 10 of 10 (5 of them after the process idled 30 s),
# where bare ones lost the first two in 5 of 5 after the idle and sessions
# with a 50 ms host wait instead lost them in 3 of 5
GUARD_LAUNCHES = 1024
# sessions tried before a call is given up as not measured: now and then
# a session also loses records in its middle (2,257 of a dual frame's
# 21,350 once, 29,360 of the planes' once), which the checks catch
ATTEMPTS = 3


def _session_records(fn, reps: int, wait_s: float = 0.0) -> tuple[list, list]:
    """One profiler session of `reps` fn() calls between two runs of
    GUARD_LAUNCHES sleep kernels (after a host wait of `wait_s`, which
    tools/profiler_sessions compares): the calls' device records and the
    guards' start times, both in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host's records add nothing here and make
    # reading a session of a few thousand launches take seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if wait_s:
            time.sleep(wait_s)
        for _ in range(GUARD_LAUNCHES):
            torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        for _ in range(GUARD_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    records = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    ops = [e for e in records if "spin_kernel" not in e.name]
    guards = [e.time_range.start for e in records if "spin_kernel" in e.name]
    return ops, guards


def _complete(ops: list, guards: list, reps: int) -> bool:
    """Whether a session's records pass the checks: the calls left a
    record, a guard's record stands on each side of theirs, and they split
    evenly into the `reps` calls (records may be missing otherwise)."""
    if not ops or len(ops) % reps:
        return False
    return any(t < ops[0].time_range.start for t in guards) and any(t > ops[-1].time_range.start for t in guards)


def device_records(fn, reps: int = 50) -> list | None:
    """The device records of `reps` fn() calls, after a warm-up: those of
    the first of ATTEMPTS sessions (`_session_records`) that pass the
    checks (`_complete`), else None, not measured."""
    fn()
    torch.cuda.synchronize()
    for _ in range(ATTEMPTS):
        ops, guards = _session_records(fn, reps)
        if _complete(ops, guards, reps):
            return ops
    return None


def device_profile(fn, reps: int = 50) -> tuple[float | None, float | None]:
    """(median device ms of one fn() call, device operations a call) from
    `device_records` of `reps` calls, or (None, None), not measured."""
    ops = device_records(fn, reps)
    if ops is None:
        return None, None
    per = len(ops) // reps
    return statistics.median(
        sum(e.time_range.elapsed_us() for e in ops[i * per : (i + 1) * per]) for i in range(reps)
    ) / 1e3, float(per)


def device_ms(fn, reps: int = 50) -> float | None:
    """Median device ms of one fn() call from the profiler's device records
    of `reps` calls, after a warm-up; None where it recorded none."""
    return device_profile(fn, reps)[0]


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, reps: int, device) -> list[float]:
    """Host ms of each of `reps` fn() calls, each between two syncs of
    `device`, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_call(fn, reps: int, device) -> dict:
    """{"device_ms", "operations", "host_ms"} of one fn() call: the
    profiler's device ms and operations on the card (host_ms None), the
    host clock's median on the CPU (the device numbers None)."""
    if torch.device(device).type == "cuda":
        ms, ops = device_profile(fn, reps)
        return {"device_ms": ms, "operations": ops, "host_ms": None}
    return {"device_ms": None, "operations": None, "host_ms": statistics.median(host_ms(fn, reps, device))}


def shown(v, spec: str = ".4f", unit: str = " ms") -> str:
    """A measured number as printed, or "not measured" for None."""
    return "not measured" if v is None else format(v, spec) + unit


def reset_launches() -> None:
    for name in KERNELS:
        getattr(sc, name).launches = 0


def launches(per: int = 1) -> dict:
    """Each scan kernel's launches since reset_launches, over `per`."""
    return {name: getattr(sc, name).launches / per for name in KERNELS}


def card_name(device) -> str:
    """"cpu", or the card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    first card's line). Raises where nvidia-smi gives nothing."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise RuntimeError(f"nvidia-smi gave no card name and power limit: {out.stderr.strip()}")
    return lines[0].strip()
