"""Kernel times on one NVIDIA GPU, without the host's enqueue in them.

- `event_ms(fn, reps)`: CUDA events around `reps` back-to-back calls of
  fn(), divided by reps. The device first runs a sleep kernel long enough
  for the host to enqueue every call, so the events time the device's
  work, not the Python wrapper's checks and launch.
- `device_ms(fn, reps)`: torch.profiler's CUPTI records of `reps` calls:
  the median over calls of the device time of each call's kernels and
  copies (the records are split into calls by order, so every call must
  launch the same number of device operations).

Both warm up first. Used by `chip_smoke.py` and the split tool.
"""

from __future__ import annotations

import statistics
import time

import torch

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


def device_ms(fn, reps: int = 50) -> float | None:
    """Median device ms of one fn() call from the profiler's device records
    of `reps` calls, after a warm-up; None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    if not ops:
        return None
    if len(ops) % reps:
        return sum(e.time_range.elapsed_us() for e in ops) / reps / 1e3
    per = len(ops) // reps
    return statistics.median(
        sum(e.time_range.elapsed_us() for e in ops[i * per : (i + 1) * per]) for i in range(reps)
    ) / 1e3
