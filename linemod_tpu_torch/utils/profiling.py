"""Tracing and stage timing (counterpart of `linemod_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around torch.profiler, tracing the
  host and, where there is a card, the device; it writes a Chrome trace
  (viewable in Perfetto) into `log_dir` when it exits.
- `StageTimer`: named wall-clock stages, optionally synchronised with the
  device at each stage's start and end, for per-frame breakdowns in the
  detect loop. Its `summary()` has the JAX package's format.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where torch sees
    a card) and export its Chrome trace to `log_dir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock time per named stage. With `sync`, each stage
    starts and ends with `torch.cuda.synchronize(device)`, so it holds its
    own device work; `device` defaults to the current CUDA device, and a CPU
    device needs no sync."""

    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self.device = None if device is None else torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def _barrier(self) -> None:
        if self.sync and (self.device is None or self.device.type == "cuda"):
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._barrier()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24} {total*1000:8.2f} ms total  {total/n*1000:8.2f} ms/call  x{n}")
        return "\n".join(lines)
