"""Spans and stage timing (counterpart of `linemod_tpu/utils/profiling.py`).

- Spans: `span(name)` and `frame_span(name, frame)` mark the layer
  boundaries of one frame inside the program (`frame.submit` and its
  `submit.*` and `match.*` children, `frame.collect` and its `collect.*`
  children). A recorded span has a name, a start and an end in
  `time.time_ns()` (the clock torch.profiler stamps its records with), the
  span that encloses it and the frame id its root carries. Spans go into
  `RECORDER`, a bounded list that drops its oldest first. Recording is on
  while a torch.profiler session is active and inside `recording()`;
  otherwise a span costs one flag test and records nothing. A span never
  touches the device: no launch, no event, no synchronisation.
- `StageTimer`: named wall-clock stages, optionally synchronised with the
  device at each stage's start and end, for per-frame breakdowns in the
  detect loop. Its `summary()` has the JAX package's format; `add_spans`
  folds recorded spans into it.
- `maybe_stage(timer, name)`: `timer.stage(name)`, or nothing without a
  timer, for functions that take an optional timer.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

# spans kept: at 40-52 a frame on the benchmark's frames, the last ~1,300 frames
SPAN_CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span. `seq` numbers spans in the order they opened;
    `parent` is the enclosing span's seq (None for a root); `frame` is the
    frame id of the root it lies in (None outside any frame)."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    frame: int | None


class SpanRecorder:
    """The spans of the process: a bounded list, oldest dropped first, and
    each thread's stack of open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.spans = collections.deque(maxlen=capacity)
        self.forced = 0  # depth of recording() blocks
        self._local = threading.local()
        # next() of a count is atomic, so threads may share these
        self._seqs = itertools.count(1)
        self._frames = itertools.count(1)

    def on(self) -> bool:
        return bool(self.forced or _autograd_profiler._is_profiler_enabled)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def last_frame(self) -> int | None:
        """The frame id this thread's newest `frame_span` started or
        carried; None while recording is off."""
        return getattr(self._local, "frame", None) if self.on() else None

    def take(self) -> list:
        """Remove and return every recorded span, oldest first."""
        out = []
        while self.spans:
            out.append(self.spans.popleft())
        return out


RECORDER = SpanRecorder()


class _Open:
    """An open span (the context manager `span` and `frame_span` return
    while recording is on)."""

    __slots__ = ("name", "root", "frame", "seq", "parent", "start")

    def __init__(self, name: str, root: bool, frame):
        self.name, self.root, self.frame = name, root, frame

    def __enter__(self):
        stack = RECORDER._stack()
        self.seq = next(RECORDER._seqs)
        if self.root:
            self.parent = None
            if self.frame is None:
                self.frame = next(RECORDER._frames)
            RECORDER._local.frame = self.frame
        else:
            top = stack[-1] if stack else None
            self.parent = None if top is None else top.seq
            self.frame = None if top is None else top.frame
        stack.append(self)
        self.start = time.time_ns()
        return self.frame

    def __exit__(self, *exc):
        end = time.time_ns()
        RECORDER._stack().pop()
        RECORDER.spans.append(Span(self.seq, self.name, self.start, end, self.parent, self.frame))
        return False


class _Off:
    """The span of a recorder that is off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A span named `name` inside the innermost open span of this thread
    (its frame is that span's frame)."""
    # RECORDER.on() inlined: this test is all a span costs while off
    if not (RECORDER.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, False, None)


def frame_span(name: str, frame: int | None = None):
    """A root span: `frame` None starts a new frame (a new id), else the
    span carries `frame` (the collection of a submitted frame). Entering
    returns the frame id (None while recording is off)."""
    if not (RECORDER.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, True, frame)


def last_frame() -> int | None:
    """RECORDER.last_frame(): the id to carry beside a submitted frame's handle."""
    return RECORDER.last_frame()


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler session."""
    RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        RECORDER.forced -= 1


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

    def add_spans(self, spans) -> None:
        """Count each recorded span as a call of the stage of its name."""
        for s in spans:
            self.totals[s.name] += (s.end_ns - s.start_ns) / 1e9
            self.counts[s.name] += 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24} {total*1000:8.2f} ms total  {total/n*1000:8.2f} ms/call  x{n}")
        return "\n".join(lines)


def maybe_stage(timer, name: str):
    """`timer.stage(name)` where there is a timer, else an empty context."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
