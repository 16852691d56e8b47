"""The program's own spans of the traced stretch, on the device trace's clock.

`linemod_tpu_torch.utils.profiling.RECORDER` keeps the spans the program
records while a profiler session is active: `frame.submit` (a frame's id)
with its `submit.*` and `match.*` children, and `frame.collect` (the same
id) with its `collect.*` children; each has a name, a start and an end in
`time.time_ns()`, its parent's seq and its frame id. The traced stretch's
spans are those of the last `run.trace.frames` frame ids, the frames of the
profiler session the harness kept.

The harness keeps the device operations' times relative to the session's
start, so the two clocks are aligned by anchors: the k-th `Memcpy DtoH` of
`run.trace.ops` is the k-th outermost `collect.copy` span (`packed.cpu()`;
a pageable copy is synchronous, so the span ends when the copy does). A
line through (copy end, span end) gives the offset and the rate: the
profiler's conversion of the card's timestamps to the host's clock runs
off by up to 1.5% in a session (-1,259 to +15,126 ppm on the H100), which
a constant offset would turn into residuals of up to 11 ms over 32 frames.
An anchor whose span ended late (the host was descheduled after the copy)
is left out, the farthest first and the line fitted again, up to a quarter
of the anchors; the alignment fails where the counts differ, fewer than two
anchors are left, or a residual from the line still exceeds
MAX_RESIDUAL_US.

Every function returns None where there is nothing to read: no trace, a
program that records no spans, fewer frames than traced, or no alignment.
"""

from __future__ import annotations

import bisect
import statistics

MAX_RESIDUAL_US = 500.0
COPY_OP = "Memcpy DtoH"


def recorded() -> list | None:
    """Every span the program's recorder holds; None where the program has
    no recorder."""
    try:
        from linemod_tpu_torch.utils import profiling

        return list(profiling.RECORDER.spans)
    except (ImportError, AttributeError):
        return None


def traced(run, spans: list | None = None) -> list | None:
    """The spans (`recorded()` by default) of the last run.trace.frames
    frame ids that a root `frame.submit` started."""
    if run.trace is None:
        return None
    spans = recorded() if spans is None else spans
    if not spans:
        return None
    ids = sorted({s.frame for s in spans if s.name == "frame.submit" and s.parent is None})
    if len(ids) < run.trace.frames:
        return None
    keep = set(ids[-run.trace.frames:])
    return [s for s in spans if s.frame in keep]


def outermost_copies(spans: list) -> list:
    """The `collect.copy` spans directly inside a `frame.collect` (a retry's
    copy lies inside `collect.retry`), by start."""
    name_of = {s.seq: s.name for s in spans}
    return sorted((s for s in spans if s.name == "collect.copy" and name_of.get(s.parent) == "frame.collect"),
                  key=lambda s: s.start_ns)


def align(ops: list, spans: list) -> dict | None:
    """{"base_ns", "offset_us", "rate", "residuals_us", "dropped"}: the
    least-squares line (t - base_ns) / 1e3 = offset_us + rate * u through
    the anchors kept, span end t (ns) against copy end u (us from the
    session's start, as `ops` has it), their residuals and the anchors left
    out; `to_trace` maps a span time onto the trace's clock. None where the
    anchors disagree."""
    copies = outermost_copies(spans)
    dtoh = [start + dur for name, start, dur in ops if name.startswith(COPY_OP)]
    if len(copies) < 2 or len(copies) != len(dtoh):
        return None
    base = copies[0].end_ns
    pairs = [(u, (c.end_ns - base) / 1e3) for c, u in zip(copies, dtoh)]
    most_dropped = len(pairs) // 4
    while True:
        rate, offset = statistics.linear_regression([u for u, _ in pairs], [e for _, e in pairs])
        residuals = [e - (offset + rate * u) for u, e in pairs]
        worst = max(range(len(pairs)), key=lambda i: abs(residuals[i]))
        if abs(residuals[worst]) <= MAX_RESIDUAL_US:
            break
        if len(copies) - len(pairs) == most_dropped or len(pairs) == 2:
            return None
        del pairs[worst]
    if rate <= 0:
        return None
    return {"base_ns": base, "offset_us": offset, "rate": rate, "residuals_us": residuals,
            "dropped": len(copies) - len(pairs)}


def to_trace(al: dict, t_ns: int) -> float:
    """A span time (ns) on the trace's clock (us), by `align`'s line."""
    return ((t_ns - al["base_ns"]) / 1e3 - al["offset_us"]) / al["rate"]


def per_frame_ms(run, name: str, outermost: bool = False) -> float | None:
    """Summed ms of the traced spans called `name` over the traced frames;
    `outermost`: only the spans directly inside a root (for collect.copy,
    the copies a retry makes are left out)."""
    spans = traced(run)
    if spans is None:
        return None
    if outermost:
        roots = {s.seq for s in spans if s.parent is None}
        chosen = [s for s in spans if s.name == name and s.parent in roots]
    else:
        chosen = [s for s in spans if s.name == name]
    return sum(s.end_ns - s.start_ns for s in chosen) / 1e6 / run.trace.frames


def idle_gaps(ops: list) -> list:
    """(start, end) us of each stretch between the first start and the last
    end of `ops` in which no operation runs."""
    gaps, end = [], None
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        if end is not None and start > end:
            gaps.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    return gaps


def overlap_us(gaps: list, intervals: list) -> float:
    """us of `gaps` (disjoint, by start) that `intervals` (disjoint) cover."""
    starts = [g[0] for g in gaps]
    total = 0.0
    for lo, hi in intervals:
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(gaps) and gaps[i][0] < hi:
            total += max(0.0, min(hi, gaps[i][1]) - max(lo, gaps[i][0]))
            i += 1
    return total


def idle_ms(run, root: str) -> float | None:
    """ms a frame of the steady part's device-idle time that the root spans
    called `root` cover, over the steady part's frames."""
    spans = traced(run)
    if spans is None:
        return None
    al = align(run.trace.ops, spans)
    if al is None:
        return None
    intervals = [(to_trace(al, s.start_ns), to_trace(al, s.end_ns))
                 for s in spans if s.name == root and s.parent is None]
    steady = run.trace.steady
    frames = len(steady) / (len(run.trace.ops) / run.trace.frames)
    return overlap_us(idle_gaps(steady), intervals) / 1e3 / frames
