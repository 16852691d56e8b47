"""idle_pct: the share of the steady part of the traced stretch (its first
and last pipeline_depth + 1 frames left out) in which no device operation
runs."""

from portbench.harness import busy_window_s


def read(run):
    if run.trace is None:
        return None
    busy, window = busy_window_s(run.trace.steady)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
