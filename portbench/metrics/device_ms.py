"""device_ms: the profiler's device time a frame (kernels and copies) over
the traced stretch of the cell's loop."""


def read(run):
    t = run.trace
    return sum(d for _, _, d in t.ops) / t.frames / 1e3 if t else None
