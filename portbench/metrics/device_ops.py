"""device_ops: device operations (kernels and copies) a frame over the
traced stretch."""


def read(run):
    t = run.trace
    return len(t.ops) / t.frames if t else None
