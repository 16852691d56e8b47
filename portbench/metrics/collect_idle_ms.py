"""collect_idle_ms: ms a frame of the device's idle time in the steady part
of the traced stretch during which the host was in a `frame.collect` span,
over the steady part's frames (portbench/spans.py aligns the clocks)."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "frame.collect")
