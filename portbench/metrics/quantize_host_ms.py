"""quantize_host_ms: host ms a frame of the `match.quantize` spans (the
enqueue of the quantizer, ops/gradients via ops/matching, both levels),
summed over the traced frames (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.per_frame_ms(run, "match.quantize")
