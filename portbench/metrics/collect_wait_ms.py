"""collect_wait_ms: host ms a frame of the outermost `collect.copy` spans
(`packed.cpu()` in pipeline/pose_detection._collect_phase1: the wait for
the device and the copy), summed over the traced frames (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.per_frame_ms(run, "collect.copy", outermost=True)
