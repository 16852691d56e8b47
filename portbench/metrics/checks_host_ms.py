"""checks_host_ms: host ms a frame of the `collect.checks` spans (each
candidate's hull mask, color and depth checks and pose,
pipeline/pose_detection.group_candidate_poses), summed over the traced
frames (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.per_frame_ms(run, "collect.checks")
