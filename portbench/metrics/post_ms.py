"""post_ms: mean host ms of detect_collect on a packed array already on
the host (retry check, grouping, color and depth checks, pose), over the
checked pool frames after the window, timed together for at least 250 ms."""


def read(run):
    return run.post_ms
