"""frames_per_s: frames whose poses returned in the window, over the
window's seconds (from the first frame handed over to the last answer, the
frames in flight at the close included)."""


def read(run):
    w = run.window
    return len(w.answers) / w.seconds if w.seconds > 0 and w.answers else None
