"""submit_ms: mean host ms of the instance's detect_submit (recentre,
upload, enqueue of the match program) over the window's frames of the
traced run (the profiler is off in the window)."""


def read(run):
    spans = run.submit_s
    return sum(spans) / len(spans) * 1e3 if spans else None
