"""cycle_ms_p95: the 95th percentile, over every frame of the window, of
the ms from handing a frame to `detect` until its poses return (the
closed loop of one camera); nothing where the loop is not a cycle."""

import statistics


def read(run):
    lat = run.window.latencies
    if len(lat) < 20:
        return None
    return statistics.quantiles([s * 1e3 for s in lat], n=100, method="inclusive")[94]
