"""setup_s: seconds from the process's start to the end of the warm-up
(imports, the bank and its fillers, the match state, the frame pool, the
kernels' build on a first run, the warm-up frames)."""


def read(run):
    return run.setup_s
