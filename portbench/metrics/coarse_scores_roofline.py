"""coarse_scores_roofline: 100 x the bound of kernel coarse_scores (portbench/counts.py)
over its device time, summed over the traced frames."""

from portbench.harness import kernel_share


def read(run):
    return kernel_share(run, "coarse_scores")
