"""fine_scores_roofline: 100 x the bound of kernel fine_scores (portbench/counts.py)
over its device time, summed over the traced frames."""

from portbench.harness import kernel_share


def read(run):
    return kernel_share(run, "fine_scores")
