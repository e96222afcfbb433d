"""The PTM parity kernel's share of its roofline, batch cells: the scorer's
least time from the PTM kind's counts over the device time of the kernels
launched in the scoring span (`layers.score_roofline_pct`)."""
from portbench import layers


def read(run):
    return layers.score_roofline_pct(run)
