"""Acoustic scoring's share of its roofline, batch cells (`layers.score_roofline_pct`)."""
from portbench import layers


def read(run):
    return layers.score_roofline_pct(run)
