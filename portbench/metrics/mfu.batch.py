"""Whole step's share of the chip's bf16 peak, batch cells (`layers.mfu_pct`)."""
from portbench import layers


def read(run):
    return layers.mfu_pct(run)
