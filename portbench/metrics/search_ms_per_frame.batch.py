"""Device ms a frame step outside the scorer's kernels, batch cells (`layers.search_ms_per_frame`)."""
from portbench import layers


def read(run):
    return layers.search_ms_per_frame(run)
