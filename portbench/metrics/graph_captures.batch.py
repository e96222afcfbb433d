"""Frame-loop graph captures in the window, batch cells (`layers.graph_captures`)."""
from portbench import layers


def read(run):
    return layers.graph_captures(run)
