"""Device idle share of the traced slice, batch cells (`layers.device_idle_pct`)."""
from portbench import layers


def read(run):
    return layers.device_idle_pct(run)
