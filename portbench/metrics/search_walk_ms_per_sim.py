"""Device time a simulation of the batched search spends under the program's
span of the root choice and the selection walk (``search.root`` and
``search.walk``), per simulation of the traced searches, in ms."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "search.root", "search.walk")
    if s is None or not run.trace.units:
        return None
    return s / (run.trace.units * run.cell.traffic["simulations"]) * 1e3
