"""Device time a simulation of the learned search spends under the program's
span of the prediction (``search.predict``: ``f``'s heads at the root and at
each new node), per simulation of the traced searches, in ms."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "search.predict")
    if s is None or not run.trace.units:
        return None
    return s / (run.trace.units * run.cell.traffic["simulations"]) * 1e3
