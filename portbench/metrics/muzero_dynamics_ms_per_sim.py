"""Device time a simulation of the learned search spends under the program's
span of the dynamics (``search.dynamics``: ``g``'s tower and its ``scale``,
written into the tree's store), per simulation of the traced searches, in
ms."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "search.dynamics")
    if s is None or not run.trace.units:
        return None
    return s / (run.trace.units * run.cell.traffic["simulations"]) * 1e3
