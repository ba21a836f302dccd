"""Device time a simulation of the learned search spends in the tree code
both simulators share: the program's spans of the root choice, the
selection walk and the backup (``search.root``, ``search.walk``,
``search.backup``; the backup holds the new node's row of the tree), per
simulation of the traced searches, in ms."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "search.root", "search.walk", "search.backup")
    if s is None or not run.trace.units:
        return None
    return s / (run.trace.units * run.cell.traffic["simulations"]) * 1e3
