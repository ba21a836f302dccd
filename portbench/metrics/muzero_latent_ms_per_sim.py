"""Device time a simulation of the learned search spends under the program's
span of the store of hidden states (``search.latent``: each board's parent
state gathered beside the action plane into ``g``'s input), per simulation
of the traced searches, in ms."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "search.latent")
    if s is None or not run.trace.units:
        return None
    return s / (run.trace.units * run.cell.traffic["simulations"]) * 1e3
