"""Device idle inside the replayed windows: between the first and the last
operation of each replay, the time none of its operations ran (the gaps
between a graph's nodes), per step of the traced windows, in us."""

from portbench.lib import layers


def read(run):
    s = layers.replay_gaps(run.trace)
    return None if s is None or not run.trace.units else s / run.trace.units * 1e6
