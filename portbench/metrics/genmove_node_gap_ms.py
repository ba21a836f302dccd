"""Device idle inside the replayed graphs of a ``genmove`` (its search's and
its board stepping's): between the first and the last operation of each
replay, the time none of its operations ran, per ``genmove``, in ms."""

from portbench.lib import layers


def read(run):
    s = layers.replay_gaps(run.trace)
    return None if s is None or not run.trace.units else s / run.trace.units * 1e3
