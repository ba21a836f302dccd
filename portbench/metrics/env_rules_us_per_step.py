"""Device time a batched env step spends in the rules' own kernels: the
operations whose innermost program span is ``env.rules`` (the step outside
its flood and its area sums), per step of the traced windows, in us."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "env.rules", own=True)
    return None if s is None or not run.trace.units else s / run.trace.units * 1e6
