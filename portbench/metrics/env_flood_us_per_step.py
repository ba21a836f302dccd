"""Device time a batched env step spends under the program's ``env.flood``
span (the bundle kernel and the unpacking of its word, and the window's
seeding flood), per step of the traced windows, in us."""

from portbench.lib import layers


def read(run):
    s = layers.device_seconds(run.trace, "env.flood")
    return None if s is None or not run.trace.units else s / run.trace.units * 1e6
