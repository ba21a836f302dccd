"""The host's waits for the card per ``genmove``: the program's ``sync.*``
spans in the traced section (a copy to the host or a scalar read each, the
program's one count of them), per ``genmove``."""

from portbench.lib import layers


def read(run):
    t = run.trace
    if t is None or not t.units or layers.attribute(t) is None:
        return None
    return layers.span_count(t, "gymgo.sync.") / t.units
