"""Host time of the GTP front end per ``genmove``: inside the program's
``gtp.*`` and ``mover`` spans, outside its ``graph.*`` spans (copying into,
replaying and cloning out of CUDA graphs) and its ``sync.*`` spans (waits
for the card), in ms."""

from portbench.lib import layers


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    s = layers.host_self_seconds(t, ("gymgo.gtp.", "gymgo.mover"), ("gymgo.graph.", "gymgo.sync."))
    return None if s is None else s / t.units * 1e3
