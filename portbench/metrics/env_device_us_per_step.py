"""Device time a batched env step takes: every device operation's duration
in the traced windows, summed, per step, in us."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    return t.op_seconds() / t.units * 1e6
