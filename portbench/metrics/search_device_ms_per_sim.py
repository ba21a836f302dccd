"""Device time a simulation of the batched search takes: every device
operation's duration in the traced searches (the env step between them
included), summed, per simulation, in ms."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    return t.op_seconds() / (t.units * run.cell.traffic["simulations"]) * 1e3
