"""Device operations per ``genmove`` in the traced section: the search's
graph nodes and the front end's stepping of the board."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    return t.op_count() / t.units
