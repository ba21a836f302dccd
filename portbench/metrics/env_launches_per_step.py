"""Device operations (kernels, copies, sets) per batched env step in the
traced windows: the nodes a replayed window runs, and the benchmark's few."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.units:
        return None
    return t.op_count() / t.units
