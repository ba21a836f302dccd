"""The device's idle share of the traced section: 1 less the union of its
operations' intervals over the section's span, in %."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
