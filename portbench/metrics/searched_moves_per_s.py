"""Moves searched in the window (roots x searches) per second of it."""


def read(run):
    if "moves" not in run.host:
        return None
    return run.host["moves"] / run.host["window_s"]
