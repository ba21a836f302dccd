"""The 95th percentile of every ``genmove`` in the window, each from the
front end's call to its reply (host clock), in ms."""

import numpy as np


def read(run):
    latencies = run.host.get("genmove_s")
    return float(np.percentile(latencies, 95)) * 1e3 if latencies else None
