"""The median ``genmove`` of the window, in ms (host clock)."""

import numpy as np


def read(run):
    latencies = run.host.get("genmove_s")
    return float(np.percentile(latencies, 50)) * 1e3 if latencies else None
