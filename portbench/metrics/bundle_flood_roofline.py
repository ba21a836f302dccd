"""The bundle-flood kernel's share of its roofline: the least time its bytes
take at the card's HBM peak over its mean time a launch in the trace, in %.
The kernel is found by its name (the template argument ``BundleOp``)."""

from portbench.lib import counts

KERNEL = "BundleOp"


def read(run):
    t = run.trace
    durations = t.durations(KERNEL) if t is not None else []
    if not durations:
        return None
    bound_s = counts.bundle_flood_bytes(run.cell.config["board_size"], run.cell.traffic["batch"]) / counts.HBM_BYTES
    return 100.0 * bound_s / (sum(durations) / len(durations))
