"""The learned search's share of the card's bfloat16 peak: the network's
FLOPs a root (``muzero_counts.search_flops``: ``h`` and ``f`` at the root,
``g`` and ``f`` a simulation) times the roots searched in the window, over
the window's host-clock time, in %."""

from portbench.lib import counts, muzero_counts


def read(run):
    if "moves" not in run.host:
        return None
    done = muzero_counts.search_flops(run.cell.config, run.cell.traffic["simulations"]) * run.host["moves"]
    return 100.0 * done / run.host["window_s"] / counts.BF16_FLOPS
