"""The whole search's share of the card's bfloat16 peak: the network's
forward FLOPs (``counts.aznet_flops``) times the evaluations the searches of
the window made, over the window's host-clock time, in %."""

from portbench.lib import counts


def read(run):
    if "moves" not in run.host:
        return None
    c, tr = run.cell.config, run.cell.traffic
    flops = counts.aznet_flops(c["board_size"], c["channels"], c["blocks"], c["policy_channels"],
                               c["value_channels"], c["value_hidden"])
    done = flops * counts.search_evaluations(tr["simulations"]) * run.host["moves"]
    return 100.0 * done / run.host["window_s"] / counts.BF16_FLOPS
