"""The whole env step's share of the card's HBM peak: the bytes every
env-step must move (``counts.env_step_bytes``), times the env-steps of the
window, over the window's host-clock time, in %."""

from portbench.lib import counts


def read(run):
    if "env_steps" not in run.host:
        return None
    moved = counts.env_step_bytes(run.cell.config["board_size"]) * run.host["env_steps"]
    return 100.0 * moved / run.host["window_s"] / counts.HBM_BYTES
