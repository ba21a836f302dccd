"""A run with the timed path broken underneath comes out not correct, once
for each fault its cell can have, and the control of each cell too.  The
runs skip the look for a card and run every cell's path on the CPU at a
small size (the kernels' plain versions, the graphs' eager functions)."""

import time

import pytest
import torch

from portbench import faults, harness

BENCH = harness.manifest()
SMALL = {
    "env_window": {"batch": 16, "window_steps": 8, "warmup_steps": 16, "sampled_games": 16, "kept_windows": 2},
    "batched_search": {"batch": 6, "root_steps": [8, 8], "simulations": 6, "considered": 4, "sampled_games": 6,
                       "net_roots": 12},
    "gtp_genmove": {"simulations": 4, "net_roots": 6},
}
NET = {"channels": 16, "blocks": 1, "value_hidden": 16}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(cell_name):
    c = harness.cell(BENCH, cell_name)
    c.traffic.update(SMALL[c.traffic["driver"]], settle_s=0)
    if "channels" in c.config:
        c.config.update(NET)
    return c


def run(c, seed=5, seconds=0.2):
    result, _, _ = harness.run_cell(BENCH, c, seed, seconds, False, "cpu", time.perf_counter())
    return result


CASES = [(w["name"], kind) for w in BENCH["workloads"]
         for kind in faults.FAULTS[harness.cell(BENCH, w["name"]).traffic["driver"]]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_cell_as_it_is_comes_out_correct(cell):
    result = run(small(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,kind", CASES)
def test_a_broken_timed_path_comes_out_not_correct(cell, kind):
    c = small(cell)
    with faults.plant(kind, c.traffic["driver"]):
        result = run(c)
    assert not result["correct"], (kind, result["checks"])
