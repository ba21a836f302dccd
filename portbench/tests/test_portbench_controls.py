"""Each cell's control comes out not correct, at a size a test run holds:
the go19 cells with the ko rule dropped (the program's own switch), the
agz20 cells with the float8 reference in the program's network's place.  On
the card (``cuda`` marker) one short run of a cell through the command
itself."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, harness

BENCH = harness.manifest()


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_the_env_control_without_ko_comes_out_not_correct():
    c = harness.cell(BENCH, "go19.selfplay_b12288")
    c.traffic.update(settle_s=0, batch=96, window_steps=64, warmup_steps=128, sampled_games=96, kept_windows=8)
    with faults.plant("ko_off", "env_window"):
        result, _, _ = harness.run_cell(BENCH, c, 11, 6.0, False, "cpu", time.perf_counter())
    assert result["checks"]["mismatches"]["value"] > result["checks"]["mismatches"]["limit"]
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["agz20.search_b256", "agz20.genmove_b1"])
def test_the_float8_control_of_the_net_comes_out_not_correct(cell):
    """At the network's full size, on a few roots: the program comes out
    correct, the float8 reference in its network's place not, each through
    the harness's comparison."""
    c = harness.cell(BENCH, cell)
    if c.traffic["driver"] == "batched_search":
        c.traffic.update(batch=3, root_steps=[48, 48], sampled_games=3)
    c.traffic.update(settle_s=0, simulations=8, net_roots=6)
    program, _, _ = harness.run_cell(BENCH, c, 13, 0.5, False, "cpu", time.perf_counter())
    with faults.plant("float8", c.traffic["driver"]):
        control, _, _ = harness.run_cell(BENCH, c, 13, 0.5, False, "cpu", time.perf_counter())
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
    assert any(control["checks"][name]["value"] > c.limits[name] for name in ("logit_gap", "value_gap"))


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "go19.actor_b512", "--seed",
                          "4294967311", "--seconds", "2", "--trace", "1"], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0 and "bundle_flood_roofline" in result["metrics"]
