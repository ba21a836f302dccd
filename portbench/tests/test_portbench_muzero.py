"""The learned-model cell: its counts by hand, its reference against the
program on the CPU, and through ``harness.run_cell`` at a small size on the
CPU its run as it is (correct) and its control and planted faults (not
correct).  On the card (``cuda`` marker) the control and faults at full
size, and one short run through the command itself."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, muzero_faults
from portbench.lib import muzero_counts
from portbench.reference import muzero

BENCH = harness.manifest()
CELL = "muzero16.latent_b256"
SMALL = {"batch": 6, "root_steps": [8, 8], "simulations": 6, "considered": 4, "sampled_games": 6, "net_roots": 6,
         "settle_s": 0}
NET = {"channels": 16, "blocks": 1, "value_hidden": 16}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_learned_model_costs_435_gflop_a_searched_root():
    c = harness.cell(BENCH, CELL).config
    conv = 2 * 361 * 9 * 256 * 256
    assert muzero_counts.represent_flops(c) == 2 * 361 * 9 * 6 * 256 + 30 * conv == 12_785_568_768
    assert muzero_counts.dynamics_flops(c) == 2 * 361 * 9 * 257 * 256 + 30 * conv == 13_203_104_256
    heads = 2 * 361 * 256 * 2 + 2 * 722 * 362 + 2 * 361 * 256 + 2 * 361 * 256 + 2 * 256
    assert muzero_counts.predict_flops(c) == heads == 1_262_568
    assert muzero_counts.search_flops(c, 32) == 12_785_568_768 + heads + 32 * (13_203_104_256 + heads)
    assert muzero_counts.latent_bytes(c, 256) == 2 * 256 * 361 * 256 * 2
    assert muzero_counts.store_bytes(c, 256, 33) == 1_561_460_736  # 184,832 bytes a node and board


def test_the_reference_network_agrees_with_the_program_in_float32():
    from gymgo_tpu_torch.core.transform import batch_canonical_form
    from gymgo_tpu_torch.models import muzero_net

    net = muzero_net.init_params(torch.Generator().manual_seed(0),
                                 muzero_net.MuZeroNetConfig(7, 16, 1, value_hidden=16, dtype=torch.float32))
    w = {k: p.detach() for k, p in net.named_parameters()}
    states = torch.zeros((3, 6, 7, 7), dtype=torch.int8)
    states[1, 0, 3, 3] = states[2, 1, 2, 2] = states[1, 2] = 1
    actions = torch.tensor([0, 24, 49])
    with torch.no_grad():
        s = net.represent(batch_canonical_form(states))
        torch.testing.assert_close(s, muzero.represent(w, states), rtol=0, atol=1e-5)
        d = net.dynamics(s, actions)
        torch.testing.assert_close(d, muzero.dynamics(w, s, actions), rtol=0, atol=1e-5)
        for got, want in zip(net.predict(d), muzero.predict(w, d)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert not torch.allclose(muzero.predict(w, d, fp8=True)[0], muzero.predict(w, d)[0], atol=1e-3)


def small():
    c = harness.cell(BENCH, CELL)
    c.traffic.update(SMALL)
    c.config.update(NET)
    return c


def run(c, device="cpu", seed=5, seconds=0.2):
    result, _, readings = harness.run_cell(BENCH, c, seed, seconds, False, device, time.perf_counter())
    return result, readings


def test_the_cell_as_it_is_comes_out_correct_and_judges_deep_trees():
    result, readings = run(small())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert readings["tree_nodes"] == SMALL["net_roots"] * (SMALL["simulations"] + 1) and readings["tree_depth"] >= 2


@pytest.mark.parametrize("kind", muzero_faults.OWN)
def test_the_control_and_each_fault_move_the_tree_readings_far_from_the_programs(kind):
    """At this size the network's own rounding is small, so each fault is
    held against the program's reading on the same seed (at least five
    times it); against the limits, which are set at full size, on the
    card."""
    _, program = run(small())
    with muzero_faults.plant(kind):
        _, planted = run(small())
    assert max(planted[k] / program[k] for k in ("node_value_gap", "node_logit_gap")) >= 5, (program, planted)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("program",) + muzero_faults.OWN)
def test_at_full_size_on_the_card_only_the_program_comes_out_correct(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.cell(BENCH, CELL)
    c.traffic.update(batch=32, sampled_games=8, net_roots=16, settle_s=0)
    if kind == "program":
        result, _ = run(c, "cuda", 17, 1.0)
        assert result["correct"], result["checks"]
        return
    with muzero_faults.plant(kind):
        result, _ = run(c, "cuda", 17, 1.0)
    assert not result["correct"], (kind, result["checks"])


@pytest.mark.cuda
def test_a_short_run_of_the_cell_on_the_card_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "4294967311",
                          "--seconds", "2", "--trace", "1"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["metrics"]["muzero_dynamics_rows_per_move"]["value"] == 32.0
