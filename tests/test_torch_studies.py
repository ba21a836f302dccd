"""The three measurement scripts of the port against the JAX package.

* ``gymgo_tpu_torch.scripts.measure_convergence``: at each env's counted
  substep t the schedule's word unpacks to ``gymgo_tpu.core.flood.
  flood_bundle_bitpack``'s outputs bit for bit, and the word at t - 1 differs;
  the warm start reaches the cold fixpoint on every env of every step.
* ``gymgo_tpu_torch.scripts.walk_depth_study``: the walk depths it records
  equal, simulation by simulation, those that the JAX script's own
  ``io_callback`` wrapper of ``walk_paths`` records on the same boards, net
  (float32 in both) and Gumbel noise.
* all three scripts run with ``--device cpu`` at a tiny size and print their
  tables.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import flood as jflood
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.core.flood import bundle_seed_and_gates, bundle_substep, unpack_bundle
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.scripts import measure_convergence, search_cost_ablation, walk_depth_study
from torch_boards import midgame_states, states_on_boards

_REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [9, 19])
def test_conv_counts_word_is_jax_fixpoint_at_each_count(n):
    states = np.concatenate([states_on_boards(n, 12), midgame_states(n, 64, n * n // 2, n)])
    a, b = states[:, 0] != 0, states[:, 1] != 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    maxk = 4 * n * n
    counts, word = measure_convergence.conv_counts(ta, tb, maxk)
    total = counts[0].long()
    assert 0 < int(total.max()) < maxk - 2
    assert torch.equal(torch.maximum(counts[1], counts[2]), counts[0])
    # the schedule's word after exactly t substeps, per env, and after t - 1
    x, gates = bundle_seed_and_gates(ta, tb)
    at_t, before_t = x.clone(), x.clone()
    for t in range(1, int(total.max()) + 1):
        before_t[total == t] = x[total == t]
        x = bundle_substep(x, gates, reverse=t % 2 == 0)
        at_t[total == t] = x[total == t]
    assert torch.equal(at_t, word)
    moved = total > 0
    assert ((at_t != before_t).flatten(1).any(1) == moved).all()
    jout = jax.jit(jflood.flood_bundle_bitpack, static_argnums=2)(jnp.asarray(a), jnp.asarray(b), n)
    for j, t in zip(jout, unpack_bundle(at_t, ta, tb)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _run_main(module, argv, capsys):
    rc = module.main(argv)
    out = capsys.readouterr().out
    return rc, out, json.loads(out.strip().splitlines()[-1])


def test_warm_start_reaches_the_cold_fixpoint(capsys):
    rc, out, rec = _run_main(measure_convergence, [
        "--warm-study", "--device", "cpu", "--board", "19", "--batch", "64", "--warmup-steps", "160",
        "--measure-steps", "32"], capsys)
    assert rc == 0 and rec["fixpoint_equal_every_step"] and rec["equal_steps"] == 32
    assert "fixpoint equality every step: True" in out
    assert rec["warm"]["per_env_mean"] < rec["cold"]["per_env_mean"]


def test_measure_convergence_prints_its_tables(capsys):
    rc, out, rec = _run_main(measure_convergence, [
        "--device", "cpu", "--board", "9", "--batch", "64", "--warmup-steps", "40", "--measure-steps", "6",
        "--maxk", "40"], capsys)
    assert rc == 0 and rec["steps"] == 6 and rec["kernel_checked_steps"] == 0
    for line in ("stone-bits: per-env mean=", "claim-bits: per-env mean=", "steady-state 9x9 B=64, T=6 steps",
                 "per-env conv substeps: mean=", "batch-max per step: mean=", "block K=    8:",
                 "block K=   64:"):
        assert line in out, line
    assert set(rec["work_ratio"]) == {"8", "16", "32", "64"} and rec["work_ratio"]["64"] == 1.0


def test_search_cost_ablation_prints_every_component(capsys):
    rc, out, rec = _run_main(search_cost_ablation, [
        "--device", "cpu", "--board", "5", "--batch", "8", "--sims", "4"], capsys)
    names = ["step_states", "masked_policy (net)", "selection (tables+walk)", "node write (state+prior)",
             "node row gather", "backup scatter-add"]
    assert rc == 0 and [r["component"] for r in rec["components"]] == names
    for name in names:
        assert any(line.startswith(name) and "ms/sim" in line for line in out.splitlines()), name
    assert "call overhead (null loop)" in out


def test_walk_depth_study_prints_its_table(capsys):
    rc, out, rec = _run_main(walk_depth_study, [
        "--device", "cpu", "--board", "5", "--sims", "8", "--gumbel-m", "4", "--batches", "4,8",
        "--searches", "2"], capsys)
    assert rc == 0 and [r["batch"] for r in rec["rows"]] == [4, 8]
    assert "| B | per-env mean depth | p99 | mean batch-max | walk-trip ratio vs B=4 |" in out
    assert rec["rows"][0]["ratio"] == 1.0 and all(r["mean_depth"] >= 1 for r in rec["rows"])


def test_recording_walk_puts_the_original_back():
    from gymgo_tpu_torch.rl import treewalk

    original = treewalk.walk_paths
    with pytest.raises(RuntimeError):
        with walk_depth_study.recording_walk():
            assert treewalk.walk_paths is not original
            raise RuntimeError
    assert treewalk.walk_paths is original


def test_walk_depths_match_jax_script(monkeypatch):
    """The JAX script runs as it is (its flags at a tiny size), its net patched
    to float32 so both packages' nets agree; what its ``io_callback`` wrapper
    receives is copied out, and the port searches the same boards with the
    same net and noise."""
    import jax.experimental

    import gymgo_tpu.models as jmodels
    from gymgo_tpu.config import EnvConfig as JEnvConfig
    from gymgo_tpu.core.state import batch_init_state as jbatch_init_state
    from gymgo_tpu.env.batch_env import rollout as jrollout

    n, sims, m, channels, batches, searches = 5, 8, 4, 8, (4, 8), 2
    spec = importlib.util.spec_from_file_location("jax_walk_depth_study", _REPO / "scripts" / "walk_depth_study.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    recorded, params = [], []
    real_callback, real_init = jax.experimental.io_callback, jmodels.init_params

    def spy(callback, result_shape, *args, **kw):
        def both(d):
            recorded.append(np.array(d))
            return callback(d)
        return real_callback(both, result_shape, *args, **kw)

    def init_params(*args, **kw):
        params.append(real_init(*args, **kw))
        return params[-1]

    monkeypatch.setattr(jax.experimental, "io_callback", spy)
    monkeypatch.setattr(jmodels, "AZNetConfig", functools.partial(jmodels.AZNetConfig, dtype=jnp.float32))
    monkeypatch.setattr(jmodels, "init_params", init_params)
    monkeypatch.setattr(sys, "argv", [
        "walk_depth_study.py", "--board", str(n), "--sims", str(sims), "--gumbel-m", str(m), "--channels",
        str(channels), "--blocks", "1", "--batches", ",".join(map(str, batches)), "--searches", str(searches)])
    script.main()
    monkeypatch.undo()
    assert len(recorded) == len(batches) * searches * sims

    # the script's boards, by its own expression
    max_b = max(batches)
    cfg = JEnvConfig(board_size=n, batch_size=max_b, auto_reset=True)
    boards = np.asarray(jax.jit(lambda k, s: jrollout(k, s, 96, cfg).final_states)(
        jax.random.PRNGKey(1), jbatch_init_state(max_b, n)))
    tcfg = AZNetConfig(board_size=n, channels=channels, blocks=1, dtype=torch.float32)
    tnet = AZNet(tcfg).eval()
    tnet.load_state_dict(convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params[0]), tcfg))
    got = []
    for bs in batches:
        for i in range(searches):
            noise = np.array(jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(2), i), (bs, n * n + 1)))
            got += walk_depth_study.search_depths(torch.from_numpy(boards[:bs]), tnet, sims, m,
                                                  gumbel=torch.from_numpy(noise))
    assert len(got) == len(recorded)
    for sim, (t, j) in enumerate(zip(got, recorded)):
        np.testing.assert_array_equal(t, j, err_msg=f"simulation {sim}")
    assert max(int(d.max()) for d in got) >= 2  # some walk went past the root
