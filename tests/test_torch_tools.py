"""The port's tools (``gymgo_tpu_torch.scripts``, ``demo``, the benches) on
the CPU: ``export_params`` against the committed artifacts bit for bit and a
port-trained net in JAX's ``AZNet.apply``; ``net2net`` preserving the
function and resuming; ``fit_elo`` and ``gtp_match`` against the JAX
scripts; and smoke runs of ``elo_ladder``, ``value_probe``, ``demo``,
``efficiency`` and ``native_batch`` at tiny sizes."""

import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.utils import checkpoint as jckpt
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
from gymgo_tpu_torch.scripts import elo_ladder, export_params, gtp_match, net2net, value_probe
from gymgo_tpu_torch.train import Trainer, build_parser
from torch_boards import midgame_states

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
N, CH, BL = 5, 8, 1
NET_ATOL = 1e-5  # float32 in both libraries: only the order of the sums differs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these tiny nets gain nothing from more threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_net(path):
    return convert.load_aznet_checkpoint(str(path), device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port trainer checkpoint of a 5x5 8x1 net after two iterations."""
    path = tmp_path_factory.mktemp("tools") / "trained.npz"
    args = build_parser().parse_args([
        "--board", str(N), "--envs", "4", "--channels", str(CH), "--blocks", str(BL), "--rollout-steps", "4",
        "--iters", "2", "--train-batch", "16", "--replay-capacity", "32", "--search-k", "4", "--cpu",
        "--checkpoint", str(path)])
    Trainer(args, log=lambda *a, **k: None).run()
    return path


@pytest.mark.parametrize("name", ["az9_r5_iter100", "az19_deep128x9_iter890", "az7_r5_iter120"])
def test_export_of_a_committed_artifact_is_bit_for_bit(name, tmp_path):
    src = ARTIFACTS / f"{name}_params.npz"
    out = tmp_path / "out.npz"
    export_params.export_params(convert.load_aznet_npz(src, device="cpu", dtype=torch.float32), out)
    want, got = np.load(src), np.load(out)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("channels,blocks", [(8, 1), (16, 2), (8, 11)])
def test_treedef_text_equals_what_jax_writes(channels, blocks, tmp_path):
    """A random port net of each width and depth, exported, restored by the
    JAX package into its template and saved again by it: the same file
    (eleven blocks sort ``ResBlock_10`` before ``ResBlock_2``)."""
    net = init_params(torch.Generator().manual_seed(blocks), AZNetConfig(board_size=N, channels=channels,
                                                                          blocks=blocks))
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    export_params.export_params(net, ours)
    jcfg = jaz.AZNetConfig(board_size=N, channels=channels, blocks=blocks)
    restored = jckpt.restore_npz(str(ours), {"params": jaz.init_params(jax.random.PRNGKey(0), jcfg)})
    jckpt.save_npz(str(theirs), restored)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_port_trained_net_runs_in_jax(trained, tmp_path):
    out = tmp_path / "artifact.npz"
    export_params.main(["--ckpt", str(trained), "--out", str(out), "--board", str(N), "--channels", str(CH),
                        "--blocks", str(BL)])
    jcfg = jaz.AZNetConfig(board_size=N, channels=CH, blocks=BL, dtype=jnp.float32)
    params = jckpt.restore_npz(str(out), {"params": jaz.init_params(jax.random.PRNGKey(0), jcfg)})["params"]
    states = midgame_states(N, 32, 9, 4)
    jlogits, jvalue = jaz.AZNet(jcfg).apply(params, jnp.asarray(states))
    net = _port_net(trained)
    with torch.no_grad():
        tlogits, tvalue = net(torch.from_numpy(states))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=NET_ATOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(jvalue), rtol=0, atol=NET_ATOL)
    # and back into the port through the artifact loader, bit for bit
    again = convert.load_aznet_npz(out, device="cpu", dtype=torch.float32)
    for (k, v), (k2, v2) in zip(net.state_dict().items(), again.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    with pytest.raises(ValueError, match="8x1"):
        export_params.main(["--ckpt", str(trained), "--out", str(out), "--board", str(N), "--channels", "16"])


def test_net2net_preserves_the_function_and_resumes(trained, tmp_path):
    grown = tmp_path / "grown.npz"
    net2net.main(["--in", str(trained), "--out", str(grown), "--board", str(N), "--envs", "4", "--channels",
                  str(CH), "--blocks", str(BL), "--new-channels", "16", "--new-blocks", "2", "--replay-capacity",
                  "32", "--noise-scale", "0"])
    old, new = _port_net(trained), _port_net(grown)
    assert (new.config.channels, new.config.blocks) == (16, 2)
    states = torch.from_numpy(midgame_states(N, 16, 7, 5))
    with torch.no_grad():
        for a, b in zip(old(states), new(states)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=NET_ATOL)
    src, out = np.load(trained), np.load(grown)
    for key in src.files:
        if key.startswith(("buf/", "env_states", "generator", "iteration", "step")):
            np.testing.assert_array_equal(out[key], src[key], err_msg=key)
    assert not out["opt_state/exp_avg/stem.weight"].any() and float(out["opt_state/step"]) == 0
    # it resumes for one more iteration of the trainer at the new width
    run = subprocess.run(
        [sys.executable, "-m", "gymgo_tpu_torch.train", "--board", str(N), "--envs", "4", "--channels", "16",
         "--blocks", "2", "--rollout-steps", "4", "--iters", "3", "--train-batch", "16", "--replay-capacity", "32",
         "--search-k", "4", "--cpu", "--resume", str(grown)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-2000:]
    assert "resumed from" in run.stdout and "at iteration 2" in run.stdout and "iter 2: loss=" in run.stdout
    with pytest.raises(ValueError, match="envs"):
        net2net.main(["--in", str(trained), "--out", str(grown), "--board", str(N), "--envs", "5", "--channels",
                      str(CH), "--blocks", str(BL), "--new-channels", "16", "--new-blocks", "2",
                      "--replay-capacity", "32"])


def test_fit_elo_matches_jax():
    jfit = _jax_script("elo_ladder").fit_elo
    rng = np.random.default_rng(0)
    cases = [(["a", "b"], [[0, 3], [1, 0]], [[0, 4], [4, 0]]),
             (["r", "x", "y"], [[0, 0, 0], [8, 0, 2.5], [8, 5.5, 0]], [[0, 8, 8], [8, 0, 8], [8, 8, 0]]),
             (["p", "q", "s", "t"], [[0, 0, 0, 0]] * 4, [[0, 2, 2, 2], [2, 0, 2, 2], [2, 2, 0, 2], [2, 2, 2, 0]])]
    for k in (3, 5):
        games = rng.integers(0, 9, (k, k))
        games = np.triu(games, 1) + np.triu(games, 1).T
        wins = np.floor(rng.uniform(0, 1, (k, k)) * games)
        wins = np.triu(wins, 1) + np.triu(games - wins, 1).T
        cases.append(([str(i) for i in range(k)], wins.tolist(), games.tolist()))
    for names, wins, games in cases:
        for anchor in (0.0, 1000.0):
            assert elo_ladder.fit_elo(names, wins, games, anchor) == jfit(names, wins, games, anchor)


def test_gtp_match_random_games_match_jax():
    jmatch = _jax_script("gtp_match")
    for n, seed in ((5, 0), (7, 3)):
        teng = [gtp_match.build_engine("random", n, 0.5, seed + i, 8, 1) for i in range(2)]
        jeng = [jmatch.build_engine("random", n, 0.5, seed + i, 8, 1) for i in range(2)]
        for g in range(4):
            black, white = (0, 1) if g % 2 == 0 else (1, 0)
            want = jmatch.play_game(jeng[black], jeng[white], n, 3 * n * n)
            got = gtp_match.play_game(teng[black], teng[white], n, 3 * n * n)
            assert got == want
            np.testing.assert_array_equal(teng[black].state, jeng[black].state)
    with pytest.raises(SystemExit):
        gtp_match.build_engine("mystery", 5, 0.5, 0, 8, 1)


def test_gtp_match_and_ladder_with_a_net(trained, capsys):
    gtp_match.main(["--boardsize", str(N), "--games", "2", "--channels", str(CH), "--blocks", str(BL),
                    "--a", f"net:{trained}:0", "--b", "random", "--cpu"])
    assert "winrate=" in capsys.readouterr().out
    elo_ladder.main(["--boardsize", str(N), "--games", "2", "--channels", str(CH), "--blocks", str(BL), "--cpu",
                     "--player", "random", "--player", f"greedy=net:{trained}:0"])
    out = capsys.readouterr().out
    assert "| player | games | score | Elo |" in out and "| greedy | 2 |" in out
    elo_ladder.main(["--boardsize", str(N), "--games", "4", "--chunk", "2", "--channels", str(CH), "--blocks",
                     str(BL), "--cpu", "--batched", "--retries", "0", "--gumbel-m", "4", "--player", "random",
                     "--player", f"net=net:{trained}:4"])
    out = capsys.readouterr().out
    assert "random vs net:" in out and "| net | 4 |" in out


def test_value_probe_smoke(trained, capsys):
    args = ["--ckpt", str(trained), "--board", str(N), "--channels", str(CH), "--blocks", str(BL), "--cpu"]
    value_probe.main(args + ["--games", "32"])
    out = capsys.readouterr().out
    assert "terminal boards: n=" in out and "VERDICT:" in out
    value_probe.main(args + ["--replay-from", str(trained), "--max-rows", "16"])
    out = capsys.readouterr().out
    assert "replay grounded rows:" in out or "no grounded rows" in out


def test_demo_terminal_smoke(trained, tmp_path, monkeypatch, capsys):
    from gymgo_tpu_torch import demo

    record = tmp_path / "game.sgf"
    monkeypatch.setattr(sys, "stdin", io.StringIO("2,2\nzz\n1 1\np\n"))
    np.random.seed(0)
    demo.main(["--boardsize", str(N), "--ai", "net", "--checkpoint", str(trained), "--channels", str(CH),
               "--blocks", str(BL), "--cpu", "--sgf", str(record)])
    out = capsys.readouterr().out
    assert "could not parse move" in out and "saved SGF" in out
    from gymgo_tpu_torch.utils import sgf

    game = sgf.parse_sgf(record.read_text())
    assert game.moves[0] == ("B", 2 * N + 2) and game.moves[2] == ("B", N + 1) and len(game.moves) >= 5
    monkeypatch.setattr(sys, "stdin", io.StringIO("e\n"))
    demo.main(["--boardsize", str(N)])  # the random AI; exit at once
    assert "Result" not in capsys.readouterr().out


def test_benches_smoke(capsys):
    from gymgo_tpu_torch.benchmarks import efficiency, native_batch

    efficiency.main(["--engine", "torch", "--cpu", "--boardsize", "5", "--iterations", "1"])
    out = capsys.readouterr().out
    assert "backend=torch device=cpu" in out and "Rand Trajs w/ Children:" in out
    efficiency.main(["--engine", "native", "--boardsize", "5", "--iterations", "2"])
    out = capsys.readouterr().out
    assert "backend=native" in out and "Ordered Trajs:" in out
    native_batch.main(["--board", "9", "--batch", "32", "--steps", "3", "--warmup", "5", "--cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "native_env_steps_per_sec_9x9" and rec["value"] > 0
