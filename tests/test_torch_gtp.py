"""gymgo_tpu_torch.utils.gtp against gymgo_tpu.utils.gtp.

The command sessions of ``tests/test_gtp.py`` (the command lists copied) go
through the JAX package's ``GTPEngine`` and the port's, on the native backend
(against JAX's native engine) and on the torch backend on the CPU (against
JAX's ``gogame`` fallback, its native engine switched off): the responses are
equal string for string, the final states and move lists equal.  The net
movers (greedy, PUCT with subtree reuse, Gumbel given JAX's per-move draws)
play the same moves as JAX's, both computing in float32; ``make_net_genmove``
reads the three checkpoint kinds and raises on a width mismatch.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymgo_tpu.models
from gymgo_tpu import native as jnative
from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.utils import checkpoint as jckpt
from gymgo_tpu.utils import gtp as jgtp
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.utils import checkpoint as tckpt
from gymgo_tpu_torch.utils import gtp as tgtp

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
KGS = os.path.join(FIXTURES, "handicap_kgs_style.sgf")
COLLECTION = os.path.join(FIXTURES, "collection_two_games.sgf")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these tiny nets gain nothing from more threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _alternating(k, first="b"):
    colors = ("b", "w") if first == "b" else ("w", "b")
    return [f"genmove {colors[i % 2]}" for i in range(k)]


def _inject_winning_position(eng):
    """test_gtp.py's pass-rule board: black ahead, white just passed."""
    s = np.zeros((6, 5, 5), np.int8)
    s[0, :3, :] = 1
    s[4] = 1
    eng.state = s


# (board size, komi, seed, match_pass_rule, commands); a callable entry acts
# on the engine instead of sending a line
SESSIONS = {
    "protocol": (9, 5.5, 0, False, [
        "protocol_version", "name", "version", "list_commands", "known_command play",
        "known_command frobnicate", "7 name", "# a comment", "   ", "frobnicate", "12", "genmove",
        "genmove x", "komi abc", "boardsize", "quit"]),
    "play_and_rules": (5, 0.0, 0, False, [
        "play b C3", "play b C4", "play w C3", "play w Z9", "play w pass", "undo", "play w C4", "showboard",
        "undo", "undo", "undo", "play x C3", "play b", "komi 2.5", "final_score", "boardsize 7", "showboard",
        "boardsize 25", "play b D4", "showboard"]),
    "random_game": (5, 2.5, 1, False, _alternating(200) + ["final_score", "showboard", "play b C3", "genmove w"]),
    "legality_stream": (7, 0.0, 3, False, _alternating(60) + ["final_score"]),
    "pass_rule": (5, 0.0, 1, True, [_inject_winning_position, "genmove b", "showboard", "clear_board"]
                  + _alternating(6) + ["final_score"]),
    "loadsgf": (19, 7.5, 0, False, [
        f"loadsgf {KGS}", "showboard", "final_score", "genmove w", "genmove b", f"loadsgf {KGS} 5", "showboard",
        "loadsgf /no/such/file.sgf", f"loadsgf {COLLECTION}", "showboard", "komi 0.5", "final_score", "undo",
        "genmove b"]),
    "handicap": (9, 0.0, 0, False, [
        "fixed_handicap 4", "showboard", "genmove w", "fixed_handicap 2", "clear_board", "fixed_handicap 1",
        "fixed_handicap 10", "fixed_handicap", "clear_board", "fixed_handicap 5", "showboard", "clear_board",
        "set_free_handicap C3 G7 E5", "showboard", "genmove w", "genmove b", "clear_board",
        "set_free_handicap C3 C3", "set_free_handicap C3 pass", "set_free_handicap C3", "boardsize 19",
        "fixed_handicap 9", "showboard"] + _alternating(40, first="w") + ["final_score"]),
}


def _without_jax_native(monkeypatch):
    def unavailable(n):
        raise RuntimeError("native engine switched off")

    monkeypatch.setattr(jnative, "NativeGoEngine", unavailable)


def _run(eng, commands):
    out = []
    for c in commands:
        if callable(c):
            c(eng)
        else:
            out.append(eng.handle(c))
    return out


@pytest.mark.parametrize("backend", ["native", "torch"])
@pytest.mark.parametrize("name", list(SESSIONS))
def test_sessions_match_jax_string_for_string(name, backend, monkeypatch):
    n, komi, seed, rule, commands = SESSIONS[name]
    if backend == "torch":
        _without_jax_native(monkeypatch)
    jeng = jgtp.GTPEngine(n, komi, seed=seed, match_pass_rule=rule)
    teng = tgtp.GTPEngine(n, komi, seed=seed, match_pass_rule=rule, backend=backend, device="cpu")
    assert (jeng._native is None) == (backend == "torch") and teng.backend == backend
    want, got = _run(jeng, commands), _run(teng, commands)
    for c, w, g in zip([c for c in commands if not callable(c)], want, got):
        assert g == w, c
    np.testing.assert_array_equal(teng.state, jeng.state)
    assert teng.moves == jeng.moves and teng.n == jeng.n and teng.komi == jeng.komi


def test_raw_pass_and_vertices():
    eng = tgtp.GTPEngine(5, komi=0.0, genmove_fn=lambda st: 25, match_pass_rule=False, backend="native")
    resp, err, _ = eng.handle("genmove b")
    assert not err and resp == jgtp.GTPEngine(5, 0.0, genmove_fn=lambda st: 25).handle("genmove b")[0]
    for n in (5, 9, 19):
        for a in range(n * n + 1):
            v = tgtp._action_to_vertex(a, n)
            assert v == jgtp._action_to_vertex(a, n)
            assert tgtp._vertex_to_action(v, n) == a
        for k in range(0, 11):
            assert tgtp.fixed_handicap_points(n, k) == jgtp.fixed_handicap_points(n, k)
    for v in ("J1", "A1", "A9", "I5", "Z1", "A0", "A10", "pass", "Q", "B2x"):
        assert tgtp._vertex_to_action(v, 9) == jgtp._vertex_to_action(v, 9)


def test_torch_backend_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgtp.GTPEngine(5, backend="torch")
    with pytest.raises(ValueError):
        tgtp.GTPEngine(5, backend="jax")


# --------------------------------------------------------------- net movers

N = 5


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """A 5x5 8x1 net from JAX's init_params (heads of the default width),
    saved as a params-only artifact; a little noise keeps logits apart."""
    cfg = jaz.AZNetConfig(board_size=N, channels=8, blocks=1)
    leaves, treedef = jax.tree_util.tree_flatten(jaz.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    leaves = [np.asarray(x) + 0.2 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    path = str(tmp_path_factory.mktemp("gtp") / "net5.npz")
    jckpt.save_npz(path, {"params": jax.tree_util.tree_unflatten(treedef, leaves)})
    return path


@pytest.fixture
def jax_float32(monkeypatch):
    """JAX's make_net_genmove builds its net from ``gymgo_tpu.models``'
    ``AZNetConfig`` at the call: make it compute in float32, as the port's
    test movers do."""
    monkeypatch.setattr(gymgo_tpu.models, "AZNetConfig", functools.partial(jaz.AZNetConfig, dtype=jnp.float32))


MOVER_SESSION = (_alternating(5) + ["play w C3", "play w B2", "genmove w", "play b pass"] + _alternating(3, "w")
                 + ["undo", "genmove w", "genmove b", "clear_board", "genmove b", "play w D4", "genmove b",
                    "genmove w", "final_score"])


def _mover_sessions(jfn, tfn, pass_rule):
    jeng = jgtp.GTPEngine(N, 0.5, jfn, seed=2, match_pass_rule=pass_rule)
    teng = tgtp.GTPEngine(N, 0.5, tfn, seed=2, match_pass_rule=pass_rule, backend="native")
    want, got = _run(jeng, MOVER_SESSION), _run(teng, MOVER_SESSION)
    assert got == want
    assert sum(r[0].startswith("= ") and r[0][2:4].strip() not in ("", "pa") for r in got) >= 4
    return teng


def test_greedy_mover_matches_jax(jax_artifact, jax_float32):
    jfn = jgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=0)
    tfn = tgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=0, device="cpu", dtype=torch.float32)
    _mover_sessions(jfn, tfn, pass_rule=True)


def test_puct_mover_with_subtree_reuse_matches_jax(jax_artifact, jax_float32):
    jfn = jgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=8, search="puct", seed=1, num_parallel=2,
                                komi=0.5)
    tfn = tgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=8, search="puct", seed=1, num_parallel=2,
                                komi=0.5, device="cpu", dtype=torch.float32)
    assert isinstance(tfn, tgtp.PUCTMover)
    teng = _mover_sessions(jfn, tfn, pass_rule=False)
    # the carried tree survives play and genmove, and undo / clear_board drop it
    assert tfn._tree is not None
    teng.handle("play b C2" if teng._turn() == 0 else "play w C2")
    assert tfn._tree is not None
    teng.handle("undo")
    assert tfn._tree is None
    teng.handle("genmove " + ("b" if teng._turn() == 0 else "w"))
    assert tfn._tree is not None and tfn._tree.node_states.shape[1] == 8  # descended into the reuse cap
    teng.handle("clear_board")
    assert tfn._tree is None


def test_gumbel_mover_given_jax_draws_matches_jax(jax_artifact, jax_float32):
    seed, sims = 3, 8
    jfn = jgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=sims, seed=seed, komi=0.5)
    key = [jax.random.PRNGKey(seed)]

    def jax_draws():  # make_net_genmove's mover: key, sub = split(key); gumbel(sub, (1, A))
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.asarray(jax.random.gumbel(sub, (1, N * N + 1))))

    tfn = tgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=sims, seed=seed, komi=0.5, device="cpu",
                                dtype=torch.float32, gumbel_source=jax_draws)
    assert isinstance(tfn, tgtp.GumbelMover)
    _mover_sessions(jfn, tfn, pass_rule=True)


def test_gtp_match_game_with_the_pass_rule_counted_matches_jax(jax_artifact, jax_float32):
    """A whole gtp_match game, the Gumbel mover (given JAX's draws) against
    random, under the match pass rule: the result, and per genmove whether
    the rule replaced a pass and the mover's lead, equal JAX's."""
    from torch_pass_rule import _jax_gtp_match, counting

    from gymgo_tpu_torch.scripts import gtp_match

    seed, sims = 3, 8
    key = [jax.random.PRNGKey(seed)]

    def jax_draws():
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.asarray(jax.random.gumbel(sub, (1, N * N + 1))))

    jnet = jgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=sims, seed=seed)
    tnet = tgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=sims, seed=seed, device="cpu",
                                 dtype=torch.float32, gumbel_source=jax_draws)
    runs = []
    for match, cls, net, kw in ((_jax_gtp_match(), jgtp.GTPEngine, jnet, {}),
                                (gtp_match, tgtp.GTPEngine, tnet, {"backend": "native"})):
        black = cls(N, 0.0, net, seed, match_pass_rule=True, **kw)
        white = cls(N, 0.0, None, seed + 1, match_pass_rule=True, **kw)
        with counting(cls) as log:
            result = match.play_game(black, white, N, 3 * N * N)
        runs.append((result, [(eng is black, replaced, lead) for eng, replaced, lead in log]))
    assert runs[1] == runs[0]
    assert any(replaced for _, replaced, _ in runs[0][1])


def test_make_net_genmove_reads_every_checkpoint_kind(tmp_path, jax_artifact):
    from test_torch_checkpoint import BLOCKS, CH, _jax_checkpoint

    jtrain = tmp_path / "jax_train.npz"
    _jax_checkpoint(jtrain)
    port = tmp_path / "port_train.npz"
    tckpt.save_npz(port, convert.trainer_tree_from_jax_npz(jtrain))
    artifact = tmp_path / "artifact.npz"
    jckpt.save_npz(str(artifact), {"params": convert.read_flax_npz(jtrain)})
    sessions = []
    for path in (jtrain, port, artifact):
        fn = tgtp.make_net_genmove(str(path), N, CH, BLOCKS, device="cpu", dtype=torch.float32)
        sessions.append(_run(tgtp.GTPEngine(N, 0.5, fn, backend="native"), _alternating(12)))
        with pytest.raises(ValueError, match="16x1"):
            tgtp.make_net_genmove(str(path), N, CH, BLOCKS + 1, device="cpu")
        with pytest.raises(ValueError):
            tgtp.make_net_genmove(str(path), N + 2, CH, BLOCKS, device="cpu")
    assert sessions[0] == sessions[1] == sessions[2]
    with pytest.raises(ValueError, match="8x1"):
        tgtp.make_net_genmove(jax_artifact, N, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="search"):
        tgtp.make_net_genmove(jax_artifact, N, 8, 1, simulations=4, search="mcts", device="cpu")
