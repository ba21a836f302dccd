"""The compiled search of the port on the CPU: the sync-free tree walk
against the JAX package's ``lax.while_loop`` walk, the walk's depth bound on
the trees of real searches, the graphs' key under ``set_gumbel_pack`` and
their nested calls, the self-play move and the match ply (the bodies the
card captures) against the JAX package's scans, and ``profiling.trace``.

Where a test needs the graph path, a stand-in takes the capture's place (a
graph needs a card: ``tests/test_torch_cuda.py`` captures for real): a
capture runs the function as the real capture's eager first run does, with
nested compiled calls inline, and a replay runs it again on the leaves it is
handed, as the graph would replay their copies.
"""

import contextlib
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.rl import evaluate as jevaluate
from gymgo_tpu.rl import selfplay as jselfplay
from gymgo_tpu.rl import treewalk as jtreewalk
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.rl import evaluate as tevaluate
from gymgo_tpu_torch.rl import gumbel_mcts as tgumbel
from gymgo_tpu_torch.rl import mcts as tmcts
from gymgo_tpu_torch.rl import selfplay as tselfplay
from gymgo_tpu_torch.rl import treewalk as ttreewalk
from gymgo_tpu_torch.utils import graphs
from gymgo_tpu_torch.utils.profiling import trace
from test_torch_compiled import recording  # noqa: F401  (the stand-in capture's fixture)
from test_torch_evaluate import _jax_opening_noise, _jax_policy, _policy_table, _torch_policy
from test_torch_mcts import _mcts_noise_rows
from test_torch_search import _nets, _search_boards
from test_torch_selfplay import _gumbels

FLOAT_ATOL = 5e-5  # the policy targets, as tests/test_torch_selfplay.py holds them


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the walk


def _tree_tables(rng, b, m, a, p_child=0.7, p_done=0.15):
    """Random (best_act, nxt_tab, keep_tab) of trees whose child slots
    exceed their parents', as every search fills them."""
    best = rng.integers(0, a, (b, m)).astype(np.int32)
    nxt = np.full((b, m), -1, np.int32)
    for j in range(m - 1):
        has = rng.random(b) < p_child
        nxt[has, j] = rng.integers(j + 1, m, has.sum())
    keep = (nxt >= 0) & (rng.random((b, m)) >= p_done)
    return best, nxt, keep


def _forced(rng, b, m, a):
    nxt = np.where(rng.random(b) < 0.8, rng.integers(1, m, b), -1).astype(np.int32)
    return rng.integers(0, a, b).astype(np.int32), nxt, (nxt >= 0) & (rng.random(b) < 0.9)


def _walk_both(tables, max_depth, forced, depth_bound=None):
    j = jtreewalk.walk_paths(*map(jnp.asarray, tables), max_depth,
                             forced_root=None if forced is None else tuple(map(jnp.asarray, forced)))
    t = ttreewalk.walk_paths(*map(torch.from_numpy, tables), max_depth,
                             forced_root=None if forced is None else tuple(map(torch.from_numpy, forced)),
                             depth_bound=depth_bound)
    for got, want in zip(t, j):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return t


@pytest.mark.parametrize("use_forced", [False, True], ids=["free-root", "forced-root"])
def test_walk_matches_jax_on_random_trees(use_forced):
    rng = np.random.default_rng(3)
    b, m, a = 64, 17, 10
    tables = _tree_tables(rng, b, m, a)
    forced = _forced(rng, b, m, a) if use_forced else None
    depth, _, _ = _walk_both(tables, m, forced)
    assert int(depth.max()) >= 4  # some paths go deep
    # the bound of a tree of m slots is m: the same walk
    _walk_both(tables, m, forced, depth_bound=m)


@pytest.mark.parametrize("use_forced", [False, True], ids=["free-root", "forced-root"])
def test_walk_with_every_lane_closed_at_depth_zero(use_forced):
    rng = np.random.default_rng(4)
    b, m, a = 9, 6, 5
    best, nxt, _ = _tree_tables(rng, b, m, a)
    tables = (best, nxt, np.zeros((b, m), bool))
    forced = None
    if use_forced:
        f_act, f_nxt, _ = _forced(rng, b, m, a)
        forced = (f_act, f_nxt, np.zeros(b, bool))
    for bound in (None, 1):
        depth, path_n, path_a = _walk_both(tables, m, forced, depth_bound=bound)
        assert (depth == 1).all() and (path_n[:, 1:] == -1).all() and (path_a[:, 1:] == -1).all()


@pytest.mark.parametrize("length,max_depth", [(12, 12), (7, 12)])
def test_walk_of_a_path_as_long_as_its_bound(length, max_depth):
    """A chain 0 -> 1 -> ... -> length - 1 in every env, walked with the
    bound ``length``: the last iteration is the one that reaches its end."""
    b, a = 5, 7
    best = np.tile(np.arange(max_depth, dtype=np.int32) % a, (b, 1))
    nxt = np.full((b, max_depth), -1, np.int32)
    nxt[:, : length - 1] = np.arange(1, length)
    tables = (best, nxt, nxt >= 0)
    depth, path_n, _ = _walk_both(tables, max_depth, None, depth_bound=length)
    assert (depth == length).all() and (path_n[:, :length] == np.arange(length)).all()
    with pytest.raises(ValueError, match="depth_bound"):
        ttreewalk.walk_paths(*map(torch.from_numpy, tables), max_depth, depth_bound=max_depth + 1)


@pytest.fixture
def checked_walk(monkeypatch):
    """Every walk of a search is also run to the full depth: no path may be
    longer than the bound the search gave, and the two walks must agree.
    Yields the list of (bound, deepest path) per call."""
    original = ttreewalk.walk_paths
    seen = []

    def walk(best_act, nxt_tab, keep_tab, max_depth, forced_root=None, depth_bound=None):
        full = original(best_act, nxt_tab, keep_tab, max_depth, forced_root)
        got = original(best_act, nxt_tab, keep_tab, max_depth, forced_root, depth_bound)
        assert all(torch.equal(x, y) for x, y in zip(got, full))
        seen.append((depth_bound, int(full[0].max())))
        return got

    monkeypatch.setattr(ttreewalk, "walk_paths", walk)
    return seen


def test_the_depth_bound_holds_on_gumbel_trees(checked_walk):
    _, _, tnet = _nets(5, seed=31)
    states = torch.from_numpy(_search_boards(5))
    sims = 24
    tgumbel.run_gumbel_mcts(torch.Generator().manual_seed(0), states, tnet, num_simulations=sims,
                            max_considered=4)
    assert [bound for bound, _ in checked_walk] == [sim + 1 for sim in range(sims)]
    assert all(deepest <= bound for bound, deepest in checked_walk)
    assert max(deepest for _, deepest in checked_walk) >= 4


@pytest.mark.parametrize("par", [1, 2])
def test_the_depth_bound_holds_on_puct_trees_with_a_warm_tree(par, checked_walk):
    _, _, tnet = _nets(5, seed=32)
    states = torch.from_numpy(_search_boards(5))
    sims, cap = 16, 12
    res, tree = tmcts.run_mcts(torch.Generator().manual_seed(1), states, tnet, num_simulations=sims,
                               num_parallel=par, return_tree=True)
    warm = tmcts.compact_subtree(tree, res.actions, cap)
    nxt_states, _ = tstep.step_states(states, res.actions)
    checked_walk.clear()
    tmcts.run_mcts(torch.Generator().manual_seed(2), nxt_states, tnet, num_simulations=sims, num_parallel=par,
                   warm_tree=warm)
    want = [cap + wave * par for wave in range(sims // par) for _ in range(par)]
    assert [bound for bound, _ in checked_walk] == want
    assert all(deepest <= bound for bound, deepest in checked_walk)
    assert max(deepest for _, deepest in checked_walk) >= 3


# --------------------------------------------------- the key, nested calls


def test_the_key_follows_the_gumbel_tree_layout(recording):
    fn = graphs.compiled(lambda x: None)
    assert fn(torch.zeros(3)) == "captured"
    before = tgumbel.set_gumbel_pack({"i16", "logp"})
    try:
        assert fn(torch.zeros(3)) == "captured"  # another layout: a graph of its own
        assert fn(torch.zeros(3)) == "replayed"
    finally:
        tgumbel.set_gumbel_pack(before)
    assert fn(torch.zeros(3)) == "replayed"  # the first layout's graph again
    assert [len(c.replayed) for c in recording] == [1, 1] and recording[0].key != recording[1].key
    assert isinstance(tgumbel.run_gumbel_mcts, graphs.Compiled)
    assert {"net", "num_simulations", "max_considered"} <= tgumbel.run_gumbel_mcts.static_argnames


def test_a_call_inside_a_capture_runs_inline(recording, monkeypatch):
    calls = []
    fn = graphs.compiled(lambda x: calls.append(x) or "inline")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert fn(torch.zeros(3)) == "inline" and len(calls) == 1
    assert not recording and not fn.graphs
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert fn(torch.zeros(3)) == "captured" and len(calls) == 1


class _Stop(Exception):
    pass


class _NoStream:
    def wait_stream(self, other):
        pass


def test_a_call_inside_an_outer_first_run_runs_inline(monkeypatch):
    """The outer key's eager first run (on a side stream) calls the inner
    compiled function inline: no graph of the inner's is captured.  The
    outer capture itself is stopped where it would make its CUDA graph."""
    monkeypatch.setattr(graphs, "_graph_device", lambda leaves: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _NoStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda **kw: (_ for _ in ()).throw(_Stop()))
    inner_calls = []
    inner = graphs.compiled(lambda x: inner_calls.append(graphs._inline) or 2 * x)
    outer = graphs.compiled(lambda x: inner(x + 1).sum().item())
    with pytest.raises(_Stop):
        outer(torch.ones(3))
    assert inner_calls == [1] and not inner.graphs and graphs._inline == 0


# ------------------------------------- the move and the ply, on the graph path


class _EagerGraph:
    """Replays by running the function on the leaves it is handed, its
    nested compiled calls inline, as the captured graph holds them."""

    def __init__(self, fn, call):
        self.fn, self.call, self.replays = fn, call, 0

    def replay(self, leaves):
        it = iter(leaves)
        bound = inspect.BoundArguments(self.call.bound.signature, dict(self.call.bound.arguments))
        for name in self.call.dynamic:
            bound.arguments[name] = graphs._map(lambda _x: next(it), bound.arguments[name])
        self.replays += 1
        return _inline(self.fn, bound.args, bound.kwargs)


def _inline(fn, args, kwargs):
    with graphs.eager():
        return fn(*args, **kwargs)


_COMPILED = (tselfplay._move, tevaluate._ply, tgumbel.run_gumbel_mcts, tmcts.run_mcts, tmcts.compact_subtree)


@pytest.fixture
def eager_graphs(monkeypatch):
    """Every compiled call takes the graph path, with ``_EagerGraph`` for the
    graph; the graphs made are dropped afterwards."""

    def capture(fn, call, device):
        return _inline(fn, call.bound.args, call.bound.kwargs), _EagerGraph(fn, call)

    monkeypatch.setattr(graphs, "_graph_device", lambda leaves: torch.device("cuda", 0))
    monkeypatch.setattr(graphs, "_capture", capture)
    saved = [dict(c.graphs) for c in _COMPILED]
    yield
    for c, g in zip(_COMPILED, saved):
        c.graphs.clear()
        c.graphs.update(g)


def _replays(compiled_fn):
    return sorted(g.replays for g in compiled_fn.graphs.values())


@pytest.mark.parametrize("mode,n", [("gumbel", 9), ("gumbel", 5), ("puct-subtree", 5)])
def test_the_self_play_move_replays_and_matches_jax(mode, n, eager_graphs):
    apply_fn, params, tnet = _nets(n, seed=40 + n)
    b, steps = 6, 4
    cfg_t = EnvConfig(board_size=n, batch_size=b, komi=0.5, auto_reset=True)
    jcfg = JEnvConfig(board_size=n, batch_size=b, komi=0.5, auto_reset=True)
    starts = rollout(torch.Generator().manual_seed(n), batch_init_state(b, n, device="cpu"), 2 * n * n,
                     cfg_t).final_states.numpy()
    key = jax.random.PRNGKey(n)
    if mode == "gumbel":
        kw = dict(num_simulations=8, max_considered=4, pass_min_stones=3)
        jfinal, jb = jax.jit(lambda k, s: jselfplay.selfplay_gumbel_rollout(
            k, s, params, apply_fn, steps, jcfg, **kw))(key, jnp.asarray(starts))
        tfinal, tb = tselfplay.selfplay_gumbel_rollout(None, torch.from_numpy(starts), tnet, steps, cfg_t,
                                                       gumbel=_gumbels(key, steps, b, n * n + 1), **kw)
        inner = tgumbel.run_gumbel_mcts
    else:
        kw = dict(num_simulations=8, tree_reuse="subtree", reuse_cap=6)
        jfinal, jb = jax.jit(lambda k, s: jselfplay.selfplay_mcts_rollout(
            k, s, params, apply_fn, steps, jcfg, **kw))(key, jnp.asarray(starts))
        dirichlet, gumbel = _mcts_noise_rows(key, steps, b, n * n + 1)
        tfinal, tb = tselfplay.selfplay_mcts_rollout(None, torch.from_numpy(starts), tnet, steps, cfg_t,
                                                     dirichlet=dirichlet, gumbel=gumbel, **kw)
        inner = tmcts.run_mcts
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for name in ("obs", "mask", "mover_white", "done", "grounded", "value_target"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(tb.policy_target.numpy(), np.asarray(jb.policy_target), rtol=0, atol=FLOAT_ATOL)
    assert not tb.invalid.any()
    # one graph for the window's moves, the first captured and the others replayed; the search inside it
    assert _replays(tselfplay._move) == [steps - 1] and not inner.graphs and not tmcts.compact_subtree.graphs


@pytest.mark.parametrize("n,games,max_steps,opening_moves", [(5, 10, 40, 3), (9, 6, 60, 2)])
def test_the_match_ply_replays_and_matches_jax(n, games, max_steps, opening_moves, eager_graphs):
    table_a = _policy_table(n, 5, pass_from=n * n // 2)
    table_b = _policy_table(n, 6, pass_from=n * n // 3)
    key = jax.random.PRNGKey(2 * n + games)
    cfg_j, cfg_t = JEnvConfig(board_size=n, komi=0.5), EnvConfig(board_size=n, komi=0.5)
    jres, jfinal = jax.jit(lambda k: jevaluate.play_match(
        k, _jax_policy(table_a), _jax_policy(table_b), cfg_j, num_games=games, max_steps=max_steps,
        opening_moves=opening_moves, with_states=True))(key)
    noise = torch.from_numpy(_jax_opening_noise(key, opening_moves, games, n))
    policy_a, policy_b = _torch_policy(table_a), _torch_policy(table_b)
    tres, tfinal = tevaluate.play_match(None, policy_a, policy_b, cfg_t, num_games=games, max_steps=max_steps,
                                        opening_moves=opening_moves, with_states=True, opening_noise=noise,
                                        device="cpu")
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for name in jres._fields:
        assert np.asarray(getattr(jres, name)) == getattr(tres, name).numpy(), name
    # two graphs, the opening plies' and the rest's, each captured once and then replayed
    assert len(tevaluate._ply.graphs) == 2 and _opening_replays() == opening_moves - 1
    # the same policies replay in a second match
    tevaluate.play_match(None, policy_a, policy_b, cfg_t, num_games=games, max_steps=2,
                         opening_moves=opening_moves, opening_noise=noise, device="cpu")
    assert len(tevaluate._ply.graphs) == 2 and _opening_replays() == opening_moves + 1


def _opening_replays():
    (graph,) = [g for g in tevaluate._ply.graphs.values() if g.call.bound.arguments["opening"] is not None]
    return graph.replays


# ------------------------------------------------------------------ trace


def test_trace_writes_a_chrome_trace_naming_the_steps_kernels(tmp_path):
    states = batch_init_state(4, 5, device="cpu")
    with trace(str(tmp_path / "t")) as log_dir:
        tstep.step_states(states, torch.tensor([0, 6, 12, 25], dtype=torch.int32))
    assert log_dir == str(tmp_path / "t")
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::bitwise_or" in names and len(events) > 100
