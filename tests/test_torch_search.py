"""gymgo_tpu_torch.rl (treewalk, gumbel_mcts, search) against gymgo_tpu.rl.

Both packages get the same net weights (float32), the same states and the same
Gumbel noise: the noise the JAX function draws from its key, drawn here with
that key and handed to the port.  Integer outputs (tables, paths, actions,
visit counts, candidates) are compared bit for bit; the floats (improved
policy, root value, q) with atol 1e-5, since softmax, log and the net's sums
round differently in the two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import actions as jactions
from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.rl import gumbel_mcts as jgumbel
from gymgo_tpu.rl import search as jsearch
from gymgo_tpu.rl import treewalk as jtreewalk
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as tactions
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.core.step import step_states
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.rl import gumbel_mcts as tgumbel
from gymgo_tpu_torch.rl import search as tsearch
from gymgo_tpu_torch.rl import treewalk as ttreewalk
from torch_boards import crafted_state, midgame_states

FLOAT_ATOL = 1e-5


def _nets(n, seed=0):
    """The same random float32 net in both packages: (apply_fn, params, tnet)."""
    jcfg = jaz.AZNetConfig(board_size=n, channels=16, blocks=2, policy_channels=2,
                           value_channels=2, dtype=jnp.float32)
    leaves, treedef = jax.tree_util.tree_flatten(jaz.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    tcfg = AZNetConfig(board_size=n, channels=16, blocks=2, policy_channels=2, value_channels=2,
                       dtype=torch.float32)
    tnet = AZNet(tcfg).eval()
    tnet.load_state_dict(convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jaz.AZNet(jcfg).apply, params, tnet


def _search_boards(n):
    """Mid-game boards plus an env with fewer legal moves than candidates, a
    finished env and one where a pass wins at once."""
    cells = [(r, c) for r in range(n) for c in range(n)]
    crowded = crafted_state(n, black=cells[: n * n - 3 : 2], white=cells[1 : n * n - 3 : 2])
    finished = crafted_state(n, black=cells[:n], white=cells[-n:], prev_passed=True, done=True)
    winning_pass = crafted_state(n, black=cells[: 2 * n], white=[cells[-1]], prev_passed=True)
    mid = np.concatenate([midgame_states(n, 6, n * n // 3, 1), midgame_states(n, 5, n * n, 2)])
    return np.concatenate([mid, np.stack([crowded, finished, winning_pass])])


@pytest.mark.parametrize("n_m", [(32, 16), (16, 16), (7, 4), (64, 8), (1, 16), (200, 16), (12, 26), (8, 2)])
def test_schedule_matches_jax(n_m):
    assert tgumbel.seq_halving_schedule(*n_m) == jgumbel.seq_halving_schedule(*n_m)
    assert len(tgumbel.seq_halving_schedule(*n_m)) == n_m[0]


def _random_tree(rng, b, m, a):
    """Random tree tables: child pointers only to later slots (strict descent),
    scores with -inf, ties, and rows that are all -inf."""
    child = np.full((b, m, a), -1, np.int32)
    for i in range(b):
        for node in range(1, m):  # each node hangs under an earlier one
            parent = rng.integers(0, node)
            child[i, parent, rng.integers(0, a)] = node
    scores = rng.integers(-3, 4, (b, m, a)).astype(np.float32)  # many ties
    scores[rng.random((b, m, a)) < 0.3] = -np.inf
    # make the best edge lead somewhere often, so that the walks go deep
    for i in range(b):
        for node in range(m):
            acts = np.flatnonzero(child[i, node] >= 0)
            if len(acts) and rng.random() < 0.8:
                scores[i, node, rng.choice(acts)] = 5.0
    scores[:, m // 2] = -np.inf
    node_done = rng.random((b, m)) < 0.15
    node_done[:, 0] = False
    return scores, child, node_done


@pytest.mark.parametrize("seed,b,m,a", [(0, 16, 9, 26), (1, 8, 17, 50), (2, 32, 5, 10)])
def test_treewalk_matches_jax(seed, b, m, a):
    rng = np.random.default_rng(seed)
    scores, child, node_done = _random_tree(rng, b, m, a)
    jt = jtreewalk.node_tables(jnp.asarray(scores), jnp.asarray(child), jnp.asarray(node_done))
    tt = ttreewalk.node_tables(torch.from_numpy(scores), torch.from_numpy(child), torch.from_numpy(node_done))
    for j, t in zip(jt, tt):
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert (np.asarray(jt[0])[:, m // 2] == 0).all()  # an all -inf row picks action 0

    forced = rng.integers(0, a, b).astype(np.int32)
    forced[: b // 2] = [np.flatnonzero(child[i, 0] >= 0)[0] for i in range(b // 2)]
    jf = jtreewalk.forced_root_edge(jnp.asarray(forced), jnp.asarray(child), jnp.asarray(node_done))
    tf = ttreewalk.forced_root_edge(torch.from_numpy(forced), torch.from_numpy(child), torch.from_numpy(node_done))
    for j, t in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())

    parent = rng.integers(0, m, b).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jtreewalk.gather_edge(jnp.asarray(child), jnp.asarray(parent), jnp.asarray(forced))),
        ttreewalk.gather_edge(torch.from_numpy(child), torch.from_numpy(parent), torch.from_numpy(forced)).numpy())
    values = rng.standard_normal((b, m)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jtreewalk.gather_node(jnp.asarray(values), jnp.asarray(parent))),
        ttreewalk.gather_node(torch.from_numpy(values), torch.from_numpy(parent)).numpy())

    for max_depth in (m + 1, 3):
        for use_forced in (False, True):
            jw = jtreewalk.walk_paths(*jt, max_depth, forced_root=(jnp.asarray(forced), *jf) if use_forced else None)
            tw = ttreewalk.walk_paths(
                *tt, max_depth, forced_root=(torch.from_numpy(forced), *tf) if use_forced else None)
            for j, t in zip(jw, tw):
                assert np.asarray(j).dtype == t.numpy().dtype
                np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert np.asarray(jw[0]).max() >= 2  # some walk went past the root


def _assert_search_equal(jres, tres, valid_root):
    np.testing.assert_array_equal(tres.actions.numpy(), np.asarray(jres.actions))
    np.testing.assert_array_equal(tres.root_visits.numpy(), np.asarray(jres.root_visits))
    # candidates past an env's valid moves are the tail of a tie of -inf: both
    # packages order it by index (a stable sort here), so they agree there too
    jc = np.asarray(jres.sampled_actions)
    np.testing.assert_array_equal(tres.sampled_actions.numpy(), jc)
    cand_valid = np.take_along_axis(valid_root, jc, axis=1)
    np.testing.assert_allclose(tres.improved_policy.numpy(), np.asarray(jres.improved_policy),
                               rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(tres.root_value.numpy(), np.asarray(jres.root_value), rtol=0, atol=FLOAT_ATOL)
    for got, want in zip(tres, jres):
        assert got.numpy().dtype == np.asarray(want).dtype and got.shape == want.shape
    return cand_valid


@pytest.mark.parametrize("n,sims,m,pass_min_stones", [(5, 16, 8, 0), (5, 8, 4, 1 << 20), (7, 12, 16, 0)])
def test_gumbel_mcts_matches_jax_given_the_noise(n, sims, m, pass_min_stones):
    apply_fn, params, tnet = _nets(n, seed=n)
    states = _search_boards(n)
    b, a = len(states), n * n + 1
    key = jax.random.PRNGKey(sims)
    jres = jax.jit(lambda k, s: jgumbel.run_gumbel_mcts(
        k, s, params, apply_fn, num_simulations=sims, max_considered=m, komi=0.5,
        pass_min_stones=pass_min_stones))(key, jnp.asarray(states))
    noise = np.asarray(jax.random.gumbel(key, (b, a)))  # gumbel_mcts.py: g = gumbel(key, (b, a_size))
    tres = tgumbel.run_gumbel_mcts(
        None, torch.from_numpy(states), tnet, num_simulations=sims, max_considered=m, komi=0.5,
        pass_min_stones=pass_min_stones, gumbel=torch.from_numpy(noise))
    valid_root = np.asarray(jactions.mask_early_pass(
        jactions.batch_valid_moves(jnp.asarray(states)) > 0, jnp.asarray(states), pass_min_stones))
    cand_valid = _assert_search_equal(jres, tres, valid_root)
    visits = tres.root_visits.numpy()
    assert (visits.sum(1) == sims).all()
    assert (visits[~valid_root] == 0).all() and (tres.improved_policy.numpy()[~valid_root] == 0).all()
    assert valid_root[np.arange(b), tres.actions.numpy()].all()
    if pass_min_stones == 0:
        assert not cand_valid[-3].all()  # the crowded env has fewer valid moves than candidates
        assert int(tres.actions[-1]) == n * n  # the winning pass is found
    assert len(set(tres.actions.tolist())) > 3


def test_gumbel_mcts_draws_its_own_noise_from_the_generator():
    _, _, tnet = _nets(5)
    states = torch.from_numpy(_search_boards(5))
    run = lambda seed: tgumbel.run_gumbel_mcts(
        torch.Generator().manual_seed(seed), states, tnet, num_simulations=8, max_considered=8)
    r1, r2, r3 = run(1), run(1), run(2)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert not torch.equal(r1.sampled_actions, r3.sampled_actions)
    np.testing.assert_allclose(r1.improved_policy.sum(1).numpy(), 1.0, rtol=1e-5)


def test_gumbel_mcts_finds_winning_pass():
    """Black has a stone, white just passed: passing ends the game with a
    black win.  The halving winner must be the provably winning pass."""
    _, _, tnet = _nets(5)
    states = batch_init_state(1, 5, device="cpu")
    states, _ = step_states(states, torch.tensor([12]))  # black centre
    states, _ = step_states(states, torch.tensor([25]))  # white passes
    res = tgumbel.run_gumbel_mcts(torch.Generator().manual_seed(0), states, tnet,
                                  num_simulations=32, max_considered=26, c_scale=1.0)
    assert int(res.actions[0]) == 25, res.root_visits[0]
    assert int(res.improved_policy[0].argmax()) == 25


def _uniform_net(n):
    def net(canonical):
        b = canonical.shape[0]
        return torch.zeros((b, n * n + 1)), torch.zeros((b,))

    return net


def _oracle_board(n, black_ahead):
    s = np.zeros((1, 6, n, n), np.int8)
    s[0, 0 if black_ahead else 1, :3, :] = 1  # 15 stones for the leader
    s[0, 1 if black_ahead else 0, 4, 0] = 1
    s[0, 4] = 1  # the previous move was a pass; black to move
    return torch.from_numpy(s)


def test_improvement_operator_sign_oracle():
    """A pass that would end the game as a certain win must receive maximal
    improved-policy mass; the mirrored losing pass must get ~zero.  This pins
    the sign conventions of the whole search and backup pipeline."""
    n = 5
    net = _uniform_net(n)
    g = torch.Generator().manual_seed(0)
    res_win = tgumbel.run_gumbel_mcts(g, _oracle_board(n, True), net, num_simulations=64,
                                      max_considered=n * n + 1)
    res_lose = tgumbel.run_gumbel_mcts(g, _oracle_board(n, False), net, num_simulations=64,
                                       max_considered=n * n + 1)
    pass_idx = n * n
    assert int(res_win.actions[0]) == pass_idx
    assert float(res_win.improved_policy[0, pass_idx]) > 0.95
    assert float(res_lose.improved_policy[0, pass_idx]) < 0.01
    assert int(res_lose.actions[0]) != pass_idx

    # one-ply operator: exact terminal q for the ending pass
    for black_ahead, q in ((True, 1.0), (False, -1.0)):
        r = tsearch.gumbel_oneply(g, _oracle_board(n, black_ahead), net, num_sampled=n * n + 1)
        slot = int(torch.where(r.sampled_actions[0] == pass_idx)[0][0])
        assert float(r.q_values[0, slot]) == q


@pytest.mark.parametrize("n,k,pass_min_stones", [(5, 8, 0), (7, 16, 1 << 20)])
def test_gumbel_oneply_matches_jax_given_the_noise(n, k, pass_min_stones):
    apply_fn, params, tnet = _nets(n, seed=3)
    states = _search_boards(n)
    b, a = len(states), n * n + 1
    key = jax.random.PRNGKey(n)
    jres = jax.jit(lambda kk, s: jsearch.gumbel_oneply(
        kk, s, params, apply_fn, num_sampled=k, c_q=2.0, komi=0.5,
        pass_min_stones=pass_min_stones))(key, jnp.asarray(states))
    noise = np.asarray(jax.random.gumbel(key, (b, a)))
    tres = tsearch.gumbel_oneply(None, torch.from_numpy(states), tnet, num_sampled=k, c_q=2.0,
                                 komi=0.5, pass_min_stones=pass_min_stones, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(tres.actions.numpy(), np.asarray(jres.actions))
    np.testing.assert_array_equal(tres.sampled_actions.numpy(), np.asarray(jres.sampled_actions))
    np.testing.assert_allclose(tres.q_values.numpy(), np.asarray(jres.q_values), rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(tres.improved_policy.numpy(), np.asarray(jres.improved_policy),
                               rtol=0, atol=FLOAT_ATOL)
    for got, want in zip(tres, jres):
        assert got.numpy().dtype == np.asarray(want).dtype and got.shape == want.shape
    # the finished env's children are finished: q is the exact outcome
    assert set(np.unique(tres.q_values.numpy()[-2])) <= {-1.0, 1.0}


@pytest.mark.parametrize("maker", ["gumbel", "oneply"])
def test_search_policies_drive_a_rollout(maker):
    _, _, tnet = _nets(5)
    policy = (tgumbel.make_gumbel_mcts_policy(tnet, num_simulations=8, max_considered=4) if maker == "gumbel"
              else tsearch.make_search_policy(tnet, num_sampled=6))
    cfg = EnvConfig(board_size=5, batch_size=4, auto_reset=True)
    r = rollout(torch.Generator().manual_seed(5), batch_init_state(4, 5, device="cpu"), 6, cfg,
                policy_fn=policy)
    assert r.actions.shape == (6, 4) and r.actions.dtype == torch.int32
    assert r.final_states.shape == (4, 6, 5, 5) and not r.invalid.any()
