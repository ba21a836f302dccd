"""gymgo_tpu_torch.rl.mcts (PUCT search, waves, tree reuse) against
gymgo_tpu.rl.mcts.

Both packages get the same float32 net, roots and noise: the Dirichlet root
noise and the Gumbel noise of the final pick are drawn here from the two keys
JAX splits its key into, and handed to the port.  Trees, actions, visits and
every integer and bool table must be equal; the floats (priors, value sums,
policies, root values) within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core import step as jstep
from gymgo_tpu.rl import mcts as jmcts
from gymgo_tpu.rl import selfplay as jselfplay
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.rl import mcts as tmcts
from gymgo_tpu_torch.rl import selfplay as tselfplay
from test_torch_search import _nets, _search_boards
from test_torch_selfplay import step_keys

FLOAT_ATOL = 1e-5
N = 5
FLOAT_FIELDS = ("prior", "wsum", "visit_policy", "root_value")


def mcts_noise(key, b, a, alpha=0.3):
    """The Dirichlet and pick noise ``run_mcts(key, ...)`` draws."""
    noise_key, pick_key = jax.random.split(key)
    dirichlet = jax.random.dirichlet(noise_key, jnp.full((a,), alpha), (b,))
    return torch.from_numpy(np.array(dirichlet)), torch.from_numpy(np.array(jax.random.gumbel(pick_key, (b, a))))


def _to_torch(tree):
    return type(tree)(*(torch.from_numpy(np.array(x)) for x in tree))


def _assert_equal(got, want, name=""):
    for field, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, field)
        if field in FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL, err_msg=f"{name} {field}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {field}")


def _search(params, apply_fn, tnet, states, key, **kw):
    b, a = states.shape[0], states.shape[-1] ** 2 + 1
    jres, jtree = jax.jit(lambda k, s: jmcts.run_mcts(k, s, params, apply_fn, return_tree=True, komi=0.5, **kw))(
        key, jnp.asarray(states))
    dirichlet, gumbel = mcts_noise(key, b, a)
    tkw = {k: (_to_torch(v) if k == "warm_tree" else tuple(map(torch.from_numpy, map(np.array, v)))
               if k == "warm_root" else v) for k, v in kw.items()}
    tres, ttree = tmcts.run_mcts(None, torch.from_numpy(np.array(states)), tnet, return_tree=True, komi=0.5,
                                 dirichlet=dirichlet, gumbel=gumbel, **tkw)
    _assert_equal(tres, jres, "result")
    _assert_equal(ttree, jtree, "tree")
    return jres, jtree, tres


@pytest.mark.parametrize("sims,par,pass_min_stones", [(12, 1, 0), (12, 4, 1 << 20)])
def test_run_mcts_matches_jax_given_the_noise(sims, par, pass_min_stones):
    apply_fn, params, tnet = _nets(N, seed=21)
    states = _search_boards(N)
    jres, _, tres = _search(params, apply_fn, tnet, states, jax.random.PRNGKey(sims + par),
                            num_simulations=sims, num_parallel=par, pass_min_stones=pass_min_stones)
    assert (tres.root_visits.sum(1) == sims).all()
    assert len(set(tres.actions.tolist())) > 3


def test_warm_root_and_warm_subtree_match_jax():
    """A search, the played child's statistics and its compacted subtree
    carried to the next ply (from JAX's tree), and both warm searches."""
    apply_fn, params, tnet = _nets(N, seed=22)
    states = _search_boards(N)
    jres, jtree, _ = _search(params, apply_fn, tnet, states, jax.random.PRNGKey(1), num_simulations=12)
    acts = jres.actions
    ttree, tacts = _to_torch(jtree), torch.from_numpy(np.array(acts))
    jstats = jmcts.played_child_stats(jtree, acts)
    tstats = tmcts.played_child_stats(ttree, tacts)
    for g, w in zip(tstats, jstats):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (tstats[0].sum(1) > 0).any()
    compact = jax.jit(jmcts.compact_subtree, static_argnums=2)
    for cap in (12, 5, 2):
        jsub = compact(jtree, acts, cap)
        tsub = tmcts.compact_subtree(ttree, tacts, cap)
        _assert_equal(tsub, jsub, f"compact cap {cap}")
        assert (tsub.parent.numpy()[:, 0] == -1).all()
    assert (jsub.child.max() >= 1)  # something deeper than the new root was kept
    nxt, _ = jax.jit(jstep.step_states)(jnp.asarray(states), acts)
    nxt = np.asarray(nxt)
    _search(params, apply_fn, tnet, nxt, jax.random.PRNGKey(2), num_simulations=12, warm_root=jstats)
    _search(params, apply_fn, tnet, nxt, jax.random.PRNGKey(3), num_simulations=8, num_parallel=4,
            warm_tree=compact(jtree, acts, 8))


def _mcts_noise_rows(key, steps, b, a):
    rows = [mcts_noise(k, b, a) for k in step_keys(key, steps)]
    return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])


@pytest.mark.parametrize("reuse,par", [(False, 1), ("root", 2), ("subtree", 1)])
def test_selfplay_mcts_rollout_matches_jax(reuse, par):
    apply_fn, params, tnet = _nets(N, seed=23)
    b, steps = 6, 4
    cfg_t = EnvConfig(board_size=N, batch_size=b, auto_reset=True)
    starts = rollout(torch.Generator().manual_seed(4), batch_init_state(b, N, device="cpu"), 20, cfg_t).final_states
    starts = starts.numpy()
    key = jax.random.PRNGKey(9)
    jcfg = JEnvConfig(board_size=N, batch_size=b, auto_reset=True)
    jfinal, jb = jax.jit(lambda k, s: jselfplay.selfplay_mcts_rollout(
        k, s, params, apply_fn, steps, jcfg, num_simulations=8, tree_reuse=reuse, reuse_cap=6,
        num_parallel=par))(key, jnp.asarray(starts))
    dirichlet, gumbel = _mcts_noise_rows(key, steps, b, N * N + 1)
    tfinal, tb = tselfplay.selfplay_mcts_rollout(
        None, torch.from_numpy(starts), tnet, steps, cfg_t, num_simulations=8, tree_reuse=reuse, reuse_cap=6,
        num_parallel=par, dirichlet=dirichlet, gumbel=gumbel)
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for name in ("obs", "mask", "mover_white", "done", "grounded", "value_target"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(tb.policy_target.numpy(), np.asarray(jb.policy_target), rtol=0, atol=FLOAT_ATOL)
    assert not tb.invalid.any()


def test_mcts_draws_its_own_noise():
    _, _, tnet = _nets(N, seed=24)
    states = torch.from_numpy(_search_boards(N))
    run = lambda seed: tmcts.run_mcts(torch.Generator().manual_seed(seed), states, tnet, num_simulations=16)
    r1, r2 = run(1), run(1)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    np.testing.assert_allclose(r1.visit_policy.sum(1).numpy(), 1.0, rtol=1e-6)
    assert not torch.equal(r1.root_visits, run(2).root_visits)
    d = tmcts.dirichlet_noise(torch.Generator().manual_seed(0), 0.3, (64, 26), "cpu")
    np.testing.assert_allclose(d.sum(1).numpy(), 1.0, rtol=1e-5)
    assert (d >= 0).all() and abs(float(d.mean()) - 1 / 26) < 1e-6
    policy = tmcts.make_mcts_policy(tnet, num_simulations=4)
    assert policy(torch.Generator().manual_seed(0), states).shape == (len(states),)
