"""The Gumbel search's packed tree layouts against the JAX package's.

``GYMGO_GUMBEL_PACK`` (``gymgo_tpu_torch.rl.gumbel_mcts.set_gumbel_pack``
against ``gymgo_tpu.rl.gumbel_mcts._VISIT_DT`` / ``_WSUM_DT`` / ``_USE_LOGP``,
patched with ``monkeypatch`` between two ``jax.clear_caches()``, since JAX reads
them while it traces).  Both packages get the same float32 net, boards and
Gumbel noise, as in ``test_torch_search``.

Rule, for every layout: ``test_torch_search``'s for the default one:
actions, root visits and candidates equal, the improved policy and the root
value within atol 1e-5.  ``bf16`` needs no looser rule on these inputs: both
packages round the same float32 sums to bfloat16, and no sum here lies within
the nets' float32 difference (below 1e-6) of a rounding boundary.  A batch
where one does could flip one visit; that would be a near-tie, not a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import actions as jactions
from gymgo_tpu.rl import gumbel_mcts as jgumbel
from gymgo_tpu_torch.rl import gumbel_mcts as tgumbel
from test_torch_search import FLOAT_ATOL, _nets, _search_boards

LAYOUTS = [("i16",), ("logp",), ("bf16",), ("i16", "logp"), ("i16", "logp", "bf16")]
N, SIMS, M = 5, 16, 8


@pytest.fixture(scope="module")
def problem():
    apply_fn, params, tnet = _nets(N, seed=N)
    states = _search_boards(N)
    key = jax.random.PRNGKey(SIMS)
    noise = np.array(jax.random.gumbel(key, (len(states), N * N + 1)))  # gumbel_mcts.py: g = gumbel(key, (b, a))
    return apply_fn, params, tnet, states, key, noise


def _run_both(problem, layout, monkeypatch):
    apply_fn, params, tnet, states, key, noise = problem
    jax.clear_caches()
    monkeypatch.setattr(jgumbel, "_VISIT_DT", jnp.int16 if "i16" in layout else jnp.int32)
    monkeypatch.setattr(jgumbel, "_WSUM_DT", jnp.bfloat16 if "bf16" in layout else jnp.float32)
    monkeypatch.setattr(jgumbel, "_USE_LOGP", "logp" in layout)
    previous = tgumbel.set_gumbel_pack(layout)
    try:
        jres = jax.jit(lambda k, s: jgumbel.run_gumbel_mcts(
            k, s, params, apply_fn, num_simulations=SIMS, max_considered=M, komi=0.5))(key, jnp.asarray(states))
        jres = jax.tree_util.tree_map(np.asarray, jres)
        tres = tgumbel.run_gumbel_mcts(None, torch.from_numpy(states), tnet, num_simulations=SIMS,
                                       max_considered=M, komi=0.5, gumbel=torch.from_numpy(noise))
    finally:
        tgumbel.set_gumbel_pack(previous)
        monkeypatch.undo()
        jax.clear_caches()
    return jres, tres


@pytest.mark.parametrize("layout", LAYOUTS, ids=",".join)
def test_packed_layout_matches_jax_given_the_noise(layout, problem, monkeypatch):
    jres, tres = _run_both(problem, layout, monkeypatch)
    states = problem[3]
    for got, want in zip(tres, jres):
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(tres.actions.numpy(), jres.actions)
    np.testing.assert_array_equal(tres.root_visits.numpy(), jres.root_visits)
    np.testing.assert_array_equal(tres.sampled_actions.numpy(), jres.sampled_actions)
    np.testing.assert_allclose(tres.improved_policy.numpy(), jres.improved_policy, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(tres.root_value.numpy(), jres.root_value, rtol=0, atol=FLOAT_ATOL)
    # a search all the same: every env spends its budget on legal root actions
    visits = tres.root_visits.numpy()
    valid_root = np.asarray(jactions.batch_valid_moves(jnp.asarray(states))) > 0
    assert (visits.sum(1) == SIMS).all() and (visits[~valid_root] == 0).all()
    np.testing.assert_allclose(tres.improved_policy.numpy().sum(1), 1.0, rtol=1e-5)


def test_set_gumbel_pack_restores_and_rejects_unknown_tokens():
    start = tgumbel.pack
    assert tgumbel.set_gumbel_pack(["i16", "logp"]) == start
    assert tgumbel.set_gumbel_pack(("bf16",)) == frozenset({"i16", "logp"})
    with pytest.raises(ValueError, match="unknown GYMGO_GUMBEL_PACK"):
        tgumbel.set_gumbel_pack(("f8",))
    assert tgumbel.pack == frozenset({"bf16"})
    tgumbel.set_gumbel_pack(start)
    assert tgumbel.pack == start
