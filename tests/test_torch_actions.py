"""gymgo_tpu_torch.core.actions against gymgo_tpu.core.actions.

The two packages draw different random numbers, so the rank-select is held to
JAX given JAX's own draw ``k``, and the port's draw is held to the uniform
distribution by a chi-square test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gymgo_tpu.core import actions as jactions
from gymgo_tpu.core import step as jstep
from gymgo_tpu_torch.core import actions as tactions


@pytest.mark.parametrize("m", [25, 81, 361, 30, 50])  # square (two-level) and not (flat)
def test_rank_select_matches_jax_given_k(m):
    rng = np.random.default_rng(m)
    b = 256
    dens = np.linspace(0.0, 1.0, b)[:, None]
    valid = rng.random((b, m)) < dens
    valid[0] = False  # no board move: pass only
    valid[-1] = True
    key = jax.random.PRNGKey(m)
    j_actions = np.asarray(jactions._kth_valid_actions(key, jnp.asarray(valid)))
    # the draw _kth_valid_actions makes (actions.py:120)
    k = np.asarray(jax.random.randint(key, (b,), 0, jnp.asarray(valid.sum(1), jnp.int32) + 1))
    t_actions = tactions.kth_valid_actions(torch.from_numpy(valid), torch.from_numpy(np.array(k)))
    assert t_actions.dtype == torch.int32
    np.testing.assert_array_equal(j_actions, t_actions.numpy())
    assert (j_actions == m).any() and (j_actions < m).any()


def test_rank_select_every_rank():
    """Every k in [0, num_valid] picks the k-th valid move, or pass."""
    rng = np.random.default_rng(0)
    for m in (9, 12):
        valid = rng.random(m) < 0.6
        ks = np.arange(valid.sum() + 1)
        vb = torch.from_numpy(np.broadcast_to(valid, (len(ks), m)).copy())
        got = tactions.kth_valid_actions(vb, torch.from_numpy(ks)).numpy()
        np.testing.assert_array_equal(got, np.append(np.flatnonzero(valid), m))


def test_generator_draw_is_uniform():
    valid = np.zeros((1, 3, 3), bool)
    valid[0, [0, 1, 2, 2], [1, 0, 0, 2]] = True  # 4 valid board moves + pass
    b = 50_000
    states = np.zeros((b, 6, 3, 3), np.int8)
    states[:, 3] = ~valid
    g = torch.Generator().manual_seed(123)
    acts = tactions.uniform_random_actions(g, torch.from_numpy(states)).numpy()
    outcomes = np.append(np.flatnonzero(valid[0].reshape(-1)), 9)
    assert set(np.unique(acts)) == set(outcomes)
    counts = np.array([(acts == o).sum() for o in outcomes])
    assert stats.chisquare(counts).pvalue > 1e-3, counts


def test_draw_k_stays_in_range():
    g = torch.Generator().manual_seed(5)
    num_valid = torch.tensor([0, 1, 2, 361] * 1000, dtype=torch.int32)
    k = tactions.draw_k(g, num_valid)
    assert (k >= 0).all() and (k <= num_valid).all()
    assert (k == num_valid).any() and (k[num_valid == 361] < 361).any()


def test_batch_valid_moves_matches_jax():
    rng = np.random.default_rng(3)
    n, b = 7, 32
    states = np.zeros((b, 6, n, n), np.int8)
    step = jax.jit(jstep.step_states)
    for _ in range(30):
        acts = jactions.uniform_random_actions(jax.random.PRNGKey(int(rng.integers(1 << 30))), jnp.asarray(states))
        states = np.asarray(step(jnp.asarray(states), acts)[0])
    for jf, tf in ((jactions.batch_valid_moves, tactions.batch_valid_moves),
                   (jactions.batch_invalid_moves, tactions.batch_invalid_moves)):
        j = np.asarray(jf(jnp.asarray(states)))
        t = tf(torch.from_numpy(states))
        assert t.dtype == torch.float32 and t.shape == (b, n * n + 1)
        np.testing.assert_array_equal(j, t.numpy())
    assert (tactions.batch_invalid_moves(torch.from_numpy(states))[:, -1] == 0).all()
