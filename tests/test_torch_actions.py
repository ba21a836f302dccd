"""gymgo_tpu_torch.core.actions (and the liberty and winner queries of
core.score) against the JAX package's.

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
from gymgo_tpu.core import score as jscore
from gymgo_tpu.core import step as jstep
from gymgo_tpu_torch.core import actions as tactions
from gymgo_tpu_torch.core import score as tscore
from torch_boards import crafted_state, midgame_states


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
    k = tactions.scale_words(tactions.draw_words(g, num_valid.shape, num_valid.device), num_valid)
    assert (k >= 0).all() and (k <= num_valid).all()
    assert (k == num_valid).any() and (k[num_valid == 361] < 361).any()


def test_uniform_draws_agree_on_states_planes_and_words():
    """The three forms of the uniform sampler draw the same actions from one
    generator state: on the states, on the planes state, and from the words."""
    from gymgo_tpu_torch.core import step as tstep

    states = torch.from_numpy(np.concatenate([midgame_states(9, 16, 20, 6), midgame_states(9, 16, 90, 7)]))
    ps = tstep.planes_from_states(states)
    on_states = tactions.uniform_random_actions(torch.Generator().manual_seed(3), states)
    on_planes = tactions.uniform_random_actions_planes(torch.Generator().manual_seed(3), ps)
    words = tactions.draw_words(torch.Generator().manual_seed(3), (32,), "cpu")
    from_words = tactions.uniform_from_words(words, ~ps.invd.reshape(32, -1))
    assert torch.equal(on_states, on_planes) and torch.equal(on_states, from_words)


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


@pytest.mark.parametrize("min_stones", [0, 4, 1 << 20])
def test_mask_early_pass_matches_jax(min_stones):
    n = 5
    states = np.concatenate([midgame_states(n, 16, 3, 0), midgame_states(n, 16, 40, 1)])
    states[-1, 3] = 1  # no legal board move: pass stays allowed
    for as_bool in (True, False):
        valid = np.asarray(jactions.batch_valid_moves(jnp.asarray(states)))
        valid = valid > 0 if as_bool else valid
        want = np.asarray(jactions.mask_early_pass(jnp.asarray(valid), jnp.asarray(states), min_stones))
        t_valid = torch.from_numpy(valid)
        got = tactions.mask_early_pass(t_valid, torch.from_numpy(states), min_stones)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(t_valid.numpy(), valid)  # the input is left as it was
    if min_stones:
        assert not want[:, -1].all() and want[-1, -1]


@pytest.mark.parametrize("canonical", [False, True])
def test_children_matches_jax(canonical):
    n = 5
    states = np.concatenate([midgame_states(n, 3, 12, 2), midgame_states(n, 1, 7, 3)])
    ended = crafted_state(n, black=[(0, 0), (2, 2)], white=[(4, 4)], white_to_move=True,
                          prev_passed=True, done=True)
    jchildren = jax.jit(lambda s: jactions.children(s, canonical=canonical))
    for s in list(states) + [ended]:
        want = np.asarray(jchildren(jnp.asarray(s)))
        got = tactions.children(torch.from_numpy(s), canonical=canonical)
        assert got.dtype == torch.int8 and got.shape == (n * n + 1, 6, n, n)
        np.testing.assert_array_equal(got.numpy(), want)
    # once the game is done every row is valid and holds the unchanged state
    assert (want.reshape(n * n + 1, -1).any(1)).all()


def test_weighted_random_actions_matches_jax_given_the_noise():
    rng = np.random.default_rng(0)
    b, a = 64, 26
    weights = rng.random((b, a)).astype(np.float32) * (rng.random((b, a)) < 0.4)
    weights[:, -1] = np.maximum(weights[:, -1], 1e-3)  # pass is always drawable
    weights[0, :-1] = 0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jactions.weighted_random_actions(key, jnp.asarray(weights)))
    # jax.random.categorical is the argmax of logits + gumbel(key, shape)
    noise = np.asarray(jax.random.gumbel(key, (b, a)))
    got = tactions.weighted_random_actions(None, torch.from_numpy(weights), gumbel=torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == a - 1
    # the port's own draw: only moves with weight, and in proportion
    g = torch.Generator().manual_seed(1)
    w = torch.tensor([[0.0, 1.0, 3.0, 0.0]]).expand(40_000, 4)
    drawn = np.bincount(tactions.weighted_random_actions(g, w).numpy(), minlength=4)
    assert drawn[0] == 0 and drawn[3] == 0
    assert stats.chisquare(drawn[1:3], drawn.sum() * np.array([0.25, 0.75])).pvalue > 1e-3, drawn


def test_gumbel_noise_is_gumbel():
    g = torch.Generator().manual_seed(2)
    x = tactions.gumbel_noise(g, (50_000,), "cpu").numpy()
    assert x.dtype == np.float32 and np.isfinite(x).all()
    assert stats.kstest(x, "gumbel_r").pvalue > 1e-3


@pytest.mark.parametrize("n", [5, 9])
def test_liberties_and_winning_match_jax(n):
    states = np.concatenate([midgame_states(n, 24, n * n // 2, 4), midgame_states(n, 24, 2 * n * n, 5)])
    js, ts = jnp.asarray(states), torch.from_numpy(states)
    for jf, tf in ((jscore.liberties, tscore.liberties), (jscore.num_liberties, tscore.num_liberties),
                   (jscore.areas, tscore.areas)):
        for j, t in zip(jf(js), tf(ts)):
            assert np.asarray(j).dtype == t.numpy().dtype
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for komi in (0.0, 2.5):
        want = np.asarray(jscore.winning(js, komi))
        np.testing.assert_array_equal(tscore.winning(ts, komi).numpy(), want)
        np.testing.assert_array_equal(
            tscore.winning_planes(ts[:, 0].bool(), ts[:, 1].bool(), komi).numpy(),
            np.asarray(jscore.winning_planes(js[:, 0] != 0, js[:, 1] != 0, komi)))
    assert {-1.0, 1.0} <= set(want.tolist())
