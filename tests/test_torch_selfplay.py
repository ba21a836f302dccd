"""gymgo_tpu_torch.rl.selfplay against gymgo_tpu.rl.selfplay.

Both packages get the same float32 net, the same start states and the same
noise: each step's Gumbel noise is drawn here from the key JAX's window hands
that step (``k, sub = split(k)``) and given to the port.  Integer and bool
outputs (actions, obs, masks, done, grounded, final states) and the value
targets (signs) must be equal; the policy targets within atol 5e-5
(softmaxes and the net's sums round differently in the two libraries, and
the Gumbel search scales q by c_visit + max N, about 50, before its softmax).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core import score as jscore
from gymgo_tpu.rl import selfplay as jselfplay
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.rl import selfplay as tselfplay
from test_torch_search import _nets
from torch_boards import midgame_states

FLOAT_ATOL = 5e-5
N, B, T = 5, 8, 5


def _starts():
    """Fresh, mid-game and finished games (some reset at the first step), and
    boards where the previous move was a pass, so windows end games."""
    s = np.concatenate([midgame_states(N, 4, 30, 1), midgame_states(N, 4, 60, 2)])
    s[1, 4] = 1  # the previous move was a pass: a pass now ends the game
    s[2] = 0  # an empty board
    return s


def step_keys(key, steps):
    keys = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def _gumbels(key, steps, b, a):
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (b, a))) for k in step_keys(key, steps)]))


def _assert_batch_equal(jb, tb, jfinal, tfinal):
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for name in ("obs", "mask", "mover_white", "done", "grounded", "value_target"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(tb.policy_target.numpy(), np.asarray(jb.policy_target), rtol=0, atol=FLOAT_ATOL)
    assert not tb.invalid.any()


@pytest.mark.parametrize("mode", ["gumbel", "search", "raw"])
def test_selfplay_rollouts_match_jax_given_the_noise(mode):
    apply_fn, params, tnet = _nets(N, seed=11)
    starts = _starts()
    key = jax.random.PRNGKey(7)
    jcfg, tcfg = (JEnvConfig(board_size=N, batch_size=B, komi=0.5, auto_reset=True),
                  EnvConfig(board_size=N, batch_size=B, komi=0.5, auto_reset=True))
    noise = _gumbels(key, T, B, N * N + 1)
    if mode == "gumbel":
        jfn = functools.partial(jselfplay.selfplay_gumbel_rollout, num_simulations=8, max_considered=4)
        tfn = functools.partial(tselfplay.selfplay_gumbel_rollout, num_simulations=8, max_considered=4)
    elif mode == "search":
        jfn = functools.partial(jselfplay.selfplay_search_rollout, num_sampled=6)
        tfn = functools.partial(tselfplay.selfplay_search_rollout, num_sampled=6)
    else:
        jfn = functools.partial(jselfplay.selfplay_rollout, temperature=0.7)
        tfn = functools.partial(tselfplay.selfplay_rollout, temperature=0.7)
    jfinal, jb = jax.jit(lambda k, s: jfn(k, s, params, apply_fn, T, jcfg, pass_min_stones=3))(key, starts)
    tfinal, tb = tfn(None, torch.from_numpy(starts), tnet, T, tcfg, pass_min_stones=3, gumbel=noise)
    _assert_batch_equal(jb, tb, jfinal, tfinal)
    assert int(tb.done.sum()) >= 1  # a game ended inside the window
    np.testing.assert_allclose(tb.policy_target.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert len(np.unique(tb.actions.numpy())) > 3


def test_value_bootstrap_from_a_frozen_target_matches_jax():
    apply_fn, params, tnet = _nets(N, seed=12)
    _, target_params, ttarget = _nets(N, seed=13)
    starts = _starts()
    key = jax.random.PRNGKey(3)
    jcfg = JEnvConfig(board_size=N, batch_size=B, auto_reset=True)
    noise = _gumbels(key, T, B, N * N + 1)
    jfinal, jb = jax.jit(lambda k, s: jselfplay.selfplay_search_rollout(
        k, s, params, apply_fn, T, jcfg, num_sampled=4, value_bootstrap=True,
        target_params=target_params))(key, starts)
    tfinal, tb = tselfplay.selfplay_search_rollout(
        None, torch.from_numpy(starts), tnet, T, EnvConfig(board_size=N, batch_size=B, auto_reset=True),
        num_sampled=4, value_bootstrap=True, target_net=ttarget, gumbel=noise)
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    np.testing.assert_array_equal(tb.grounded.numpy(), np.asarray(jb.grounded))
    # grounded rows hold exact outcomes, the tail the target net's value
    np.testing.assert_allclose(tb.value_target.numpy(), np.asarray(jb.value_target), rtol=0, atol=FLOAT_ATOL)
    tail = ~tb.grounded.numpy()
    assert tail.any() and not np.isin(tb.value_target.numpy()[tail], (-1.0, 0.0, 1.0)).all()


def _tables():
    """Hand-made (T, B) done / sign tables: several games per env, a game
    ending at the first and at the last step, an env that never ends."""
    done = np.zeros((7, 5), bool)
    done[[1, 4], 0] = True
    done[[0, 2, 3, 6], 1] = True
    done[6, 2] = True
    done[3, 4] = True
    sign = np.where(np.arange(35).reshape(7, 5) % 3 == 0, 1.0, -1.0).astype(np.float32)
    sign[2, 1] = 0.0  # a drawn game
    mover_white = (np.arange(7)[:, None] + np.arange(5)[None, :]) % 2 == 1
    return done, sign, mover_white


def test_per_game_value_targets_and_grounded_match_jax():
    done, sign, mover_white = _tables()
    z_final = np.array([1.0, -1.0, 0.0, 0.5, -0.25], np.float32)
    jz = jselfplay.per_game_value_targets(jnp.asarray(done), jnp.asarray(sign), None, jnp.asarray(mover_white),
                                          0.0, z_final=jnp.asarray(z_final))
    tz = tselfplay.per_game_value_targets(torch.from_numpy(done), torch.from_numpy(sign), None,
                                          torch.from_numpy(mover_white), 0.0, z_final=torch.from_numpy(z_final))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # env 0: steps 0-1 take step 1's sign, 2-4 step 4's, 5-6 the final estimate
    z_black = np.where(mover_white, -tz.numpy(), tz.numpy())
    np.testing.assert_array_equal(z_black[:, 0], [sign[1, 0]] * 2 + [sign[4, 0]] * 3 + [z_final[0]] * 2)
    jg = jnp.flip(jnp.cumsum(jnp.flip(jnp.asarray(done).astype(jnp.int32), 0), 0), 0) > 0
    np.testing.assert_array_equal(tselfplay.grounded_rows(torch.from_numpy(done)).numpy(), np.asarray(jg))

    # without z_final: the area sign of the final states (one area score)
    finals = midgame_states(N, 5, 20, 4)
    jz = jselfplay.per_game_value_targets(jnp.asarray(done), jnp.asarray(sign), jnp.asarray(finals),
                                          jnp.asarray(mover_white), 0.5)
    tz = tselfplay.per_game_value_targets(torch.from_numpy(done), torch.from_numpy(sign),
                                          torch.from_numpy(finals), torch.from_numpy(mover_white), 0.5)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tz.numpy()[6, 3] * (-1 if mover_white[6, 3] else 1),
                                  np.asarray(jscore.winning(jnp.asarray(finals), 0.5))[3])


@pytest.mark.parametrize("n", [5, 6])
def test_augment_symmetries_matches_jax_given_the_orientations(n):
    rng = np.random.default_rng(n)
    m = 40
    obs = rng.integers(0, 2, (m, 6, n, n)).astype(np.int8)
    policy = rng.random((m, n * n + 1)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    jo, jp = jselfplay.augment_symmetries(key, jnp.asarray(obs), jnp.asarray(policy))
    orientations = np.array(jax.random.randint(key, (m,), 0, 8))  # selfplay.py: randint(key, (m,), 0, 8)
    assert set(orientations.tolist()) == set(range(8))
    to, tp = tselfplay.augment_symmetries(None, torch.from_numpy(obs), torch.from_numpy(policy),
                                          orientations=torch.from_numpy(orientations))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # drawn from the generator: the pass entry stays, each row a permutation
    go, gp = tselfplay.augment_symmetries(torch.Generator().manual_seed(0), torch.from_numpy(obs),
                                          torch.from_numpy(policy))
    np.testing.assert_array_equal(gp[:, -1].numpy(), policy[:, -1])
    np.testing.assert_array_equal(np.sort(gp.numpy(), 1), np.sort(policy, 1))


def test_window_makes_no_invalid_moves_and_resets_finished_games():
    _, _, tnet = _nets(N, seed=5)
    cfg = EnvConfig(board_size=N, batch_size=B, auto_reset=True)
    final, b = tselfplay.selfplay_gumbel_rollout(torch.Generator().manual_seed(1), torch.from_numpy(_starts()),
                                                tnet, 12, cfg, num_simulations=4, max_considered=4)
    assert b.obs.shape == (12, B, 6, N, N) and b.policy_target.shape == (12, B, N * N + 1)
    assert not b.invalid.any() and b.mask.all()  # auto-reset: every pre-move state is live
    valid = b.obs[:, :, 3].reshape(12, B, -1) == 0
    assert (b.policy_target[..., :-1][~valid] == 0).all()
    assert final.shape == (B, 6, N, N)
