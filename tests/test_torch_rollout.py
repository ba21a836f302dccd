"""gymgo_tpu_torch.env.batch_env and core.score against the JAX package.

A JAX rollout's actions are replayed through the port's ``rollout`` by a
``policy_fn`` that yields them; rewards, dones, collected observations and
final states must agree bit for bit (rewards are small-integer sums minus
komi, so exact in float32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core import score as jscore
from gymgo_tpu.env import batch_env as jenv
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import score as tscore
from gymgo_tpu_torch.env import batch_env as tenv


def _configs(n, b, reward, komi=0.0):
    kw = dict(board_size=n, batch_size=b, reward_method=reward, auto_reset=True, komi=komi)
    return JEnvConfig(**kw), EnvConfig(**kw)


def _jax_rollout(cfg, key, states, steps):
    fn = jax.jit(functools.partial(jenv.rollout, config=cfg, collect_obs=True), static_argnums=(2,))
    return fn(key, states, steps)


def _played_states(n, b, steps, seed):
    """int8 states after ``steps`` uniform-random JAX moves with auto-reset."""
    jcfg, _ = _configs(n, b, "real")
    r = _jax_rollout(jcfg, jax.random.PRNGKey(seed), jnp.zeros((b, 6, n, n), jnp.int8), steps)
    return np.asarray(r.final_states)


def _replay(actions):
    it = iter(torch.from_numpy(np.array(actions)))
    return lambda generator, states: next(it)


@pytest.mark.parametrize("n,b,opening,steps,komi", [(7, 32, 0, 240, 0.5), (19, 8, 500, 160, 7.5)])
@pytest.mark.parametrize("reward", ["heuristic", "real"])
def test_rollout_replay_matches_jax(n, b, opening, steps, komi, reward):
    jcfg, tcfg = _configs(n, b, reward, komi)
    start = _played_states(n, b, opening, seed=1) if opening else np.zeros((b, 6, n, n), np.int8)
    r = _jax_rollout(jcfg, jax.random.PRNGKey(n), jnp.asarray(start), steps)
    dones = np.asarray(r.dones)
    assert dones.any(), "the window should end and auto-reset some games"
    t = tenv.rollout(torch.Generator().manual_seed(0), torch.from_numpy(start.copy()), steps,
                     tcfg, policy_fn=_replay(r.actions), collect_obs=True)
    np.testing.assert_array_equal(np.asarray(r.actions), t.actions.numpy())
    assert t.rewards.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(r.rewards), t.rewards.numpy())
    np.testing.assert_array_equal(dones, t.dones.numpy())
    np.testing.assert_array_equal(np.asarray(r.obs), t.obs.numpy())
    np.testing.assert_array_equal(np.asarray(r.final_states), t.final_states.numpy())
    assert not t.invalid.any()


def test_default_sampler_rollout_plays_legal_games():
    _, tcfg = _configs(7, 64, "heuristic")
    g = torch.Generator().manual_seed(0)
    r = tenv.rollout(g, torch.zeros((64, 6, 7, 7), dtype=torch.int8), 200, tcfg)
    assert r.actions.shape == (200, 64) and r.final_states.dtype == torch.int8
    assert r.dones.any() and not r.invalid.any()
    # the same generator seed gives the same rollout
    r2 = tenv.rollout(torch.Generator().manual_seed(0), torch.zeros((64, 6, 7, 7), dtype=torch.int8), 200, tcfg)
    assert torch.equal(r.actions, r2.actions) and torch.equal(r.final_states, r2.final_states)


@pytest.mark.parametrize("reward", ["heuristic", "real"])
def test_batch_step_auto_reset_matches_jax(reward):
    n, b = 7, 32
    jcfg, tcfg = _configs(n, b, reward, komi=0.5)
    states = _played_states(n, b, 150, seed=2)
    assert states[:, 5, 0, 0].any(), "some envs should start done, to be reset"
    rng = np.random.default_rng(0)
    jstep = jax.jit(functools.partial(jenv.batch_step, config=jcfg))
    for _ in range(30):
        acts = rng.integers(0, n * n + 1, b).astype(np.int32)
        jnew, jres = jstep(jnp.asarray(states), jnp.asarray(acts))
        tnew, tres = tenv.batch_step(torch.from_numpy(states.copy()), torch.from_numpy(acts), tcfg)
        for name in jres._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jres, name)), getattr(tres, name).numpy(), err_msg=name)
        states = np.asarray(jnew)


def test_areas_and_winning_match_jax():
    states = np.concatenate([_played_states(9, 32, 120, seed=3), _played_states(9, 32, 120, seed=4)])
    jb, jw = jscore.areas(jnp.asarray(states))
    tb, tw = tscore.areas(torch.from_numpy(states))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    for komi in (0.0, 0.5, 7.5):
        j = np.asarray(jscore.winning(jnp.asarray(states), komi))
        t = tscore.winning(torch.from_numpy(states), komi)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("n", [5, 19])
def test_heuristic_tie_is_a_loss_of_n_squared(n):
    jcfg, tcfg = _configs(n, 3, "heuristic")
    ba = np.array([10, 10, 12], np.int32)
    wa = np.array([10, 11, 10], np.int32)
    done = np.array([True, True, False])
    j = np.asarray(jenv.reward_from_areas(jnp.asarray(ba), jnp.asarray(wa), jnp.asarray(done), jcfg))
    t = tenv.reward_from_areas(torch.from_numpy(ba), torch.from_numpy(wa), torch.from_numpy(done), tcfg)
    np.testing.assert_array_equal(j, t.numpy())
    assert t.tolist() == [-n * n, -n * n, 2.0]


def test_batch_go_env_on_cpu():
    _, tcfg = _configs(5, 16, "real")
    env = tenv.BatchGoEnv(tcfg, device="cpu")
    states = env.reset()
    assert states.shape == (16, 6, 5, 5) and states.dtype == torch.int8
    g = env.generator(0)
    states, res = env.step(states, env.uniform_random_actions(g, states))
    assert not res.invalid_action.any()
    r = env.rollout(g, states, 50)
    assert r.rewards.shape == (50, 16)
    assert env.valid_moves(r.final_states).shape == (16, 26)
    ba, wa = env.areas(r.final_states)
    expected = torch.sign(ba.float() - wa.float() - tcfg.komi)
    assert torch.equal(env.winning(r.final_states), expected)
