"""gymgo_tpu_torch.env.GoEnv against gymgo_tpu.env.GoEnv(backend="jax"): the
scenario scripts of tests/test_basics.py, test_valid_moves.py and
test_invalid_moves.py (their action lists copied here) replayed through the
JAX env and through the port's torch (CPU) and native backends, every step's
4-tuple equal, and every move the JAX env refuses refused by the port too."""

import warnings

import numpy as np
import pytest
import torch

from gymgo_tpu.env import GoEnv as JGoEnv
from gymgo_tpu_torch import gogame as tgogame
from gymgo_tpu_torch import govars as tgovars
from gymgo_tpu_torch.env import GoEnv, GoExtraHardEnv, RewardMethod

RESET = "reset"
SCENARIOS = {
    # tests/test_basics.py
    "reset": (7, 0, "real", [(0, 0), RESET]),
    "turns": (7, 0, "real", [(i, 0) for i in range(7)]),
    "passing": (7, 0, "real", [None, (0, 0), RESET, (0, 0), None]),
    "game_ends": (7, 0, "real", [None, None, RESET, (0, 0), None, None]),
    "disjoint_passes": (7, 0, "real", [None, (0, 0), None]),
    "num_liberties": (7, 0, "real", [(0, 0), (0, 1), RESET, (2, 1), None, (1, 2), None, (2, 3), None, (3, 2), None]),
    "action_formats": (7, 0, "real", [30, RESET, (4, 2), RESET, 49, RESET, None, RESET, np.array([2, 2])]),
    "komi": (7, 2.5, "real", [None, None, RESET, 0, 2, 1, None, None, RESET, 0, None, 1, None, 2, None, None]),
    "real_reward": (7, 0, "real", [(0, 0), None, None, RESET, None, (0, 0), None, None, RESET, None, None]),
    "heuristic_reward": (7, 0, "heuristic",
                         [(0, 0), (0, 1), None, (1, 0), None, None, RESET, (0, 0), None, None]),
    # tests/test_valid_moves.py
    "simple_valid": (7, 0, "real", [(0, i) for i in range(7)] + [RESET] + [(i, i) for i in range(7)] + [RESET]
                     + [(i, 0) for i in range(7)]),
    "valid_no_liberty_move": (7, 0, "real", [(0, 1), (0, 2), (1, 0), (1, 3), (2, 1), (2, 2), (1, 2), (1, 1)]),
    "valid_no_liberty_capture": (7, 0, "real", [(0, 0), (0, 2), (0, 3), (1, 1), (1, 2), (1, 0), (0, 1)]),
    "simple_capture": (7, 0, "real", [(0, 1), (1, 1), (1, 0), None, (1, 2), None, (2, 1)]),
    "large_group_capture": (7, 0, "heuristic",
                            [(2, 2), (1, 2), (2, 3), (1, 3), (2, 4), (1, 4), (3, 4), (2, 5), (3, 3), (3, 5), (3, 2),
                             (4, 4), None, (4, 3), None, (4, 2), None, (3, 1), None, (2, 1)]),
    "large_group_suicide": (7, 0, "real", [(4, 0), (6, 0), (4, 1), (5, 0), (5, 2), (5, 1), (6, 2), (6, 1)]),
    "group_edge_capture": (7, 0, "real", [(0, 0), (0, 2), (0, 1), (1, 2), (1, 1), (2, 1), (1, 0), (2, 0)]),
    "group_kill_no_ko": (7, 0, "heuristic", [(0, 5), (0, 4), (1, 5), (1, 4), (2, 5), (2, 4), (2, 6), (3, 5), None,
                                             (3, 6), None, (1, 6), (0, 6), (1, 6)]),
    # tests/test_invalid_moves.py
    "out_of_bounds": (7, 0, "real", [(-1, 0), (0, 100), (3, 3)]),
    "occupied": (7, 0, "real", [(3, 4), (3, 4), RESET, (0, 6), (0, 6), RESET, (6, 0), (6, 0)]),
    "ko_protection": (7, 0, "real", [(0, 1), (0, 2), (1, 0), (1, 3), (2, 1), (2, 2), (1, 2), (1, 1), (1, 2), (6, 6),
                                     None]),
    "ko_wall_protection": (7, 0, "real", [(1, 0), (0, 0), None, (1, 1), None, (0, 2), (0, 1), (0, 0), (6, 6), None]),
    "invalid_no_liberty": (7, 0, "real", [(0, 1), (0, 2), (1, 0), (1, 4), (2, 1), (2, 2), (1, 2), (1, 1)]),
    "game_already_over": (7, 0, "real", [None, None, None, RESET, None, None, (0, 0)]),
    "small_suicide": (3, 0, "real", [6, 7, 8, 5, 4, 8, 0, 1, 3]),
    "invalid_after_capture": (3, 0, "heuristic", [0, 8, 6, 4, 1, 2, 3, 7, 5]),
    "multiple_holes": (7, 0, "real", [(1, 1), (0, 1), (1, 2), (0, 2), (1, 3), (0, 3), (1, 4), (0, 4), (1, 5), (0, 5),
                                      (2, 5), (1, 6), (3, 5), (2, 6), (3, 4), (3, 6), (3, 3), (4, 5), (2, 3), (4, 4),
                                      (3, 2), (4, 3), (3, 1), (4, 2), (2, 1), (4, 1), None, (3, 0), None, (2, 0), None,
                                      (1, 0), None, (2, 2)]),
}


def _envs(size, komi=0, reward="real"):
    return (JGoEnv(size, komi, reward, backend="jax"), GoEnv(size, komi, reward, backend="torch", device="cpu"),
            GoEnv(size, komi, reward, backend="native"))


def _outcome(env, action):
    try:
        return env.step(action)
    except (AssertionError, IndexError, ValueError) as e:
        return type(e)


def _assert_same_step(got, want, what):
    if isinstance(want, type):
        assert got is want, (what, got, want)
        return
    (obs, reward, done, info), (w_obs, w_reward, w_done, w_info) = got, want
    assert obs.dtype == w_obs.dtype and np.array_equal(obs, w_obs), what
    assert type(reward) is type(w_reward) and reward == w_reward, (what, reward, w_reward)
    assert type(done) is type(w_done) and done == w_done, what
    assert set(info) == set(w_info) == {"turn", "invalid_moves", "prev_player_passed"}, what
    assert info["turn"] == w_info["turn"] and info["prev_player_passed"] == w_info["prev_player_passed"], what
    assert np.array_equal(info["invalid_moves"], w_info["invalid_moves"]), what


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    size, komi, reward, actions = SCENARIOS[name]
    jenv, *ports = _envs(size, komi, reward)
    for t, action in enumerate(actions):
        if isinstance(action, str):
            want = jenv.reset()
            for env in ports:
                got = env.reset()
                assert got.dtype == want.dtype and np.array_equal(got, want)
            continue
        want = _outcome(jenv, action)
        for env in ports:
            _assert_same_step(_outcome(env, action), want, f"{name} {env.backend} move {t} {action}")
            assert np.array_equal(env.state(), jenv.state())
            assert env.game_ended() == jenv.game_ended() and env.winner() == jenv.winner()
            assert env.gogame.num_liberties(env.state(), device="cpu") == jenv.gogame.num_liberties(jenv.state())


def test_refused_moves_are_refused_everywhere():
    """The invalid-move scenarios end in a move every backend refuses."""
    for name in ("large_group_suicide", "ko_protection", "ko_wall_protection", "invalid_no_liberty",
                 "game_already_over", "small_suicide", "invalid_after_capture", "multiple_holes", "out_of_bounds",
                 "occupied"):
        size, komi, reward, actions = SCENARIOS[name]
        for env in _envs(size, komi, reward):
            outcomes = [env.reset() if isinstance(a, str) else _outcome(env, a) for a in actions]
            assert any(o is AssertionError for o in outcomes), (name, env)


def test_heuristic_tie_scores_minus_size_squared():
    for env in _envs(7, 0, "heuristic"):
        assert env.step(None)[1] == 0
        _, reward, done, _ = env.step(None)
        assert done and reward == -49
    for env in _envs(5, 0.5, "heuristic"):  # komi breaks the tie for white
        env.step(None)
        assert env.step(None)[1] == -25


@pytest.mark.parametrize("size", [5, 7, 9, 19])
def test_random_game_children_and_canonical_match(size):
    jenv, torch_env, native_env = _envs(size, 0, "heuristic")
    np.random.seed(size)
    for t in range(60 if size < 19 else 30):
        a = jenv.uniform_random_action()
        want = jenv.step(a)
        for env in (torch_env, native_env):
            _assert_same_step(env.step(a), want, f"{env.backend} move {t}")
        if want[2]:
            break
    for canonical in (False, True):
        for padded in (True, False):
            want = jenv.children(canonical, padded)
            for env in (torch_env, native_env):
                got = env.children(canonical, padded)
                assert got.dtype == want.dtype and np.array_equal(got, want), (env.backend, canonical, padded)
    for env in (torch_env, native_env):
        assert np.array_equal(env.canonical_state(), jenv.canonical_state())
        assert str(env) == str(jenv)
        assert env.winning() == jenv.winning() and env.turn() == jenv.turn()
        assert env.prev_player_passed() == jenv.prev_player_passed()
        assert np.array_equal(env.valid_moves(), jenv.valid_moves())


def test_uniform_random_action_and_render_match(capsys):
    jenv, torch_env, native_env = _envs(5)
    for env in (jenv, torch_env, native_env):
        env.step(3)
        np.random.seed(7)
        env.draw = [env.uniform_random_action() for _ in range(10)]
        env.render("terminal")
    out = capsys.readouterr().out.split("\n\n")
    assert out[0] == out[1] == out[2] and "Turn: WHITE" in out[0]
    assert jenv.draw == torch_env.draw == native_env.draw
    for env in (jenv, torch_env):
        with pytest.raises(ImportError):  # pyglet is absent here
            env.render("human")
        with pytest.raises(ValueError):
            env.render("rgb")


def test_surface():
    env = GoEnv(9, backend="torch", device="cpu")
    assert env.observation_space.shape == (tgovars.NUM_CHNLS, 9, 9) and env.action_space.n == 82
    assert GoEnv.gogame is tgogame and GoEnv.govars is tgovars
    assert env.reward_method is RewardMethod.REAL and env.device == torch.device("cpu")
    assert GoExtraHardEnv.metadata["render.modes"] == ["human", "terminal"]
    env.step(np.array([2, 2]))
    assert env.state()[tgovars.BLACK, 2, 2] == 1
    # the fused areas serve the reward only while state_ is the state they came from
    assert env._fused_areas[0] is env.state_
    env.reset()
    assert env._areas() == (0.0, 0.0)


def test_backends():
    with pytest.raises(ValueError, match="jax"):
        GoEnv(5, backend="jax")
    with pytest.raises(ValueError):
        GoEnv(5, backend="numpy")
    auto = GoEnv(5)
    assert auto.backend == "native" and auto.device is None  # g++ is here
    assert GoEnv(5, backend="torch", device="cpu").backend == "torch"
    with pytest.raises(ValueError):
        GoEnv(33, backend="native")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GoEnv(5, backend="torch")


def test_gymnasium_make():
    import gymnasium

    import gymgo_tpu  # noqa: F401 - both packages' ids live in one registry

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        env = gymnasium.make("go-torch-v0", size=7, komi=1.5, backend="torch", device="cpu")
        obs = env.reset(seed=0)
        state, reward, done, info = env.step((0, 0))
        native = gymnasium.make("go-torch-v0", size=7)
        jax_env = gymnasium.make("go-v0", size=7)
    assert obs.shape == state.shape == (6, 7, 7) and state[0, 0, 0] == 1
    assert env.unwrapped.komi == 1.5 and env.unwrapped.backend == "torch"
    assert isinstance(native.unwrapped, GoEnv) and native.unwrapped.backend == "native"
    assert isinstance(jax_env.unwrapped, JGoEnv)
    assert gymnasium.registry["go-torch-v0"].entry_point == "gymgo_tpu_torch.env:GoEnv"
    assert gymnasium.registry["go-v0"].entry_point == "gymgo_tpu.env:GoEnv"
    assert gymnasium.registry["go-extrahard-torch-v0"].entry_point == "gymgo_tpu_torch.env:GoExtraHardEnv"
