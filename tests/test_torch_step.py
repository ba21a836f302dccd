"""gymgo_tpu_torch.core.step against gymgo_tpu.core.step, bit for bit.

Random games at 5/7/9/19 with the same injected actions: legal moves, passes
(and so double-pass ends), moves into occupied, suicide or ko points and out of
range (frozen envs), and steps on finished envs.  Both the stateless path and
the carried ``atari``/``ko_surr`` path are compared, every field of the state
and of ``StepInfo``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import step as jstep
from gymgo_tpu_torch.convert import planes_to_torch
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from torch_boards import states_on_boards

_jit_step_states = jax.jit(jstep.step_states)
_jit_step_planes = jax.jit(jstep.step_planes)


def _random_actions(rng, states, legal_only=False):
    """Mostly legal moves, with passes, arbitrary cells and out-of-range ids."""
    b, n = states.shape[0], states.shape[-1]
    m = n * n
    valid = states[:, 3].reshape(b, m) == 0
    legal = np.array([rng.choice(np.flatnonzero(v)) if v.any() else m for v in valid])
    if legal_only:
        return legal.astype(np.int32)
    u = rng.random(b)
    acts = np.where(u < 0.08, m, legal)
    acts = np.where((u >= 0.08) & (u < 0.16), rng.integers(0, m, b), acts)
    acts = np.where(u >= 0.985, rng.choice([-1, m + 1, m + 7], b), acts)
    return acts.astype(np.int32)


def _assert_tuple_equal(jt, tt):
    for name in jt._fields:
        j, t = getattr(jt, name), getattr(tt, name)
        if j is None:
            assert t is None, name
            continue
        j = np.asarray(j)
        t = t.numpy()
        assert j.dtype == t.dtype, (name, j.dtype, t.dtype)
        np.testing.assert_array_equal(j, t, err_msg=name)


def _game_counts(info, before, after):
    """Coverage counters from JAX's outputs."""
    n = before.shape[-1]
    captured = np.asarray(info.num_captured)
    newly_empty = (before[:, :2].sum(1) > 0) & (after[:, :2].sum(1) == 0)
    single_capture_blocked = (captured == 1) & (
        (newly_empty & (after[:, 3] != 0)).reshape(len(captured), n * n).any(1)
    )
    return {
        "captures": int((captured > 0).sum()),
        "invalid": int(np.asarray(info.invalid_action).sum()),
        "was_done": int(np.asarray(info.was_done).sum()),
        "passes_ended": int((after[:, 5, 0, 0] > before[:, 5, 0, 0]).sum()),
        "single_capture_blocked": int(single_capture_blocked.sum()),
    }


@pytest.mark.parametrize("n,b,opening,steps", [(5, 32, 0, 100), (7, 32, 0, 100), (9, 32, 0, 80), (19, 8, 200, 70)])
def test_step_states_and_step_planes_match_jax(n, b, opening, steps):
    rng = np.random.default_rng(n)
    states = np.zeros((b, 6, n, n), np.int8)
    for _ in range(opening):  # legal moves only: a crowded 19x19 board
        states = np.asarray(_jit_step_states(jnp.asarray(states), jnp.asarray(_random_actions(rng, states, True)))[0])
    jps = jstep.planes_from_states(jnp.asarray(states))
    jps = jps._replace(atari=jstep.init_atari(jps), ko_surr=jstep.init_ko_surr(jps))
    tps = planes_to_torch(jps, "cpu")
    _assert_tuple_equal(jps, tps)
    totals = {}
    for _ in range(steps):
        acts = _random_actions(rng, states)
        # stateless path
        jnew, jinfo = _jit_step_states(jnp.asarray(states), jnp.asarray(acts))
        tnew, tinfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
        np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
        _assert_tuple_equal(jinfo, tinfo)
        # carried path, on its own trajectory of the same actions
        jps, jpinfo = _jit_step_planes(jps, jnp.asarray(acts))
        tps, tpinfo = tstep.step_planes(tps, torch.from_numpy(acts))
        _assert_tuple_equal(jps, tps)
        _assert_tuple_equal(jpinfo, tpinfo)
        new = np.asarray(jnew)
        for k, v in _game_counts(jinfo, states, new).items():
            totals[k] = totals.get(k, 0) + v
        states = new
    # the games covered what they are meant to cover
    for key in ("captures", "invalid", "was_done", "passes_ended"):
        assert totals[key] > 0, totals
    if n <= 7:
        assert totals["single_capture_blocked"] > 0, totals


@pytest.mark.parametrize("route", ["bundle", "minmax"])
@pytest.mark.parametrize("n", [5, 9, 19])
def test_stateless_step_on_hand_made_boards_matches_jax_by_flood_and_by_classes(n, route, monkeypatch):
    """Boards no game reaches, where groups stand without a liberty: JAX's
    stateless step removes them with the move.  So does the port, by its
    capture flood (what CPU tensors take) and by the liberty classes of the
    board before the move (what CUDA tensors take; called here on the CPU,
    where the classification is the kernel's plain version)."""
    states = states_on_boards(n, 11)
    m = n * n
    acts = _random_actions(np.random.default_rng(n), states)
    js, ji = _jit_step_states(jnp.asarray(states), jnp.asarray(acts))
    js = np.asarray(js)
    if route == "minmax":  # the size rule sends these boards to the minmax route
        monkeypatch.setattr(tflood, "bundle_fits", lambda _n: False)
    ts, ti = tstep.step_states(torch.from_numpy(states), torch.from_numpy(acts))
    black, white = torch.from_numpy(states[:, 0] != 0), torch.from_numpy(states[:, 1] != 0)
    wtm = torch.from_numpy(states[:, 2] != 0)
    killed = tstep._killed_by_classes(
        black, white, torch.where(wtm, black, white), torch.from_numpy(acts).long().clamp(0, m - 1))
    np.testing.assert_array_equal(js, ts.numpy())
    _assert_tuple_equal(ji, ti)
    moved = ~np.asarray(ji.invalid_action) & ~np.asarray(ji.was_done) & (acts != m)
    opp_before = np.where(states[:, 2] != 0, states[:, 0], states[:, 1]) != 0
    opp_after = np.where(states[:, 2] != 0, js[:, 0], js[:, 1]) != 0
    np.testing.assert_array_equal(killed.numpy()[moved], (opp_before & ~opp_after)[moved])
    no_liberty_before = killed.numpy()[acts == m].any()
    assert moved.sum() > 200 and int(np.asarray(ji.num_captured).sum()) > 0 and no_liberty_before


def _scripted_ko_game(n=5):
    """Black captures one white stone in a ko shape; white retakes at once
    (invalid), then plays elsewhere; the ko point opens again."""
    moves = [1, 2, 5, 6, 11, 12, 24, 8, 7, 6, 20, 23, 6]
    states = np.zeros((1, 6, n, n), np.int8)
    return states, [np.array([a], np.int32) for a in moves]


def test_scripted_ko_matches_jax():
    states, moves = _scripted_ko_game()
    jps = jstep.planes_from_states(jnp.asarray(states))
    jps = jps._replace(atari=jstep.init_atari(jps), ko_surr=jstep.init_ko_surr(jps))
    tps = planes_to_torch(jps, "cpu")
    flagged = []
    for i, acts in enumerate(moves):
        jnew, jinfo = _jit_step_states(jnp.asarray(states), jnp.asarray(acts))
        tnew, tinfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
        np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
        _assert_tuple_equal(jinfo, tinfo)
        jps, jpinfo = _jit_step_planes(jps, jnp.asarray(acts))
        tps, tpinfo = tstep.step_planes(tps, torch.from_numpy(acts))
        _assert_tuple_equal(jps, tps)
        _assert_tuple_equal(jpinfo, tpinfo)
        if i == 8:  # black's capture of the white stone at 6
            assert int(tinfo.num_captured[0]) == 1
            assert tnew[0, 3].reshape(-1)[6] == 1  # the ko point
        flagged.append(bool(tinfo.invalid_action[0]))
        states = np.asarray(jnew)
    assert flagged[9] and not any(flagged[:9]) and not any(flagged[10:])


def test_invalid_action_flags_match_jax():
    rng = np.random.default_rng(7)
    n, b = 7, 32  # the shapes of the game test above, so JAX's compilations are reused
    states = np.zeros((b, 6, n, n), np.int8)
    for _ in range(40):
        states = np.asarray(_jit_step_states(jnp.asarray(states), jnp.asarray(_random_actions(rng, states)))[0])
    acts = _random_actions(rng, states)
    j = np.asarray(jstep.invalid_action_flags(jnp.asarray(states), jnp.asarray(acts)))
    t = tstep.invalid_action_flags(torch.from_numpy(states.copy()), torch.from_numpy(acts)).numpy()
    np.testing.assert_array_equal(j, t)
    assert j.any() and not j.all()


def test_planes_round_trip_and_seed_planes_match_jax():
    rng = np.random.default_rng(8)
    n, b = 9, 32
    states = np.zeros((b, 6, n, n), np.int8)
    for _ in range(60):
        states = np.asarray(_jit_step_states(jnp.asarray(states), jnp.asarray(_random_actions(rng, states)))[0])
    t_states = torch.from_numpy(states.copy())
    tps = tstep.planes_from_states(t_states)
    assert torch.equal(tstep.states_from_planes(tps), t_states)
    jps = jstep.planes_from_states(jnp.asarray(states))
    np.testing.assert_array_equal(np.asarray(jstep.init_atari(jps)), tstep.init_atari(tps).numpy())
    np.testing.assert_array_equal(np.asarray(jstep.init_ko_surr(jps)), tstep.init_ko_surr(tps).numpy())


def test_state_accessors_and_convert_round_trip():
    from gymgo_tpu.core import state as jstate
    from gymgo_tpu_torch import convert
    from gymgo_tpu_torch.core import state as tstate

    rng = np.random.default_rng(9)
    n, b = 7, 32
    states = np.zeros((b, 6, n, n), np.int8)
    for _ in range(50):
        states = np.asarray(_jit_step_states(jnp.asarray(states), jnp.asarray(_random_actions(rng, states)))[0])
    t = convert.states_to_torch(states, "cpu")
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(convert.states_to_numpy(t), states)
    for name in ("black", "white", "invalid_channel", "turn", "prev_player_passed", "game_ended"):
        j = np.asarray(getattr(jstate, name)(jnp.asarray(states)))
        np.testing.assert_array_equal(j, getattr(tstate, name)(t).numpy(), err_msg=name)
    assert tstate.board_size(t) == n and tstate.action_size(n) == n * n + 1
    assert tstate.init_state(n, device="cpu").shape == (6, n, n)
    np.testing.assert_array_equal(
        np.asarray(jstate.batch_init_state(b, n)), tstate.batch_init_state(b, n, device="cpu").numpy())
    # a carried PlanesState crosses over and back with its atari / ko_surr planes
    jps = jstep.planes_from_states(jnp.asarray(states))
    jps = jps._replace(atari=jstep.init_atari(jps), ko_surr=jstep.init_ko_surr(jps))
    back = convert.planes_to_numpy(convert.planes_to_torch(jps, "cpu"))
    for name in jps._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jps, name)), back[name], err_msg=name)
    assert convert.planes_to_torch(jstep.planes_from_states(jnp.asarray(states)), "cpu").atari is None
