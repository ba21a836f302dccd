"""gymgo_tpu_torch.gogame against gymgo_tpu.gogame, bit for bit: every public
function, float64 outputs compared with ``np.array_equal``, on games played
with the reference's global ``np.random`` stream at 5, 7, 9 and 19."""

import numpy as np
import pytest
import torch

from gymgo_tpu import gogame as jgogame
from gymgo_tpu_torch import gogame as tgogame

CPU = {"device": "cpu"}
SIZES = [5, 7, 9, 19]


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    assert np.array_equal(got, want), what


def _game(size, seed, moves):
    """float64 states of one game of ``random_action`` moves (np.random)."""
    np.random.seed(seed)
    states = [jgogame.init_state(size)]
    for _ in range(moves):
        if jgogame.game_ended(states[-1]):
            break
        states.append(jgogame.next_state(states[-1], jgogame.random_action(states[-1])))
    return states


@pytest.mark.parametrize("size", SIZES)
def test_random_game_transitions_match(size):
    np.random.seed(size)
    js = jgogame.init_state(size)
    ts = tgogame.init_state(size)
    _equal(ts, js, "init_state")
    for t in range(2 * size * size if size < 19 else 60):
        if jgogame.game_ended(js):
            break
        a = jgogame.random_action(js)
        canonical = t % 3 == 0
        want = jgogame.next_state(js, a)
        _equal(tgogame.next_state(ts, a, **CPU), want, f"move {t}")
        if canonical:
            _equal(tgogame.next_state(ts, a, canonical=True, **CPU), jgogame.next_state(js, a, canonical=True))
        got, areas = tgogame._next_state_with_areas(ts, a, **CPU)
        want_s, want_areas = jgogame._next_state_with_areas(js, a)
        _equal(got, want_s)
        assert areas == want_areas and all(type(x) is int for x in areas)
        js, ts = want, got
    assert np.count_nonzero(js[:2]) > 0


@pytest.mark.parametrize("size", SIZES)
def test_queries_match(size):
    for state in _game(size, size + 1, 4 * size)[:: max(1, size // 2)]:
        for name in ("invalid_moves", "valid_moves", "prev_player_passed", "game_ended", "turn", "action_size"):
            want = getattr(jgogame, name)(state)
            got = getattr(tgogame, name)(state)
            assert type(got) is type(want), name
            _equal(got, want, name)
        a_t, a_j = tgogame.areas(state, **CPU), jgogame.areas(state)
        assert a_t == a_j and all(type(x) is float for x in a_t)
        for komi in (0, 2.5):
            w_t, w_j = tgogame.winning(state, komi, **CPU), jgogame.winning(state, komi)
            assert type(w_t) is type(w_j) and w_t == w_j
        n_t, n_j = tgogame.num_liberties(state, **CPU), jgogame.num_liberties(state)
        assert n_t == n_j and all(type(x) is int for x in n_t)
        for got, want in zip(tgogame.liberties(state, **CPU), jgogame.liberties(state)):
            _equal(got, want, "liberties")
        _equal(tgogame.canonical_form(state, **CPU), jgogame.canonical_form(state), "canonical_form")
        assert tgogame.str(state, **CPU) == jgogame.str(state)
    assert tgogame.action_size(board_size=size) == jgogame.action_size(board_size=size)
    with pytest.raises(RuntimeError):
        tgogame.action_size()


@pytest.mark.parametrize("size", SIZES)
def test_children_match(size):
    state = _game(size, 2 * size, 3 * size)[-1]
    for canonical in (False, True):
        for padded in (True, False):
            _equal(tgogame.children(state, canonical, padded, **CPU), jgogame.children(state, canonical, padded),
                   f"children canonical={canonical} padded={padded}")


@pytest.mark.parametrize("size", SIZES)
def test_batch_functions_match(size):
    games = [_game(size, 10 * size + i, (i + 1) * size) for i in range(6)]
    batch = np.stack([g[-1] for g in games] + [jgogame.init_state(size)])
    np.random.seed(size)
    actions = np.array([np.random.choice(np.flatnonzero(v)) for v in jgogame.batch_valid_moves(batch)])
    for canonical in (False, True):
        _equal(tgogame.batch_next_states(batch, actions, canonical, **CPU),
               jgogame.batch_next_states(batch, actions, canonical), f"batch_next_states canonical={canonical}")
    for name in ("batch_invalid_moves", "batch_valid_moves", "batch_prev_player_passed", "batch_game_ended",
                 "batch_turn"):
        _equal(getattr(tgogame, name)(batch), getattr(jgogame, name)(batch), name)
    for got, want in zip(tgogame.batch_areas(batch, **CPU), jgogame.batch_areas(batch)):
        _equal(got, want, "batch_areas")
    _equal(tgogame.batch_winning(batch, 1.5, **CPU), jgogame.batch_winning(batch, 1.5), "batch_winning")
    _equal(tgogame.batch_canonical_form(batch, **CPU), jgogame.batch_canonical_form(batch), "batch_canonical_form")
    _equal(tgogame.batch_init_state(3, size), jgogame.batch_init_state(3, size), "batch_init_state")


def test_invalid_move_raises_assertion_with_the_same_payload():
    state = tgogame.next_state(tgogame.init_state(5), 6, **CPU)
    with pytest.raises(AssertionError) as got:
        tgogame.next_state(state, 6, **CPU)
    with pytest.raises(AssertionError) as want:
        jgogame.next_state(state, 6)
    assert got.value.args == want.value.args == (("Invalid move", [0]),)
    batch = np.stack([state, state, tgogame.init_state(5)])
    with pytest.raises(AssertionError) as got:
        tgogame.batch_next_states(batch, [6, 7, 6], **CPU)
    with pytest.raises(AssertionError) as want:
        jgogame.batch_next_states(batch, [6, 7, 6])
    assert got.value.args == want.value.args == (("Invalid move", [0]),)
    with pytest.raises(AssertionError):
        tgogame.next_state(state, 26, **CPU)  # out of range


def test_finished_game_is_a_frozen_no_op_with_all_moves_valid():
    ended = tgogame.next_state(tgogame.next_state(tgogame.init_state(5), 25, **CPU), 25, **CPU)
    assert tgogame.game_ended(ended) == 1
    _equal(tgogame.invalid_moves(ended), jgogame.invalid_moves(ended))
    assert not tgogame.invalid_moves(ended).any()
    # the batch variant has no game-ended branch: the pass column only is 0
    _equal(tgogame.batch_invalid_moves(ended[None]), jgogame.batch_invalid_moves(ended[None]))
    for a in (3, 25):
        _equal(tgogame.next_state(ended, a, **CPU), ended)
        _equal(tgogame.next_state(ended, a, **CPU), jgogame.next_state(ended, a))


def test_host_draws_follow_global_np_random():
    state = _game(7, 3, 20)[-1]
    np.random.seed(5)
    want = [jgogame.random_action(state) for _ in range(20)]
    np.random.seed(5)
    assert [tgogame.random_action(state) for _ in range(20)] == want
    np.random.seed(6)
    want = [jgogame.random_symmetry(state) for _ in range(16)]
    np.random.seed(6)
    for got, w in zip([tgogame.random_symmetry(state) for _ in range(16)], want):
        _equal(got, w)
    for got, w in zip(tgogame.all_symmetries(state), jgogame.all_symmetries(state)):
        _equal(got, w)
    weights = np.arange(10.0)
    np.random.seed(7)
    want = [jgogame.random_weighted_action(weights) for _ in range(20)]
    np.random.seed(7)
    assert [tgogame.random_weighted_action(weights) for _ in range(20)] == want


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    state = tgogame.init_state(5)
    for call in (lambda: tgogame.next_state(state, 0), lambda: tgogame.areas(state),
                 lambda: tgogame.children(state), lambda: tgogame.str(state)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the numpy-only functions need no device
    assert tgogame.valid_moves(state).sum() == 26
