"""gymgo_tpu_torch.rl.evaluate against gymgo_tpu.rl.evaluate.

The two packages draw different random numbers, so the policies here are
deterministic functions of the state (written once for each package), and the
noise that decides a result is drawn in JAX from the key the JAX function
uses and handed to the port: the opening noise of ``play_match`` and the
fallback noise of ``with_pass_to_win``.  Final states and every tally are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core import actions as jactions
from gymgo_tpu.rl import evaluate as jevaluate
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as tactions
from gymgo_tpu_torch.rl import evaluate as tevaluate
from torch_boards import midgame_states


def _policy_table(n, seed, pass_from):
    """Weights (N*N+1, N*N+1) looked up by the number of stones on the board;
    pass wins the argmax once ``pass_from`` stones are down."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n * n + 1, n * n + 1)).astype(np.float32)
    table[:, -1] = -10.0
    table[pass_from:, -1] = 10.0
    return table


def _jax_policy(table):
    table = jnp.asarray(table)

    def fn(key, states):
        b = states.shape[0]
        stones = jnp.sum(states[:, :2].astype(jnp.int32).reshape(b, -1), axis=1)
        valid = jactions.batch_valid_moves(states) > 0
        return jnp.argmax(jnp.where(valid, table[stones], -jnp.inf), axis=1).astype(jnp.int32)

    return fn


def _torch_policy(table):
    table = torch.from_numpy(table)

    def fn(generator, states):
        b = states.shape[0]
        stones = states[:, :2].reshape(b, -1).sum(1, dtype=torch.int64)
        valid = tactions.batch_valid_moves(states) > 0
        return torch.where(valid, table[stones], -torch.inf).argmax(dim=1).to(torch.int32)

    return fn


def _jax_opening_noise(key, opening_moves, num_games, n):
    """The noise play_match draws (evaluate.py: a key per ply and pair, folded
    into the second half of the split of ``key``), one row per ply and pair."""
    _, opening_key = jax.random.split(key)
    pairs = (num_games + 1) // 2
    rows = [[jax.random.gumbel(jax.random.fold_in(jax.random.fold_in(opening_key, t), i), (n * n,))
             for i in range(pairs)] for t in range(opening_moves)]
    return np.asarray(rows, np.float32).reshape(opening_moves, pairs, n * n)


@pytest.mark.parametrize("n,games,max_steps,opening_moves,komi",
                         [(5, 16, 60, 0, 0.0), (5, 15, 60, 4, 0.5), (7, 12, 30, 6, 0.0), (9, 8, 200, 3, 5.5)])
def test_play_match_matches_jax(n, games, max_steps, opening_moves, komi):
    table_a = _policy_table(n, 1, pass_from=n * n // 2)
    table_b = _policy_table(n, 2, pass_from=n * n // 3)
    key = jax.random.PRNGKey(n + games)
    jres, jfinal = jax.jit(lambda k: jevaluate.play_match(
        k, _jax_policy(table_a), _jax_policy(table_b), JEnvConfig(board_size=n, komi=komi),
        num_games=games, max_steps=max_steps, opening_moves=opening_moves, with_states=True))(key)
    noise = _jax_opening_noise(key, opening_moves, games, n) if opening_moves else None
    tres, tfinal = tevaluate.play_match(
        None, _torch_policy(table_a), _torch_policy(table_b), EnvConfig(board_size=n, komi=komi),
        num_games=games, max_steps=max_steps, opening_moves=opening_moves, with_states=True,
        opening_noise=None if noise is None else torch.from_numpy(noise), device="cpu")
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for name in jres._fields:
        j, t = np.asarray(getattr(jres, name)), getattr(tres, name).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape == (), name
        assert j == t, (name, j, t)
    assert int(tres.policy_a_wins + tres.policy_b_wins + tres.ties + tres.unfinished) == games
    assert int(tres.a_scored_wins + tres.b_scored_wins + tres.scored_ties) == games
    if opening_moves:
        assert tfinal[:, :2].sum() >= games * opening_moves - 8  # the openings were played
    if max_steps == 30:
        assert int(tres.unfinished) > 0  # the cap cut games: adjudicated by area


def test_play_match_alternates_colours_and_pairs_openings():
    n, games, k_open = 5, 8, 6
    pass_idx = n * n
    always_pass = lambda g, s: torch.full((s.shape[0],), pass_idx, dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    res, finals = tevaluate.play_match(gen, always_pass, always_pass, EnvConfig(board_size=n), games,
                                       max_steps=k_open + 2, opening_moves=k_open, with_states=True,
                                       device="cpu")
    boards = finals[:, :2].numpy()
    for i in range(0, games, 2):
        np.testing.assert_array_equal(boards[i], boards[i + 1])
    assert len({boards[i].tobytes() for i in range(0, games, 2)}) > 1
    assert boards.sum(axis=(1, 2, 3)).min() == k_open
    assert int(res.unfinished) == 0
    # A is black in even games: a policy that always plays cell 0 against one
    # that always passes owns the board as black and as white
    play_00 = lambda g, s: torch.zeros((s.shape[0],), dtype=torch.int32)
    res = tevaluate.play_match(gen, play_00, always_pass, EnvConfig(board_size=n), 6, max_steps=4, device="cpu")
    assert int(res.a_scored_wins) == 6 and float(res.a_scored_winrate) == 1.0
    with pytest.raises(ValueError, match="opening_noise"):
        tevaluate.play_match(gen, play_00, always_pass, EnvConfig(board_size=n), 6, max_steps=4,
                             opening_moves=2, opening_noise=torch.zeros((2, 6, n * n)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tevaluate.play_match(gen, play_00, always_pass, EnvConfig(board_size=n), 6, max_steps=4)


def test_play_match_with_the_port_s_samplers():
    gen = torch.Generator().manual_seed(0)
    res = tevaluate.play_match(gen, tactions.uniform_random_actions, tactions.uniform_random_actions,
                               EnvConfig(board_size=5), num_games=16, max_steps=400, opening_moves=4,
                               device="cpu")
    assert int(res.unfinished) == 0
    assert int(res.a_scored_wins) == int(res.policy_a_wins)
    assert int(res.b_scored_wins) == int(res.policy_b_wins)
    assert int(res.scored_ties) == int(res.ties)
    assert float(res.a_scored_winrate) == pytest.approx(int(res.policy_a_wins) / 16)


@pytest.mark.parametrize("n,komi", [(5, 0.0), (7, 2.5)])
def test_with_pass_to_win_matches_jax_given_the_noise(n, komi):
    states = np.concatenate([midgame_states(n, 24, n * n // 2, 6), midgame_states(n, 24, n * n, 7)])
    states[::2, 4] = 1  # half of the envs: the previous move was a pass
    states[-1, 3] = 1  # no legal board move: the pass stays
    b, pass_idx = len(states), n * n
    inner = np.where(np.arange(b) % 3 == 0, pass_idx, np.argmin(states[:, 3].reshape(b, -1), axis=1))
    inner = inner.astype(np.int32)
    key = jax.random.PRNGKey(n)
    want = np.asarray(jevaluate.with_pass_to_win(lambda k, s: jnp.asarray(inner), komi)(key, jnp.asarray(states)))
    # evaluate.py: key, fb_key = split(key); g = gumbel(fb_key, (B, N*N))
    noise = np.asarray(jax.random.gumbel(jax.random.split(key)[1], (b, n * n)))
    wrapped = tevaluate.with_pass_to_win(lambda g, s: torch.from_numpy(inner), komi,
                                         fallback_noise_fn=lambda s: torch.from_numpy(noise))
    got = wrapped(None, torch.from_numpy(states))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == pass_idx).any() and (want[inner == pass_idx] != pass_idx).any()
    assert (want[inner != pass_idx] == pass_idx).any()  # a winning pass overrides a board move


def test_with_pass_to_win_rule():
    """The wrapper passes exactly when passing seals a win, never cedes a
    tempo otherwise, and still passes when no board move exists."""
    n = 5
    pass_idx = n * n
    always_pass = lambda g, s: torch.full((s.shape[0],), pass_idx, dtype=torch.int32)
    play_00 = lambda g, s: torch.zeros((s.shape[0],), dtype=torch.int32)
    s = np.zeros((3, 6, n, n), np.int8)
    s[0, 0, :3, :] = 1  # black to move, the previous move a pass, black ahead: pass wins now
    s[0, 4] = 1
    s[1, 1, :3, :] = 1  # the same, black behind: a pass would lose
    s[1, 4] = 1
    s[2, 0, :3, :] = 1  # like env 0, but the previous move was no pass
    s[:, 3] = s[:, 0] | s[:, 1]
    states = torch.from_numpy(s)
    gen = torch.Generator().manual_seed(0)
    acts = tevaluate.with_pass_to_win(always_pass)(gen, states)
    assert int(acts[0]) == pass_idx and int(acts[1]) != pass_idx and int(acts[2]) != pass_idx
    assert (s[[1, 2], 3].reshape(2, -1)[[0, 1], acts[1:].numpy()] == 0).all()  # legal fallbacks
    acts2 = tevaluate.with_pass_to_win(play_00)(gen, states)
    assert int(acts2[0]) == pass_idx and int(acts2[1]) == 0 and int(acts2[2]) == 0
