"""Head-to-head policy evaluation: batched match play (counterpart of
``gymgo_tpu.rl.evaluate``).

Two policies play a batch of games against each other, alternating colours
across the batch to cancel the first-move advantage: each ply evaluates both
policies and selects per env by whose turn it is.  Reports win and draw
tallies, the evaluation leg of the AZ loop.

On the card one ply (both policies, the opening override, the step) is one
CUDA graph, the body of the JAX package's ``lax.scan`` over the plies
(``_ply``, ``utils.graphs.compiled``, keyed by the two policies by identity:
a policy object built once replays across matches).  The "every game is
done" check stays between the replays, one host read a ply.  A policy must
be a function of its ``(generator, states)`` on the card with no host sync:
one that reads Python state replays what it read at the capture.  Boards
over the route's kernels' size (22x22 on the bundle route, 181x181 on the
minmax route) play eagerly (``utils.graphs.capturable``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.utils.graphs import capturable_states, compiled

__all__ = ["MatchResult", "play_match", "with_pass_to_win"]


class MatchResult(NamedTuple):
    policy_a_wins: torch.Tensor  # int32 scalar
    policy_b_wins: torch.Tensor  # int32 scalar
    ties: torch.Tensor  # int32 scalar
    unfinished: torch.Tensor  # int32 scalar (hit max_steps)
    a_winrate: torch.Tensor  # float32 scalar over finished games
    # Area-adjudicated tallies over all games: an unfinished game is scored by
    # Trump-Taylor area (minus komi) at the move cap, the standard adjudication
    # when two near-equal nets play past the cap.  For a finished game the
    # area sign is the game's result, so scored = finished + adjudicated rest.
    a_scored_wins: torch.Tensor  # int32 scalar
    b_scored_wins: torch.Tensor  # int32 scalar
    scored_ties: torch.Tensor  # int32 scalar
    a_scored_winrate: torch.Tensor  # float32 scalar over all games


def _first_best_board_move(valid_board: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """argmax of ``noise`` over the valid board moves, int32 (B,)."""
    return torch.where(valid_board, noise, -torch.inf).argmax(dim=1).to(torch.int32)


def _ply(generator, states, a_is_black, opening, policy_a, policy_b):
    """One ply of a match: both policies (A draws first), the mover's
    action, the uniform opening move of each game's pair where ``opening``
    (float32 (pairs, N*N) noise) is given; returns the next states."""
    acts_a = policy_a(generator, states)
    acts_b = policy_b(generator, states)
    a_to_move = (_state.turn(states) == 0) == a_is_black
    acts = torch.where(a_to_move, acts_a, acts_b).to(torch.int32)
    if opening is not None:
        # each pair's row twice in a row, one per colour-swapped game
        g = opening[:, None].expand(opening.shape[0], 2, opening.shape[1]).reshape(-1, opening.shape[1])
        acts = _first_best_board_move(_actions.batch_valid_moves(states)[:, :-1] > 0, g[: states.shape[0]])
    return _step.step_states(states, acts)[0]


_ply = compiled(_ply, static_argnames=("policy_a", "policy_b"), when=capturable_states)


@torch.no_grad()
def play_match(
    generator: torch.Generator,
    policy_a: Callable,
    policy_b: Callable,
    config: EnvConfig,
    num_games: int,
    max_steps: int,
    opening_moves: int = 0,
    with_states: bool = False,
    opening_noise: torch.Tensor | None = None,
    device=None,
):
    """Play ``num_games`` games of at most ``max_steps`` plies on ``device``
    (``cuda`` unless named); policy_a is black in even-index games and white
    in odd-index games.  Policies: ``fn(generator, states) -> actions``; both
    draw from the one ``generator``, A first.  Finished games freeze (no
    auto-reset), and the loop ends early once every game is done, which it
    reads on the host once per ply.

    ``opening_moves`` > 0 forces the first k plies to uniform-random legal
    board moves (the argmax of Gumbel noise over the legal ones), with the
    same random opening shared by each colour-swapped pair (games 2i and
    2i + 1): every opening is played once with A as black and once with A as
    white.  Without it two nearly deterministic search policies replay the
    same few games from the empty board.  ``opening_noise`` is that noise,
    float32 ``(opening_moves, ceil(num_games / 2), N*N)``, one row per ply
    and pair; it is drawn from ``generator`` unless given.

    Returns a ``MatchResult``, and the final states too with ``with_states``.
    """
    device = _state.resolve_device(device)
    n = config.board_size
    states = _state.batch_init_state(num_games, n, device=device)
    a_is_black = (torch.arange(num_games, device=device) % 2) == 0
    pairs = (num_games + 1) // 2
    if opening_moves > 0:
        if opening_noise is None:
            opening_noise = _actions.gumbel_noise(generator, (opening_moves, pairs, n * n), device)
        opening_noise = opening_noise.to(device=device, dtype=torch.float32)
        if tuple(opening_noise.shape) != (opening_moves, pairs, n * n):
            raise ValueError(
                f"opening_noise must be {(opening_moves, pairs, n * n)}, got {tuple(opening_noise.shape)}"
            )

    for t in range(max_steps):
        states = _ply(generator, states, a_is_black, opening_noise[t] if t < opening_moves else None,
                      policy_a=policy_a, policy_b=policy_b)
        if bool(_state.game_ended(states).all()):
            break

    done = _state.game_ended(states)
    sign_black = _score.winning(states, config.komi)
    a_sign = torch.where(a_is_black, sign_black, -sign_black)

    def count(mask):
        return mask.sum(dtype=torch.int32)

    a_wins, b_wins, ties = count(done & (a_sign > 0)), count(done & (a_sign < 0)), count(done & (a_sign == 0))
    a_scored = count(a_sign > 0)
    result = MatchResult(
        policy_a_wins=a_wins,
        policy_b_wins=b_wins,
        ties=ties,
        unfinished=count(~done),
        a_winrate=a_wins.to(torch.float32) / (a_wins + b_wins + ties).clamp_min(1),
        a_scored_wins=a_scored,
        b_scored_wins=count(a_sign < 0),
        scored_ties=count(a_sign == 0),
        a_scored_winrate=a_scored.to(torch.float32) / num_games,
    )
    if with_states:
        return result, states
    return result


def with_pass_to_win(policy_fn, komi: float = 0.0, fallback_noise_fn: Callable | None = None):
    """Wrap a policy with the sound match-play pass rule: pass only when it
    ends the game at once as a win (the previous move was a pass and the
    mover leads on Trump-Taylor area minus komi), or when no board move is
    legal; otherwise always play a board move.

    Self-play nets learn "pass when ahead", which is an equilibrium against
    themselves but loses tempo after tempo against an opponent who keeps
    playing.  A pass that does not end the game is never forced, so the
    wrapped policy cedes no tempo; a pass that ends it is taken exactly when
    it seals the win.

    A replaced pass falls back to a uniform-random legal board move: the
    argmax of Gumbel noise over the legal ones.  ``fallback_noise_fn(states)
    -> float32 (B, N*N)`` supplies that noise; without it, it is drawn from
    the generator after the inner policy's draws.  For a policy-aware
    replacement give the inner policy a huge ``pass_min_stones`` (every
    search policy takes it), so that its own ranking picks the best board
    move and the wrapper only ever adds the winning pass."""

    def wrapped(generator, states):
        n = states.shape[-1]
        acts = policy_fn(generator, states)
        valid_board = _actions.batch_valid_moves(states)[:, :-1] > 0
        board_any = valid_board.any(dim=1)
        prev_passed = states[:, govars.PASS_CHNL, 0, 0] != 0
        black_area, white_area = _score.areas(states)
        lead = torch.where(
            _state.turn(states) == 1,
            white_area.to(torch.float32) - black_area + komi,
            black_area.to(torch.float32) - white_area - komi,
        )
        win_by_pass = prev_passed & (lead > 0)
        pass_idx = n * n
        # force the winning pass; otherwise never pass while a move exists
        acts = torch.where(win_by_pass, pass_idx, acts).to(torch.int32)
        if fallback_noise_fn is None:
            g = _actions.gumbel_noise(generator, valid_board.shape, states.device)
        else:
            g = fallback_noise_fn(states).to(device=states.device, dtype=torch.float32)
        fallback = _first_best_board_move(valid_board, g)
        return torch.where((acts == pass_idx) & ~win_by_pass & board_any, fallback, acts)

    return wrapped
