"""Move masks, the one-ply expansion and the on-device samplers (counterpart
of ``gymgo_tpu.core.actions``).

The sampler draws one random word per env, ``k ~ U[0, num_valid]``, and picks
the k-th valid move by rank (pass ranks last).  The draw and the rank-select
are separate functions, so a test can hand the rank-select the JAX package's
``k`` and compare actions exactly.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.utils import tracing

__all__ = [
    "batch_invalid_moves",
    "batch_valid_moves",
    "mask_early_pass",
    "children",
    "kth_valid_actions",
    "draw_words",
    "scale_words",
    "uniform_from_words",
    "uniform_random_actions",
    "uniform_random_actions_planes",
    "gumbel_noise",
    "weighted_random_actions",
]


def batch_invalid_moves(states: torch.Tensor) -> torch.Tensor:
    """Flat invalid-move vectors float32 ``(B, N*N+1)``; pass (last column)
    always 0."""
    b = states.shape[0]
    flat = states[:, govars.INVD_CHNL].reshape(b, -1).to(torch.float32)
    return torch.cat([flat, flat.new_zeros((b, 1))], dim=1)


def batch_valid_moves(states: torch.Tensor) -> torch.Tensor:
    return 1.0 - batch_invalid_moves(states)


def mask_early_pass(valid: torch.Tensor, states: torch.Tensor, min_stones: int) -> torch.Tensor:
    """Disallow pass while the board holds fewer than ``min_stones`` stones and
    another legal move exists (the self-play opening constraint; pass stays
    allowed once no board move is legal).

    ``valid``: bool or 0/1 ``(B, N*N+1)`` with pass last; returns bool, and
    the mask itself (cast to bool) when ``min_stones <= 0``."""
    valid = valid if valid.dtype == torch.bool else valid > 0
    if min_stones <= 0:
        return valid
    b = states.shape[0]
    stones = states[:, :2].reshape(b, -1).sum(1, dtype=torch.int32)
    board_any = valid[:, :-1].any(dim=1)
    allow_pass = (stones >= min_stones) | ~board_any
    out = valid.clone()
    out[:, -1] &= allow_pass
    return out


def children(state: torch.Tensor, canonical: bool = False) -> torch.Tensor:
    """One-ply expansion of a single state ``(6, N, N)``: ``(N*N+1, 6, N, N)``.

    Row a holds the state after action a where a is valid and zeros where it
    is not (the reference's padded layout); once the game is done every row
    is valid and holds the unchanged state."""
    from gymgo_tpu_torch.core.step import step_states
    from gymgo_tpu_torch.core.transform import batch_canonical_form

    n = state.shape[-1]
    num_actions = n * n + 1
    tiled = state[None].expand((num_actions,) + tuple(state.shape)).contiguous()
    actions = torch.arange(num_actions, dtype=torch.int32, device=state.device)
    stepped, info = step_states(tiled, actions)
    if canonical:
        stepped = batch_canonical_form(stepped)
    ended = state[govars.DONE_CHNL, 0, 0] != 0
    valid = ~info.invalid_action | ended
    return torch.where(valid[:, None, None, None], stepped, 0).to(state.dtype)


def kth_valid_actions(valid_board: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The ``k``-th valid board move (0-based rank along the flat board) of each
    env, or pass (index ``m``) when ``k`` equals the number of valid moves.

    ``valid_board`` is bool ``(B, m)``; ``k`` is integer ``(B,)`` in
    ``[0, num_valid]``.  For square ``m = n*n`` a two-level select (a per-row
    count, then one row) touches ``(B, m)`` only twice; otherwise a flat
    cumulative count.  Both pick the same move.
    """
    b, m = valid_board.shape
    k = k.to(torch.int64)
    n = int(round(m ** 0.5))
    if n * n != m:
        csum = valid_board.to(torch.int32).cumsum(dim=-1)
        num_board = csum[:, -1]
        hit = valid_board & (csum == (k + 1)[:, None])
        board_choice = hit.to(torch.uint8).argmax(dim=-1)
        return torch.where(k == num_board, m, board_choice).to(torch.int32)

    v = valid_board.view(b, n, n)
    row_cnt = v.sum(dim=2, dtype=torch.int32)  # (B, n)
    row_csum = row_cnt.cumsum(dim=1)
    num_board = row_csum[:, -1]
    r = (row_csum > k[:, None]).to(torch.uint8).argmax(dim=1)  # row holding rank k
    before = (row_csum - row_cnt).gather(1, r[:, None])[:, 0]  # valids above row r
    vrow = v.gather(1, r[:, None, None].expand(b, 1, n))[:, 0]  # (B, n) row r
    ccol = vrow.to(torch.int32).cumsum(dim=1)
    within = k - before + 1  # 1-based rank inside row r
    col = (vrow & (ccol == within[:, None])).to(torch.uint8).argmax(dim=1)
    board_choice = r * n + col
    return torch.where(k == num_board, m, board_choice).to(torch.int32)


def draw_words(generator: torch.Generator, shape, device) -> torch.Tensor:
    """One random 31-bit word per env, int64 ``shape``, drawn on ``device``
    from ``generator`` with no host sync.

    A sharded rollout draws the words of the whole batch once and hands each
    shard its rows, so its stream does not depend on the sharding."""
    return torch.randint(0, 1 << 31, tuple(shape), generator=generator, device=device, dtype=torch.int64)


def scale_words(word: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
    """k in [0, num_valid] per env (int64) from ``draw_words``' words, by
    multiply-and-shift; the bias is below (num_valid + 1) / 2^31."""
    return (word * (num_valid.to(torch.int64) + 1)) >> 31


def uniform_from_words(word: torch.Tensor, valid_board: torch.Tensor) -> torch.Tensor:
    """The uniform sampler's actions from its words: the k-th valid move of
    each env of bool ``valid_board`` ``(B, N*N)``, pass ranked last."""
    return kth_valid_actions(valid_board, scale_words(word, valid_board.sum(dim=1, dtype=torch.int32)))


def _uniform_from_valid(generator, valid_board):
    with tracing.span("env.sampler"):
        word = draw_words(generator, valid_board.shape[:1], valid_board.device)
        return uniform_from_words(word, valid_board)


def uniform_random_actions(generator: torch.Generator, states: torch.Tensor) -> torch.Tensor:
    """Uniform draw over each env's valid actions (pass included)."""
    b = states.shape[0]
    return _uniform_from_valid(generator, states[:, govars.INVD_CHNL].reshape(b, -1) == 0)


def uniform_random_actions_planes(generator: torch.Generator, ps) -> torch.Tensor:
    """``uniform_random_actions`` on the planes state (reads its invd plane)."""
    b = ps.invd.shape[0]
    return _uniform_from_valid(generator, ~ps.invd.reshape(b, -1))


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws, float32 ``shape``, from ``generator`` on
    ``device``: ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def weighted_random_actions(generator: torch.Generator, weights: torch.Tensor,
                            gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Sample actions in proportion to non-negative ``weights`` ``(B, N*N+1)``;
    an invalid move carries weight 0 and is never drawn.

    The draw is the argmax of ``log(weights) + gumbel``; ``gumbel`` (float32,
    the shape of ``weights``) is drawn from ``generator`` unless given."""
    logits = torch.where(weights > 0, torch.log(weights.clamp_min(1e-30)), -torch.inf)
    if gumbel is None:
        gumbel = gumbel_noise(generator, weights.shape, weights.device)
    return (logits + gumbel).argmax(dim=-1).to(torch.int32)
