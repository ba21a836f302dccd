"""Trump-Taylor area scoring and liberty queries (counterpart of
``gymgo_tpu.core.score``).

Every cell of an empty region learns whether the region touches black and/or
white; a region counts for a colour iff it touches only that colour.  On CUDA
tensors the claims are read from the bundle word of the hand kernel, as the
step reads them, with no host sync; boards too large for the bundle word
(``core.flood.bundle_fits``: over 22x22, up to 181x181) take the claim flood's
hand kernel, with no host sync either.  CPU tensors take the claim flood's
plain version, which checks its convergence on the host.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.config import HEURISTIC, REAL, EnvConfig
from gymgo_tpu_torch.core import flood as _flood
from gymgo_tpu_torch.core.flood import neighbor_or
from gymgo_tpu_torch.ops.claim_flood import claim_flood
from gymgo_tpu_torch.utils import tracing

__all__ = ["areas", "areas_planes", "winning", "winning_planes", "liberties", "num_liberties",
           "reward_from_areas"]


def _claims(black: torch.Tensor, white: torch.Tensor):
    """(only_black, only_white): empty cells whose region touches one colour."""
    black, white = black.contiguous(), white.contiguous()
    with tracing.span("env.flood"):
        if black.is_cuda and _flood.bundle_fits(black.shape[-1]):
            return _flood.flood_bundle(black, white)[2:4]
        claims = claim_flood(black, white)
        return claims == 1, claims == 2


def areas_planes(black: torch.Tensor, white: torch.Tensor):
    """(black_area, white_area) int32 (B,) from bool colour planes (B, N, N),
    under the span ``env.score``."""
    b = black.shape[0]
    with tracing.span("env.score"):
        only_black, only_white = _claims(black, white)
        black_area = (black | only_black).reshape(b, -1).sum(1, dtype=torch.int32)
        white_area = (white | only_white).reshape(b, -1).sum(1, dtype=torch.int32)
    return black_area, white_area


def areas(states: torch.Tensor):
    """Batched Trump-Taylor area score: (black_area, white_area) int32 (B,)."""
    return areas_planes(states[:, govars.BLACK].bool(), states[:, govars.WHITE].bool())


def winning_planes(black: torch.Tensor, white: torch.Tensor, komi: float = 0.0) -> torch.Tensor:
    """sign(black_area - white_area - komi) per env, float32, from black's view."""
    black_area, white_area = areas_planes(black, white)
    return torch.sign(black_area.to(torch.float32) - white_area.to(torch.float32) - komi)


def winning(states: torch.Tensor, komi: float = 0.0) -> torch.Tensor:
    """``winning_planes`` of int8 states; valid mid-game as well as at the end."""
    return winning_planes(states[:, govars.BLACK].bool(), states[:, govars.WHITE].bool(), komi)


def liberties(states: torch.Tensor):
    """Per-colour liberty masks, bool ``(B, N, N)`` each: the empty cells next
    to that colour (per colour, not per group: a point next to both counts
    for both)."""
    black = states[:, govars.BLACK].bool()
    white = states[:, govars.WHITE].bool()
    empty = ~(black | white)
    return empty & neighbor_or(black), empty & neighbor_or(white)


def num_liberties(states: torch.Tensor):
    """Popcounts of the per-colour liberty masks, int32 ``(B,)`` each."""
    b = states.shape[0]
    black_libs, white_libs = liberties(states)
    return (black_libs.reshape(b, -1).sum(1, dtype=torch.int32),
            white_libs.reshape(b, -1).sum(1, dtype=torch.int32))


def reward_from_areas(black_area, white_area, done, config: EnvConfig) -> torch.Tensor:
    """Reward from the step's Trump-Taylor areas, float32 (B,).

    HEURISTIC pays the area difference every step and +/- N^2 at game end, a
    tie at game end counting as a loss (the reference's quirk)."""
    n = config.board_size
    with tracing.span("env.score"):
        kc = black_area.to(torch.float32) - white_area.to(torch.float32) - config.komi
        if config.reward_method == REAL:
            return torch.where(done, torch.sign(kc), 0.0)
        if config.reward_method == HEURISTIC:
            end_reward = torch.where(kc > 0, 1.0, -1.0) * (n * n)
            return torch.where(done, end_reward, kc)
    raise ValueError(config.reward_method)
