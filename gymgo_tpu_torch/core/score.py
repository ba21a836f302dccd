"""Trump-Taylor area scoring (counterpart of ``gymgo_tpu.core.score``).

A two-bit OR-flood tells every cell of an empty region whether the region
touches black and/or white; a region counts for a colour iff it touches only
that colour.  The step computes the same areas from its bundle flood; these
stand-alone functions use ``flood_or_best`` (the plain ``flood_or`` on every
route), which syncs with the host.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.core import flood as _flood
from gymgo_tpu_torch.core.flood import neighbor_or

__all__ = ["areas", "areas_planes", "winning"]


def areas_planes(black: torch.Tensor, white: torch.Tensor):
    """(black_area, white_area) int32 (B,) from bool colour planes (B, N, N)."""
    b = black.shape[0]
    empty = ~(black | white)
    touch = (empty & neighbor_or(black)).to(torch.uint8)
    touch |= (empty & neighbor_or(white)).to(torch.uint8) << 1
    touch = _flood.flood_or_best(touch, empty)
    black_area = (black | (empty & (touch == 1))).reshape(b, -1).sum(1, dtype=torch.int32)
    white_area = (white | (empty & (touch == 2))).reshape(b, -1).sum(1, dtype=torch.int32)
    return black_area, white_area


def areas(states: torch.Tensor):
    """Batched Trump-Taylor area score: (black_area, white_area) int32 (B,)."""
    return areas_planes(states[:, govars.BLACK].bool(), states[:, govars.WHITE].bool())


def winning(states: torch.Tensor, komi: float = 0.0) -> torch.Tensor:
    """sign(black_area - white_area - komi) per env, float32, from black's view."""
    black_area, white_area = areas(states)
    return torch.sign(black_area.to(torch.float32) - white_area.to(torch.float32) - komi)
