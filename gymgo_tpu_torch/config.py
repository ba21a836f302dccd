"""Environment configuration (the same fields and semantics as ``gymgo_tpu.config``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REAL = "real"
HEURISTIC = "heuristic"


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static configuration of a (batched) Go environment.

    Attributes:
      board_size: side length N of the square board.
      komi: compensation subtracted from black's area when scoring.
      reward_method: "real" (win/lose/draw sign at game end) or "heuristic"
        (area difference every step; +/- N^2 at game end), including the
        reference's tie -> -N^2 quirk of the heuristic method.
      batch_size: number of independent games stepped in lockstep.
      auto_reset: when True, an env that is done at entry to ``step`` is
        replaced by a fresh board before the incoming action is applied.
    """

    board_size: int
    komi: float = 0.0
    reward_method: str = REAL
    batch_size: int = 1
    auto_reset: bool = False

    def __post_init__(self):
        if self.board_size < 2:
            raise ValueError(f"board_size must be >= 2, got {self.board_size}")
        if self.reward_method not in (REAL, HEURISTIC):
            raise ValueError(f"unknown reward_method {self.reward_method!r}")

    @property
    def action_size(self) -> int:
        return self.board_size * self.board_size + 1

    @property
    def pass_action(self) -> int:
        return self.board_size * self.board_size


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for sharded stepping and learning.

    The ``env`` axis shards the env batch (pure data parallel: a Go step has no
    cross-env communication).  A ``model`` axis is used by the learner for
    tensor-parallel sharding of network parameters
    (``models.az_net.param_shardings``).
    """

    axis_names: Tuple[str, ...] = ("env",)
    axis_sizes: Optional[Tuple[int, ...]] = None  # None -> all devices on axis 0
