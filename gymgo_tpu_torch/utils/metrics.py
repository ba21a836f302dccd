"""Batched rollout counters (counterpart of ``gymgo_tpu.utils.metrics``):
0-d int32 tensors on the device, folded from each step's ``StepResult`` with
no host sync, and read on the host only by ``format_metrics``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymgo_tpu_torch.core.state import resolve_device

__all__ = ["RolloutMetrics", "init_metrics", "update_metrics", "format_metrics"]


class RolloutMetrics(NamedTuple):
    env_steps: torch.Tensor  # int32 0-d
    games_finished: torch.Tensor  # int32 0-d
    stones_captured: torch.Tensor  # int32 0-d
    invalid_actions: torch.Tensor  # int32 0-d
    black_wins: torch.Tensor  # int32 0-d
    white_wins: torch.Tensor  # int32 0-d
    ties: torch.Tensor  # int32 0-d


def init_metrics(device=None) -> RolloutMetrics:
    """Zero counters on ``device`` (``cuda`` unless named; raises without a
    card)."""
    dev = resolve_device(device)
    return RolloutMetrics(*(torch.zeros((), dtype=torch.int32, device=dev) for _ in RolloutMetrics._fields))


def update_metrics(m: RolloutMetrics, step_result) -> RolloutMetrics:
    """Fold one ``StepResult`` (of ``env.batch_env.batch_step``) into the
    counters.

    A game counts once, on the step that ended it: not when its env was
    already done at entry (frozen), nor when its action was rejected."""
    done = step_result.done
    newly_done = done & ~step_result.was_done & ~step_result.invalid_action
    reward = step_result.reward

    def count(x):
        return x.sum(dtype=torch.int32)

    return RolloutMetrics(
        env_steps=m.env_steps + done.shape[0],
        games_finished=m.games_finished + count(newly_done),
        stones_captured=m.stones_captured + count(step_result.num_captured),
        invalid_actions=m.invalid_actions + count(step_result.invalid_action),
        black_wins=m.black_wins + count(newly_done & (reward > 0)),
        white_wins=m.white_wins + count(newly_done & (reward < 0)),
        ties=m.ties + count(newly_done & (reward == 0)),
    )


def format_metrics(m: RolloutMetrics) -> str:
    """One log line (reads every counter on the host)."""
    v = {k: int(x) for k, x in m._asdict().items()}
    return (
        f"steps={v['env_steps']:,} games={v['games_finished']:,} "
        f"captures={v['stones_captured']:,} "
        f"B/W/T={v['black_wins']}/{v['white_wins']}/{v['ties']} "
        f"invalid={v['invalid_actions']}"
    )
