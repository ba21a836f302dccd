"""The batched product API: B Go games in lockstep (counterpart of
``gymgo_tpu.env.batch_env``).

The rollout is an eager Python loop over steps.  On the default path (uniform
sampler, carried atari/ko planes) a step makes no host sync: the sampler draws
on the device from a ``torch.Generator``, and the bundle flood's fixpoint loop
runs inside its CUDA kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gymgo_tpu_torch.config import HEURISTIC, REAL, EnvConfig
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step

__all__ = ["StepResult", "Rollout", "reward_from_areas", "batch_step", "rollout", "BatchGoEnv"]


class StepResult(NamedTuple):
    """Outputs of one batched step (all leading dim B)."""

    obs: torch.Tensor  # int8 (B, 6, N, N): post-step states
    reward: torch.Tensor  # float32 (B,): REAL/HEURISTIC reward, black's view
    done: torch.Tensor  # bool (B,): game over after this step
    invalid_action: torch.Tensor  # bool (B,): action was rejected (env frozen)
    was_done: torch.Tensor  # bool (B,): env was already finished at entry
    num_captured: torch.Tensor  # int32 (B,): stones captured by this step
    black_area: torch.Tensor  # int32 (B,): Trump-Taylor area (post-step state)
    white_area: torch.Tensor  # int32 (B,)


def reward_from_areas(black_area, white_area, done, config: EnvConfig) -> torch.Tensor:
    """Reward from the step's Trump-Taylor areas, float32 (B,).

    HEURISTIC pays the area difference every step and +/- N^2 at game end, a
    tie at game end counting as a loss (the reference's quirk)."""
    n = config.board_size
    kc = black_area.to(torch.float32) - white_area.to(torch.float32) - config.komi
    if config.reward_method == REAL:
        return torch.where(done, torch.sign(kc), 0.0)
    if config.reward_method == HEURISTIC:
        end_reward = torch.where(kc > 0, 1.0, -1.0) * (n * n)
        return torch.where(done, end_reward, kc)
    raise ValueError(config.reward_method)


def batch_step(states: torch.Tensor, actions: torch.Tensor, config: EnvConfig):
    """Batched transition: auto-reset (optional) -> move -> reward."""
    if config.auto_reset:
        done_pre = _state.game_ended(states)
        states = torch.where(done_pre[:, None, None, None], 0, states)
    new_states, info = _step.step_states(states, actions)
    done = _state.game_ended(new_states)
    reward = reward_from_areas(info.black_area, info.white_area, done, config)
    return new_states, StepResult(
        obs=new_states,
        reward=reward,
        done=done,
        invalid_action=info.invalid_action,
        was_done=info.was_done,
        num_captured=info.num_captured,
        black_area=info.black_area,
        white_area=info.white_area,
    )


class Rollout(NamedTuple):
    """A trajectory (leading dim T = num_steps)."""

    actions: torch.Tensor  # int32 (T, B)
    rewards: torch.Tensor  # float32 (T, B)
    dones: torch.Tensor  # bool (T, B)
    invalid: torch.Tensor  # bool (T, B): the step rejected the env's action
    final_states: torch.Tensor  # int8 (B, 6, N, N)
    obs: Optional[torch.Tensor] = None  # int8 (T, B, 6, N, N) when collected


def rollout(
    generator: torch.Generator,
    states: torch.Tensor,
    num_steps: int,
    config: EnvConfig,
    policy_fn: Optional[Callable] = None,
    collect_obs: bool = False,
) -> Rollout:
    """Roll ``num_steps`` lockstep moves from ``states`` (on their device).

    ``policy_fn(generator, states) -> actions`` defaults to uniform-random over
    valid moves.  With ``config.auto_reset`` finished games restart in place
    before the next move.  The carried atari/ko planes are seeded once; each
    step refreshes them from its own flood.
    """
    ps = _step.planes_from_states(states)
    ps = ps._replace(atari=_step.init_atari(ps), ko_surr=_step.init_ko_surr(ps))
    b = states.shape[0]
    dev = states.device
    acts_out = torch.empty((num_steps, b), dtype=torch.int32, device=dev)
    rewards = torch.empty((num_steps, b), dtype=torch.float32, device=dev)
    dones = torch.empty((num_steps, b), dtype=torch.bool, device=dev)
    invalid = torch.empty((num_steps, b), dtype=torch.bool, device=dev)
    obs = (
        torch.empty((num_steps,) + tuple(states.shape), dtype=torch.int8, device=dev)
        if collect_obs
        else None
    )
    for t in range(num_steps):
        if config.auto_reset:
            # Every plane is a fresh tensor owned by this loop, so zero the
            # finished envs in place (the carried planes too).
            reset = ps.done.clone()
            for x in ps:
                x.masked_fill_(reset.view((-1,) + (1,) * (x.dim() - 1)), 0)
        if policy_fn is None:
            acts = _actions.uniform_random_actions_planes(generator, ps)
        else:
            acts = policy_fn(generator, _step.states_from_planes(ps))
        ps, info = _step.step_planes(ps, acts)
        acts_out[t] = acts
        rewards[t] = reward_from_areas(info.black_area, info.white_area, ps.done, config)
        dones[t] = ps.done
        invalid[t] = info.invalid_action
        if collect_obs:
            obs[t] = _step.states_from_planes(ps)
    return Rollout(
        actions=acts_out,
        rewards=rewards,
        dones=dones,
        invalid=invalid,
        final_states=_step.states_from_planes(ps, states.dtype),
        obs=obs,
    )


class BatchGoEnv:
    """Stateful convenience wrapper around ``batch_step`` and ``rollout``.

    Runs on ``device`` (default ``cuda``; raises when there is no card)."""

    def __init__(self, config: EnvConfig, device=None):
        self.config = config
        self.device = _state.resolve_device(device)

    def reset(self) -> torch.Tensor:
        return _state.batch_init_state(
            self.config.batch_size, self.config.board_size, device=self.device
        )

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on this env's device, for the sampler."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def step(self, states: torch.Tensor, actions):
        return batch_step(states, torch.as_tensor(actions, device=self.device), self.config)

    def uniform_random_actions(self, generator, states):
        return _actions.uniform_random_actions(generator, states)

    def rollout(self, generator, states, num_steps: int, **kw) -> Rollout:
        return rollout(generator, states, num_steps, self.config, **kw)

    def valid_moves(self, states):
        return _actions.batch_valid_moves(states)

    def areas(self, states):
        return _score.areas(states)

    def winning(self, states):
        return _score.winning(states, self.config.komi)
