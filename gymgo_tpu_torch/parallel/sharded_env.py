"""Env-sharded batched Go env: thousands of games spread over the shards of a
mesh (counterpart of ``gymgo_tpu.parallel.sharded_env``).

The step and the rollout run one call per env shard (``shard_over_envs``) and
make no collective; only the user-level reductions of ``checksums`` and
``gather_states`` cross processes.  On the card each process captures its own
shards' step and rollout into one CUDA graph (``utils.graphs``), as the JAX
package jits them.
"""

from __future__ import annotations

import functools

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.env import batch_env as _batch_env
from gymgo_tpu_torch.parallel import mesh as _mesh
from gymgo_tpu_torch.utils.graphs import capturable, compiled

__all__ = ["ShardedGoEnv"]


def _shards(x) -> list:
    """This process's shards of a rollout's output or a state batch."""
    return x if isinstance(x, list) else [x]


def _uniform_actions(states, word):
    return _actions.uniform_from_words(word, states[:, govars.INVD_CHNL].reshape(states.shape[0], -1) == 0)


class ShardedGoEnv:
    """``BatchGoEnv`` whose state batch lives sharded over a mesh.

    ``config.batch_size`` is the *global* env count and must divide evenly
    over the mesh's env axis.  ``step`` and ``rollout`` take the global batch
    or this process's list of shards (``reset``'s); their results are global
    on a local mesh and this process's shards when the mesh spans processes
    (``step`` then returns the list of states and the list of
    ``StepResult``\\ s).

    On the card ``step`` and ``rollout`` replay CUDA graphs, one per process
    over all of its shards (``rollout`` keyed as ``BatchGoEnv.rollout`` is):
    the per-shard work makes no collective, and the sampler's words are still
    drawn once for the whole batch inside the graph.  ``compiled`` is false,
    and the eager functions run, on the CPU, on boards over the route's
    kernels' size (``utils.graphs.capturable``), and where this process's
    shards lie on more than one card (a graph runs on one).
    """

    def __init__(self, config: EnvConfig, mesh: _mesh.Mesh | None = None):
        self.config = config
        self.mesh = mesh if mesh is not None else _mesh.make_mesh()
        env_axis = self.mesh.shape[_mesh.ENV_AXIS]
        if config.batch_size % env_axis != 0:
            raise ValueError(f"batch_size {config.batch_size} not divisible by env axis {env_axis}")
        self._eager_step = _batch_env.shard_over_envs(functools.partial(_batch_env.batch_step, config=config),
                                                      self.mesh)
        self._eager_rollout = functools.partial(_batch_env.rollout, config=config, mesh=self.mesh)
        self._step = compiled(self._eager_step)
        self._rollout = compiled(self._eager_rollout, static_argnames=("num_steps", "policy_fn", "collect_obs"))
        self._actions = _batch_env.shard_over_envs(_uniform_actions, self.mesh)
        devices = {dev for _, dev in self.mesh.local_shards()}
        self._device = devices.pop() if len(devices) == 1 else None

    @property
    def compiled(self) -> bool:
        """True when ``step`` and ``rollout`` replay CUDA graphs: this
        process's shards on one card, at a board size the route's kernels
        take."""
        return (self._device is not None and self._device.type == "cuda"
                and capturable(self.config.board_size))

    def reset(self) -> list:
        """Fresh boards: this process's shards, each made on its device."""
        rows = self.config.batch_size // self.mesh.shape[_mesh.ENV_AXIS]
        return [_state.batch_init_state(rows, self.config.board_size, device=dev)
                for _, dev in self.mesh.local_shards()]

    def step(self, states, actions):
        """One ``batch_step`` per shard; ``actions`` is the global (B,) batch."""
        if self.compiled:
            out = self._step(states, torch.as_tensor(actions, dtype=torch.int32, device=self._device))
        else:
            out = self._eager_step(states, torch.as_tensor(actions, dtype=torch.int32))
        if isinstance(out, list):
            return [o[0] for o in out], [o[1] for o in out]
        return out

    def rollout(self, generator: torch.Generator, states, num_steps: int, **kw) -> _batch_env.Rollout:
        run = self._rollout if self.compiled else self._eager_rollout
        return run(generator, states, num_steps, **kw)

    def uniform_random_actions(self, generator: torch.Generator, states):
        """The uniform sampler on the sharded batch: one word per env drawn for
        the whole batch, so the actions do not depend on the sharding."""
        word = _actions.draw_words(generator, (self.mesh.global_batch(states),), generator.device)
        return self._actions(states, word)

    def checksums(self, r: _batch_env.Rollout) -> dict:
        """The sums of the rollout's final states, actions and rewards over
        the global batch, the same on every rank.  Summed in float64, which
        holds them exactly (integer states and actions; rewards that are
        integers or halves, far below 2^53), so the order of the sum and the
        number of ranks do not change them."""
        sums = torch.zeros(3, dtype=torch.float64)
        for fs, acts, rew in zip(_shards(r.final_states), _shards(r.actions), _shards(r.rewards)):
            sums += torch.stack([fs.sum(dtype=torch.int64).double(), acts.sum(dtype=torch.int64).double(),
                                 rew.sum(dtype=torch.float64)]).cpu()
        if not self.mesh.is_local:
            sums = _mesh.all_reduce_sum(sums)
        return {"state_checksum": int(sums[0]), "action_checksum": int(sums[1]), "reward_checksum": float(sums[2])}

    def gather_states(self, states) -> torch.Tensor:
        """The global state batch on the host, on every rank (an all-gather
        when the mesh spans processes; every rank must call it): what a
        checkpoint stores."""
        local = torch.cat([s.cpu() for s in _shards(states)])
        if self.mesh.is_local:
            return local
        return _mesh.all_gather_rows(local)
