"""The batched product API: B Go games in lockstep (counterpart of
``gymgo_tpu.env.batch_env``).

The rollout is an eager Python loop over steps.  On the default path (uniform
sampler, carried atari/ko planes) a step makes no host sync: the sampler draws
on the device from a ``torch.Generator``, and the bundle flood's fixpoint loop
runs inside its CUDA kernel.  So ``BatchGoEnv`` captures a whole window into
one CUDA graph on the card (``utils.graphs``); ``batch_step`` and ``rollout``
themselves stay eager, as JAX's do (its wrapper jits them).  On a mesh (``gymgo_tpu_torch.parallel``) the
per-env work runs once per env shard (``shard_over_envs``) and the random
words are drawn for the whole batch, so a sharded rollout equals the
unsharded one from the same generator.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.core.flood import capturable
from gymgo_tpu_torch.core.score import reward_from_areas
from gymgo_tpu_torch.utils import tracing
from gymgo_tpu_torch.utils.graphs import compiled

__all__ = ["StepResult", "Rollout", "reward_from_areas", "batch_step", "shard_over_envs", "rollout",
           "BatchGoEnv"]


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


def batch_step(states: torch.Tensor, actions: torch.Tensor, config: EnvConfig):
    """Batched transition: auto-reset (optional) -> move -> reward."""
    if config.auto_reset:
        with tracing.span("env.reset"):
            done_pre = _state.game_ended(states)
            states = torch.where(done_pre[:, None, None, None], 0, states)
    with tracing.span("env.step"):
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


def _tree_map(fn, tree):
    """``fn`` on every tensor of ``tree``: a tensor, or a (named) tuple of
    trees; ``None`` and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_tree_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _tree_concat(trees, dim=0):
    """The trees of ``trees`` (one structure) joined leaf by leaf on ``dim``,
    on the first tree's devices."""
    first = trees[0]
    if len(trees) == 1:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat([x.to(first.device) for x in trees], dim=dim)
    if isinstance(first, tuple):
        items = [_tree_concat([t[i] for t in trees], dim) for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    return first


def shard_over_envs(fn: Callable, mesh, concat: Optional[bool] = None) -> Callable:
    """Run ``fn`` (per-env semantics, every tensor argument and result batched
    on the leading env dim) once per env shard this process owns, on that
    shard's rows and device.

    An argument is either the list of this process's shards, taken as they
    are, or a global tensor (or a named tuple of them; ``None`` fields pass
    through) of which each shard takes its rows, moved to its device (a view
    when they lie there already).  The results are concatenated in shard
    order when the mesh is local (on the first shard's device) and left as
    the list of local shards' results when it spans processes; ``concat``
    overrides that.

    The per-shard calls make no collective: the flood kernels launch once
    per shard on the shard's contiguous rows, and on the CPU a shard's
    convergence checks (``core.flood.flood_or``) are its own.
    """
    join = mesh.is_local if concat is None else concat
    local = mesh.local_shards()

    def run(*args):
        outs = []
        for j, (i, dev) in enumerate(local):
            shard_args = []
            for arg in args:
                if isinstance(arg, list):
                    shard_args.append(arg[j])
                else:
                    shard_args.append(_tree_map(lambda x: x[mesh.rows(i, x.shape[0])].to(dev), arg))
            outs.append(fn(*shard_args))
        return _tree_concat(outs) if join else outs

    return run


def rollout(
    generator: torch.Generator,
    states,
    num_steps: int,
    config: EnvConfig,
    policy_fn: Optional[Callable] = None,
    collect_obs: bool = False,
    mesh=None,
) -> Rollout:
    """Roll ``num_steps`` lockstep moves from ``states`` (on their device).

    ``policy_fn(generator, states) -> actions`` defaults to uniform-random over
    valid moves.  With ``config.auto_reset`` finished games restart in place
    before the next move.  The carried atari/ko planes are seeded once per
    call; each step refreshes them from its own flood.  Each step is
    ``core.step.step_window_row``, which writes the step's rows of the
    window (on the card, ``ops.env_step``'s kernels around the bundle flood,
    one of which resets the finished games and samples).

    With ``mesh`` set, ``states`` is the global batch or this process's list
    of shards (without one, a mesh of one shard on ``states``' device), and
    the per-env work runs under ``shard_over_envs``: seeding,
    auto-reset, the move and the reward, once per shard.  The sampler's words
    are drawn for the whole batch from ``generator`` and sliced per shard, as
    a (B,) draw is positional: drawn per shard it would change with the
    sharding.  ``policy_fn`` then sees the rows of this process (all rows on
    a local mesh), concatenated.  The outputs are global on a local mesh and
    lists of this process's shards when the mesh spans processes.
    """
    sample = policy_fn is None
    # GYMGO_ABLATE=sampler: every action 0, nothing drawn (the sampler's cost
    # taken out of the step; results wrong by design)
    no_sampler = sample and "sampler" in _step.ablate
    draw = sample and not no_sampler

    def move(ps, x, out, t):
        """Step one shard and write its rows ``t`` of ``out``."""
        return _step.step_window_row(ps, x, out, t, config, words=draw, reset=draw and config.auto_reset)

    if mesh is None:
        from gymgo_tpu_torch.parallel.mesh import local_mesh

        mesh = local_mesh(states.device)
    batch, join = mesh.global_batch(states), mesh.is_local
    shards = shard_over_envs(_step.seed_planes, mesh, concat=False)(states)
    move_all = shard_over_envs(move, mesh, concat=False)
    dtype = (states[0] if isinstance(states, list) else states).dtype
    outs = []
    for ps in shards:
        b, dev = ps.done.shape[0], ps.done.device
        outs.append((
            torch.empty((num_steps, b), dtype=torch.int32, device=dev),
            torch.empty((num_steps, b), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b), dtype=torch.bool, device=dev),
            torch.empty((num_steps, b), dtype=torch.bool, device=dev),
            torch.empty((num_steps, b, govars.NUM_CHNLS) + tuple(ps.black.shape[1:]), dtype=torch.int8,
                        device=dev) if collect_obs else None,
        ))
    for t in range(num_steps):
        if config.auto_reset and not draw:  # with the sampler's words the step resets (step_window_row)
            with tracing.span("env.reset"):
                for ps in shards:
                    _step.reset_finished(ps)
        if no_sampler:
            x = [torch.zeros(ps.done.shape, dtype=torch.int32, device=ps.done.device) for ps in shards]
        elif sample:
            with tracing.span("env.sampler"):
                x = _actions.draw_words(generator, (batch,), generator.device)
        else:
            local = [_step.states_from_planes(ps) for ps in shards]
            acts = policy_fn(generator, _tree_concat(local))
            x = list(torch.split(acts, [len(s) for s in local]))
            x = [a.to(s.device) for a, s in zip(x, local)]
        shards = move_all(shards, x, outs, t)
    fields = list(zip(*(
        Rollout(actions=o[0], rewards=o[1], dones=o[2], invalid=o[3],
                final_states=_step.states_from_planes(ps, dtype), obs=o[4])
        for o, ps in zip(outs, shards))))
    if not join:
        return Rollout(*(None if f[0] is None else list(f) for f in fields))
    return Rollout(*(_tree_concat(list(f), dim=0 if name == "final_states" else 1)
                     for name, f in zip(Rollout._fields, fields)))


class BatchGoEnv:
    """Stateful convenience wrapper around ``batch_step`` and ``rollout``,
    with their compiled forms (as the JAX package's ``BatchGoEnv`` jits them).

    Runs on ``device`` (default ``cuda``; raises when there is no card).  On
    the card ``step``, ``rollout`` and ``uniform_random_actions`` replay CUDA
    graphs (``utils.graphs.compiled``): the first call of each key runs
    eagerly and captures, later ones replay.  ``rollout`` is keyed on
    ``num_steps``, ``policy_fn`` and ``collect_obs``, as JAX's
    ``static_argnames`` are, and a whole window of ``num_steps`` steps is one
    graph, as it is one ``lax.scan`` there.  A ``policy_fn`` must be a
    function of its ``(generator, states)`` on the card with no host sync (a
    sync makes the capture raise; host state read inside it would be baked
    into the graph: hand such a policy to the plain ``rollout``).

    ``compiled`` says whether the graphs are used: it is false on the CPU and
    on boards over 181x181 (``core.flood.capturable``), and there the methods
    run the eager functions.
    """

    def __init__(self, config: EnvConfig, device=None):
        self.config = config
        self.device = _state.resolve_device(device)
        self._step = compiled(functools.partial(batch_step, config=config))
        self._rollout = compiled(functools.partial(rollout, config=config),
                                 static_argnames=("num_steps", "policy_fn", "collect_obs"))
        self._random_actions = compiled(_actions.uniform_random_actions)

    @property
    def compiled(self) -> bool:
        """True when ``step``, ``rollout`` and ``uniform_random_actions``
        replay CUDA graphs: on the card, at a board size the card's kernels
        take (``core.flood.capturable``)."""
        return self.device.type == "cuda" and capturable(self.config.board_size)

    def reset(self) -> torch.Tensor:
        return _state.batch_init_state(
            self.config.batch_size, self.config.board_size, device=self.device
        )

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on this env's device, for the sampler."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def step(self, states: torch.Tensor, actions):
        actions = torch.as_tensor(actions, device=self.device)
        if self.compiled:
            return self._step(states, actions)
        return batch_step(states, actions, self.config)

    def uniform_random_actions(self, generator, states):
        if self.compiled:
            return self._random_actions(generator, states)
        return _actions.uniform_random_actions(generator, states)

    def rollout(self, generator, states, num_steps: int, **kw) -> Rollout:
        if self.compiled:
            return self._rollout(generator, states, num_steps, **kw)
        return rollout(generator, states, num_steps, self.config, **kw)

    def valid_moves(self, states):
        return _actions.batch_valid_moves(states)

    def areas(self, states):
        return _score.areas(states)

    def winning(self, states):
        return _score.winning(states, self.config.komi)
