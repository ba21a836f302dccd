"""Batched self-play: net-guided rollouts that make AZ training rows
(counterpart of ``gymgo_tpu.rl.selfplay``).

Each row is a canonical pre-move observation, a policy target and the
outcome z of the row's own game from the mover's view.  Action selection masks
invalid moves with the env's own INVD channel, so generated games are legal.
One move of a window (reset, choose, record, step, and the PUCT mode's tree
carried to the next move) is one CUDA graph on the card, the body of the JAX
package's ``lax.scan`` (``_move``, ``utils.graphs.compiled``; the search
inside it runs inline, so its kernels join the move's graph): the Python
loop over the window replays it once a move and writes its rows into
preallocated ``(T, B, ...)`` tensors; the value targets are computed once a
window, eagerly.  A window keeps one graph per mode, net, configuration,
batch and search setting, and a move makes no host sync.  Boards over the
route's kernels' size (22x22 on the bundle route, 181x181 on the minmax route)
run the move eagerly (``utils.graphs.capturable``).

Every draw the JAX package takes from a key can be handed in instead
(``gumbel``, ``dirichlet``, ``orientations``), one row per step of the window,
so that tests give both packages the same noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import transform as _transform
from gymgo_tpu_torch.env import batch_env as _batch_env
from gymgo_tpu_torch.utils.graphs import capturable, compiled

__all__ = [
    "SelfPlayBatch",
    "per_game_value_targets",
    "grounded_rows",
    "net_value_black",
    "policy_actions",
    "selfplay_rollout",
    "selfplay_search_rollout",
    "selfplay_gumbel_rollout",
    "selfplay_mcts_rollout",
    "augment_symmetries",
]


class SelfPlayBatch(NamedTuple):
    """Self-play data of one window (leading dims T, B)."""

    obs: torch.Tensor  # int8 (T, B, 6, N, N): canonical pre-move states
    policy_target: torch.Tensor  # float32 (T, B, N*N+1)
    value_target: torch.Tensor  # float32 (T, B): game outcome, mover's view
    mask: torch.Tensor  # bool (T, B): step was part of a live game
    mover_white: torch.Tensor  # bool (T, B): white made this move
    done: torch.Tensor  # bool (T, B): game ended AT this step
    grounded: torch.Tensor  # bool (T, B): this row's game ENDS inside the
    # window, so its value target is a real terminal outcome (the complement
    # is the truncated tail: an area-sign estimate or a bootstrap)
    actions: torch.Tensor  # int32 (T, B): the move played (not in the JAX batch)
    invalid: torch.Tensor  # bool (T, B): the step rejected it (not in the JAX batch)


def per_game_value_targets(done, sign, final_states, mover_white, komi, z_final=None):
    """Per-step game outcomes across auto-reset game boundaries.

    With auto-reset one window spans several games per env.  Each step's
    target is the outcome of its OWN game: a reverse loop over T back-fills
    the terminal sign recorded at each game's ending step; steps of the
    window's truncated last game take ``z_final``, by default the current
    winner sign of the final state (one area score).

    ``z_final`` (B,) from BLACK's view may be passed instead: ``net_value_black``
    of a FROZEN target network gives the bootstrap.  Bootstrapping from the
    online net makes the constant-zero value function a fixed point of the
    update when most windows hold no game end (a measured collapse in the JAX
    package, BENCHMARKS.md).

    done, sign: (T, B) post-step done flags and terminal outcome signs from
    black's view (read where done).  Returns (T, B) value targets from each
    step's mover's view."""
    if z_final is None:
        z_final = _score.winning(final_states, komi)
    z = z_final.to(torch.float32)
    z_black = torch.empty(done.shape, dtype=torch.float32, device=done.device)
    for t in range(done.shape[0] - 1, -1, -1):
        z = torch.where(done[t], sign[t], z)
        z_black[t] = z
    return torch.where(mover_white, -z_black, z_black)


def grounded_rows(done: torch.Tensor) -> torch.Tensor:
    """bool (T, B): a game of this env ends at this step or later in the
    window (the reversed cumulative sum of ``done``)."""
    return done.to(torch.int32).flip(0).cumsum(0).flip(0) > 0


def net_value_black(final_states, net):
    """The net's value of ``final_states`` from BLACK's view (the truncated-game
    estimate for ``per_game_value_targets``)."""
    _, v = net(_transform.batch_canonical_form(final_states))
    return torch.where(_state.turn(final_states) == 1, -v, v)


def _reset_done(st, config: EnvConfig):
    """Reset finished envs before the action is chosen, so the policy sees the
    board the action lands on (``batch_step`` alone resets after the choice)."""
    if not config.auto_reset:
        return st
    return torch.where(_state.game_ended(st)[:, None, None, None], 0, st)


def _outcome_sign(res, komi):
    """Terminal outcome sign from black's view, from the step's own areas
    (meaningful where ``res.done``)."""
    return torch.sign(res.black_area.to(torch.float32) - res.white_area.to(torch.float32) - komi)


def policy_actions(generator, states, net, temperature=1.0, pass_min_stones: int = 0, gumbel=None):
    """Sample actions from the net's masked policy over canonical states:
    the argmax of the masked logits / temperature plus Gumbel noise (JAX's
    ``random.categorical``).  ``gumbel`` float32 (B, N*N+1) is drawn from
    ``generator`` unless given.  Returns ``(actions int32, masked logits)``."""
    logits, _ = net(_transform.batch_canonical_form(states))
    valid = _actions.batch_valid_moves(states) > 0
    valid = _actions.mask_early_pass(valid, states, pass_min_stones)
    masked = torch.where(valid, logits / max(temperature, 1e-6), -torch.inf)
    if gumbel is None:
        gumbel = _actions.gumbel_noise(generator, masked.shape, masked.device)
    return (masked + gumbel.to(masked.device)).argmax(dim=-1).to(torch.int32), masked


def _row(noise, t):
    return None if noise is None else noise[t]


def _move(generator, st, noise, warm, net, config: EnvConfig, act: Callable, settings: tuple):
    """One move of a window: reset finished envs, choose ``act(generator, st,
    net, noise, warm, komi, **settings) -> (actions, policy_target, carry)``,
    record, step, and carry the search's tree (``carry(actions, keep)``, or
    None) to the next move.  Returns ``(next_states, rows, next_warm)``; the
    rows are the move's obs, policy target, mask, mover_white, done,
    actions, invalid and outcome sign."""
    st = _reset_done(st, config)
    acts, target, carry = act(generator, st, net, noise, warm, config.komi, **dict(settings))
    live = ~_state.game_ended(st)
    new_st, res = _batch_env.batch_step(st, acts, config)
    if carry is not None:
        # invalid when this root was already done (auto-reset replaced the
        # board the tree stepped) or the game just ended
        warm = carry(acts, live & ~_state.game_ended(new_st))
    rows = (_transform.batch_canonical_form(st), target, live, _state.turn(st) == 1, res.done, acts,
            res.invalid_action, _outcome_sign(res, config.komi))
    return new_st, rows, warm


_move = compiled(_move, static_argnames=("net", "config", "act", "settings"),
                 when=lambda a: capturable(a["config"].board_size))


def _window(generator, states, num_steps: int, config: EnvConfig, net, act: Callable, settings: dict,
            value_bootstrap: bool, target_net, noise: tuple, warm=None):
    """The loop every self-play mode shares: one ``_move`` a step (``noise``
    a tuple of the mode's (T, B, ...) draws, each None where the generator
    draws it, sliced per move; ``warm`` the search's first carried tree),
    its rows written into the window's tensors; then the value targets."""
    b = states.shape[0]
    dev = states.device
    a_size = config.board_size ** 2 + 1
    out = dict(
        obs=torch.empty((num_steps,) + tuple(states.shape), dtype=torch.int8, device=dev),
        policy_target=torch.empty((num_steps, b, a_size), dtype=torch.float32, device=dev),
        mask=torch.empty((num_steps, b), dtype=torch.bool, device=dev),
        mover_white=torch.empty((num_steps, b), dtype=torch.bool, device=dev),
        done=torch.empty((num_steps, b), dtype=torch.bool, device=dev),
        actions=torch.empty((num_steps, b), dtype=torch.int32, device=dev),
        invalid=torch.empty((num_steps, b), dtype=torch.bool, device=dev),
    )
    sign = torch.empty((num_steps, b), dtype=torch.float32, device=dev)
    dests = (out["obs"], out["policy_target"], out["mask"], out["mover_white"], out["done"], out["actions"],
             out["invalid"], sign)
    settings = tuple(sorted(settings.items()))
    st = states
    for t in range(num_steps):
        st, rows, warm = _move(generator, st, tuple(_row(x, t) for x in noise), warm, net=net, config=config,
                               act=act, settings=settings)
        for dest, x in zip(dests, rows):
            dest[t] = x
    zf = net_value_black(st, net if target_net is None else target_net) if value_bootstrap else None
    z = per_game_value_targets(out["done"], sign, st, out["mover_white"], config.komi, z_final=zf)
    return st, SelfPlayBatch(value_target=z, grounded=grounded_rows(out["done"]), **out)


def _act_policy(generator, st, net, noise, warm, komi, temperature, pass_min_stones):
    acts, masked = policy_actions(generator, st, net, temperature, pass_min_stones, noise[0])
    return acts, torch.softmax(masked, dim=-1), None


def _act_oneply(generator, st, net, noise, warm, komi, **kw):
    from gymgo_tpu_torch.rl.search import gumbel_oneply

    res = gumbel_oneply(generator, st, net, komi=komi, gumbel=noise[0], **kw)
    return res.actions, res.improved_policy, None


def _act_gumbel(generator, st, net, noise, warm, komi, **kw):
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts

    res = run_gumbel_mcts(generator, st, net, komi=komi, gumbel=noise[0], **kw)
    return res.actions, res.improved_policy, None


def _act_puct(generator, st, net, noise, warm, komi, **kw):
    """PUCT with the reuse ``warm`` says: None (off), ``(visit, wsum)`` of
    the root (``"root"``) or an ``MCTSTree`` (``"subtree"``, compacted to its
    own slot count)."""
    from gymgo_tpu_torch.rl.mcts import MCTSTree, compact_subtree, empty_tree, played_child_stats, run_mcts

    subtree = isinstance(warm, MCTSTree)
    warm_kw = {} if warm is None else {"warm_tree": warm} if subtree else {"warm_root": warm}
    res, tree = run_mcts(generator, st, net, komi=komi, return_tree=True, dirichlet=noise[0], gumbel=noise[1],
                         **warm_kw, **kw)

    def carry(acts, keep):
        if not subtree:
            wv, ww = played_child_stats(tree, acts)
            return torch.where(keep[:, None], wv, 0), torch.where(keep[:, None], ww, 0.0)
        b, r_cap = warm.prior.shape[:2]
        cold = empty_tree(b, r_cap, warm.prior.shape[2], st.shape[1:], st.dtype, device=st.device)
        return MCTSTree(*(torch.where(keep.view((-1,) + (1,) * (x.dim() - 1)), x, c)
                          for x, c in zip(compact_subtree(tree, acts, r_cap), cold)))

    return res.actions, res.visit_policy, None if warm is None else carry


@torch.no_grad()
def selfplay_rollout(generator, states, net, num_steps: int, config: EnvConfig, temperature: float = 1.0,
                     pass_min_stones: int = 0, value_bootstrap: bool = False, target_net=None, gumbel=None):
    """``num_steps`` of net-guided self-play from ``states``: actions sampled
    from the net's masked policy, which is also the policy target.

    There is no policy-improvement operator in this mode, and trained nets
    collapse toward always-pass; use a search rollout for AZ learning.  This
    is the cheap data-generation baseline.  ``gumbel`` (T, B, A) is the
    sampling noise; ``target_net`` the frozen network of ``value_bootstrap``."""
    return _window(generator, states, num_steps, config, net, _act_policy,
                   dict(temperature=temperature, pass_min_stones=pass_min_stones), value_bootstrap, target_net,
                   noise=(gumbel,))


@torch.no_grad()
def selfplay_search_rollout(generator, states, net, num_steps: int, config: EnvConfig, num_sampled: int = 16,
                            c_q: float = 1.0, pass_min_stones: int = 0, value_bootstrap: bool = False,
                            target_net=None, gumbel=None):
    """Self-play driven by the one-ply Gumbel lookahead (``rl.search``): the
    policy targets are the search-improved distributions."""
    return _window(generator, states, num_steps, config, net, _act_oneply,
                   dict(num_sampled=num_sampled, c_q=c_q, pass_min_stones=pass_min_stones), value_bootstrap,
                   target_net, noise=(gumbel,))


@torch.no_grad()
def selfplay_gumbel_rollout(generator, states, net, num_steps: int, config: EnvConfig, num_simulations: int = 32,
                            max_considered: int = 16, pass_min_stones: int = 0, value_bootstrap: bool = False,
                            target_net=None, gumbel=None, **gumbel_kw):
    """Gumbel-AZ self-play: sequential-halving search actions with
    completed-Q improved-policy targets (``rl.gumbel_mcts``), a policy
    improvement operator even at small simulation budgets.  ``gumbel``
    (T, B, A) is each move's root noise."""
    return _window(generator, states, num_steps, config, net, _act_gumbel,
                   dict(num_simulations=num_simulations, max_considered=max_considered,
                        pass_min_stones=pass_min_stones, **gumbel_kw),
                   value_bootstrap, target_net, noise=(gumbel,))


@torch.no_grad()
def selfplay_mcts_rollout(generator, states, net, num_steps: int, config: EnvConfig, num_simulations: int = 32,
                          tree_reuse=False, reuse_cap: int | None = None, pass_min_stones: int = 0,
                          value_bootstrap: bool = False, target_net=None, dirichlet=None, gumbel=None,
                          **mcts_kw):
    """Full-AZ self-play: PUCT search actions with visit-count policy targets
    (``rl.mcts``).

    ``tree_reuse`` carries search effort across plies: ``"root"`` (or True)
    the played root child's (visit, wsum) statistics; ``"subtree"`` the whole
    played subtree, compacted to ``reuse_cap`` nodes (default
    ``num_simulations``).  Reuse is dropped for envs whose game ended.  Extra
    ``mcts_kw`` (e.g. ``num_parallel``) go to ``run_mcts``; ``dirichlet`` and
    ``gumbel`` (T, B, A) are each move's root noise and pick noise."""
    from gymgo_tpu_torch.rl.mcts import empty_tree

    mode = {False: "off", True: "root"}.get(tree_reuse, tree_reuse)
    if mode not in ("off", "root", "subtree"):
        raise ValueError(f"tree_reuse: {tree_reuse!r}")
    b, dev = states.shape[0], states.device
    a_size = config.board_size ** 2 + 1
    r_cap = reuse_cap if reuse_cap is not None else num_simulations
    if mode == "subtree":
        warm = empty_tree(b, r_cap, a_size, states.shape[1:], states.dtype, device=dev)
    elif mode == "root":
        warm = (torch.zeros((b, a_size), dtype=torch.int32, device=dev),
                torch.zeros((b, a_size), dtype=torch.float32, device=dev))
    else:
        warm = None
    return _window(generator, states, num_steps, config, net, _act_puct,
                   dict(num_simulations=num_simulations, pass_min_stones=pass_min_stones, **mcts_kw),
                   value_bootstrap, target_net, noise=(dirichlet, gumbel), warm=warm)


def _symmetry_sources(n: int, device) -> torch.Tensor:
    """int64 (8, N*N): ``apply_symmetry(x, o).flatten() == x.flatten()[src[o]]``."""
    cells = torch.arange(n * n, device=device).view(n, n)
    return torch.stack([_transform.apply_symmetry(cells, o).reshape(-1) for o in range(8)])


def augment_symmetries(generator, obs: torch.Tensor, policy: torch.Tensor, orientations=None):
    """A random dihedral symmetry per sample applied to (obs, policy) pairs,
    as ``core.transform.apply_symmetry`` orients a board; the pass entry is
    kept.  obs (M, 6, N, N), policy (M, N*N+1).  ``orientations`` (M,) in
    [0, 8) are drawn from ``generator`` unless given."""
    m, c, n = obs.shape[0], obs.shape[1], obs.shape[-1]
    if orientations is None:
        orientations = torch.randint(0, 8, (m,), generator=generator, device=obs.device)
    src = _symmetry_sources(n, obs.device)[orientations.to(device=obs.device, dtype=torch.int64)]  # (M, N*N)
    obs2 = obs.reshape(m, c, n * n).gather(2, src[:, None, :].expand(m, c, n * n)).view(obs.shape)
    board = policy[:, : n * n].gather(1, src)
    return obs2, torch.cat([board, policy[:, n * n:]], dim=1)
