"""Batched MCTS with exact environment dynamics, PUCT selection
(counterpart of ``gymgo_tpu.rl.mcts``).

The simulator is the env step itself, so tree nodes hold real board states
and an expansion is one exact ``step_states`` call (two launches of the bundle
kernel on CUDA tensors).  ``num_simulations`` rounds of select -> expand ->
evaluate -> backup run over fixed-shape tree tensors, batched across envs.

Tree layout (per env): node 0 is the root; wave w's k-th path expands into
slot ``R + w * K + k`` (R = 1, or the warm tree's slot count).  Per
(node, action) statistics N / W / P drive PUCT; values are stored from the
node mover's view and flip sign at every ply of the backup.

On CUDA tensors ``run_mcts`` and ``compact_subtree`` each replay a CUDA
graph, the counterpart of the JAX package's ``lax.fori_loop`` over the waves
under ``jax.jit`` (``utils.graphs.compiled``): a search is keyed by the net
(by identity), the simulation counts, the constants and ``return_tree``, and
replayed with the states, the generator, the noise and the warm statistics
or tree copied in; ``compact_subtree`` by ``reuse_cap``.  Boards over the
route's kernels' size (22x22 on the bundle route, 181x181 on the minmax route)
search eagerly (``utils.graphs.capturable``); ``.fn`` is the eager function.

Ties break as in JAX (first-of-equals argmax, ``rl.treewalk``), so with the
same Dirichlet and pick noise both packages grow the same trees.  Output: the
visit-count policy at the root (the AZ training target) and the root value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.core import transform as _transform
from gymgo_tpu_torch.rl import treewalk as _treewalk
from gymgo_tpu_torch.utils.graphs import capturable_states, compiled

__all__ = [
    "MCTSResult",
    "MCTSTree",
    "empty_tree",
    "compact_subtree",
    "played_child_stats",
    "dirichlet_noise",
    "run_mcts",
    "make_mcts_policy",
]


class MCTSResult(NamedTuple):
    actions: torch.Tensor  # int32 (B,): sampled from the visit policy
    visit_policy: torch.Tensor  # float32 (B, A): normalized root visit counts
    root_value: torch.Tensor  # float32 (B,): mean root action value
    root_visits: torch.Tensor  # int32 (B, A)


class MCTSTree(NamedTuple):
    """One search tree per env, returned by ``run_mcts(..., return_tree=True)``
    for reuse across moves: the root child's statistics
    (``played_child_stats``) or the whole played subtree (``compact_subtree``
    -> ``run_mcts(warm_tree=...)``)."""

    node_states: torch.Tensor  # int8 (B, M, 6, N, N)
    node_done: torch.Tensor  # bool (B, M)
    prior: torch.Tensor  # float32 (B, M, A)
    visit: torch.Tensor  # int32 (B, M, A)
    wsum: torch.Tensor  # float32 (B, M, A)
    child: torch.Tensor  # int32 (B, M, A), -1 = unexpanded
    parent: torch.Tensor  # int32 (B, M), -1 = root / unused slot


def empty_tree(b: int, r: int, a_size: int, state_shape, dtype=torch.int8, device=None) -> MCTSTree:
    """An all-cold warm tree of R slots: zero statistics, no edges.  As
    ``warm_tree`` it searches as a cold tree does (``run_mcts`` re-seeds the
    root row)."""
    dev = _state.resolve_device(device)
    return MCTSTree(
        node_states=torch.zeros((b, r) + tuple(state_shape), dtype=dtype, device=dev),
        node_done=torch.zeros((b, r), dtype=torch.bool, device=dev),
        prior=torch.zeros((b, r, a_size), dtype=torch.float32, device=dev),
        visit=torch.zeros((b, r, a_size), dtype=torch.int32, device=dev),
        wsum=torch.zeros((b, r, a_size), dtype=torch.float32, device=dev),
        child=torch.full((b, r, a_size), -1, dtype=torch.int32, device=dev),
        parent=torch.full((b, r), -1, dtype=torch.int32, device=dev),
    )


def compact_subtree(tree: MCTSTree, actions: torch.Tensor, reuse_cap: int) -> MCTSTree:
    """The subtree under the played child, in ``reuse_cap`` slots with the
    new root at slot 0.

    Slots fill in expansion order, so a child's index exceeds its parent's.
    Membership comes from pointer doubling up the parent chain (O(log M)
    gathers); the renumbering keeps old-index order, so the cut at the cap is
    ancestry-closed.  Edges into dropped nodes keep their statistics and lose
    the child pointer (they re-expand on demand).  An env whose played edge
    was never expanded comes back cold."""
    b, m, a_size = tree.prior.shape
    r = reuse_cap
    dev = tree.prior.device
    bidx = torch.arange(b, device=dev)
    iota = torch.arange(m, dtype=torch.int32, device=dev)[None, :]

    new_root = tree.child[bidx, 0, actions.to(torch.int64)]  # (B,), -1 = cold
    has = new_root >= 0
    root_safe = new_root.clamp_min(0)[:, None]

    # keep[j]: j is the new root or below it.  After k rounds keep[j] holds
    # iff the root is within 2^k ancestor hops: each round ORs in the flag of
    # the current 2^k-hop ancestor, then doubles the hop.
    keep = iota == root_safe
    jump = tree.parent
    hops = 1
    while hops < m:
        js = jump.clamp_min(0).to(torch.int64)
        keep = keep | (keep.gather(1, js) & (jump >= 0))
        jump = torch.where(jump >= 0, jump.gather(1, js), -1)
        hops *= 2
    keep = keep & has[:, None]

    # renumber: root -> 0, other kept nodes in old-index order; drop past the cap
    rank = (keep & (iota != root_safe)).to(torch.int32).cumsum(1, dtype=torch.int32)
    newidx = torch.where(iota == root_safe, 0, rank)
    final_keep = keep & (newidx < r)

    # perm[new] = old, scattered through a dump slot r for dropped nodes
    perm = torch.full((b, r + 1), -1, dtype=torch.int32, device=dev)
    perm.scatter_(1, torch.where(final_keep, newidx, r).to(torch.int64), iota.expand(b, m).contiguous())
    perm = perm[:, :r]
    live = perm >= 0
    psafe = perm.clamp_min(0).to(torch.int64)

    def take(x, fill):
        g = x[bidx[:, None], psafe]
        return torch.where(live.view((b, r) + (1,) * (g.dim() - 2)), g, fill)

    old2new = torch.where(final_keep, newidx, -1)
    child_old = take(tree.child, -1)
    child_new = torch.where(
        child_old >= 0,
        old2new.gather(1, child_old.clamp_min(0).reshape(b, -1).to(torch.int64)).view(b, r, a_size),
        -1,
    )
    parent_old = take(tree.parent, -1)
    parent_new = torch.where(parent_old >= 0, old2new.gather(1, parent_old.clamp_min(0).to(torch.int64)), -1)
    return MCTSTree(
        node_states=take(tree.node_states, 0),
        node_done=take(tree.node_done, False),
        prior=take(tree.prior, 0.0),
        visit=take(tree.visit, 0),
        wsum=take(tree.wsum, 0.0),
        child=child_new,
        parent=parent_new,
    )


compact_subtree = compiled(compact_subtree, static_argnames=("reuse_cap",))


def played_child_stats(tree: MCTSTree, actions: torch.Tensor):
    """``(visit, wsum)`` of the root child reached by ``actions``: the
    ``warm_root`` of the next ply's search.  The played child's mover is the
    next root's mover, so the statistics carry over as they are; an
    unexpanded child gives zeros.  Callers zero the statistics of envs that
    reset between plies."""
    b = actions.shape[0]
    bidx = torch.arange(b, device=actions.device)
    c = tree.child[bidx, 0, actions.to(torch.int64)]
    ok = (c >= 0)[:, None]
    safe = c.clamp_min(0).to(torch.int64)
    return torch.where(ok, tree.visit[bidx, safe], 0), torch.where(ok, tree.wsum[bidx, safe], 0.0)


def _puct_scores(prior, visit, value_sum, c_puct):
    q = torch.where(visit > 0, value_sum / visit.clamp_min(1), 0.0)
    total = visit.sum(dim=-1, keepdim=True)
    u = c_puct * prior * torch.sqrt(total.to(torch.float32) + 1.0) / (1.0 + visit.to(torch.float32))
    return q + u


def dirichlet_noise(generator: torch.Generator, alpha: float, shape, device) -> torch.Tensor:
    """Symmetric Dirichlet(alpha) draws, float32 ``shape`` (the last axis is
    the simplex), from ``generator`` on ``device``."""
    concentration = torch.full(tuple(shape), alpha, dtype=torch.float32, device=device)
    return torch._sample_dirichlet(concentration, generator=generator)


@torch.no_grad()
def run_mcts(generator, states, net, num_simulations: int = 32, c_puct: float = 1.5, komi: float = 0.0,
             dirichlet_alpha: float = 0.3, dirichlet_fraction: float = 0.25, temperature: float = 1.0,
             num_parallel: int = 1, warm_root=None, warm_tree: MCTSTree | None = None, return_tree: bool = False,
             pass_min_stones: int = 0, dirichlet=None, gumbel=None):
    """PUCT search from each state, on the states' device.  ``net(canonical)
    -> (logits, value)``, the value from the canonical mover's view.

    ``num_parallel`` (K) makes each round a wave of K paths per env: a path
    sees the edges of the wave's earlier paths penalized by virtual losses
    (visit + 1, value - 1 from the node mover's view), then all B * K leaves
    are stepped and evaluated in one ``step_states`` and one net call, and
    real values are backed up.  K = 1 is classic sequential PUCT.

    ``warm_root`` = (visit int32 (B, A), wsum float32 (B, A)) seeds the root
    statistics (``played_child_stats`` of the previous ply); ``warm_tree``
    (``compact_subtree``) seeds a whole subtree in slots [0, R) with the root
    at 0 (its state and prior are re-seeded here) and new expansions fill
    [R, R + num_simulations).  Carried root visits on moves that are not legal
    at the new root, or that ``pass_min_stones`` excludes, are zeroed.

    ``dirichlet`` (root exploration noise) and ``gumbel`` (the noise of the
    final categorical pick), float32 (B, N*N+1) each, are drawn from
    ``generator`` unless given.  ``return_tree=True`` returns
    ``(MCTSResult, MCTSTree)``."""
    if num_simulations % num_parallel != 0:
        raise ValueError("num_simulations must be a multiple of num_parallel")
    if warm_root is not None and warm_tree is not None:
        raise ValueError("pass at most one of warm_root / warm_tree")
    k_par = num_parallel
    num_waves = num_simulations // k_par
    b, n = states.shape[0], states.shape[-1]
    dev = states.device
    a_size = n * n + 1
    r_slots = 1 if warm_tree is None else warm_tree.prior.shape[1]
    m = num_simulations + r_slots
    max_depth = m

    def masked_policy(sts):
        logits, value = net(_transform.batch_canonical_form(sts))
        valid = _actions.batch_valid_moves(sts) > 0
        return torch.softmax(torch.where(valid, logits, -torch.inf), dim=-1), value

    root_prior, _ = masked_policy(states)
    if dirichlet is None:
        dirichlet = dirichlet_noise(generator, dirichlet_alpha, (b, a_size), dev)
    noise = dirichlet.to(device=dev, dtype=torch.float32)
    # the opening constraint on the ROOT action set only; interior nodes
    # search the full rules
    valid_root = _actions.mask_early_pass(_actions.batch_valid_moves(states) > 0, states, pass_min_stones)
    root_prior = torch.where(valid_root, root_prior, 0.0)
    noisy = root_prior * (1 - dirichlet_fraction) + noise * dirichlet_fraction
    noisy = torch.where(valid_root, noisy, 0.0)
    root_prior = noisy / noisy.sum(dim=-1, keepdim=True)

    node_states = torch.zeros((b, m) + tuple(states.shape[1:]), dtype=states.dtype, device=dev)
    node_done = torch.zeros((b, m), dtype=torch.bool, device=dev)
    prior = torch.zeros((b, m, a_size), dtype=torch.float32, device=dev)
    visit = torch.zeros((b, m, a_size), dtype=torch.int32, device=dev)
    wsum = torch.zeros((b, m, a_size), dtype=torch.float32, device=dev)
    child = torch.full((b, m, a_size), -1, dtype=torch.int32, device=dev)
    parent = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    if warm_tree is not None:
        for dst, src in zip((node_states, node_done, prior, visit, wsum, child, parent), warm_tree):
            dst[:, :r_slots] = src
    # (re-)seed the root row: exact state, fresh noisy prior, done flag;
    # carried visit / wsum / child stay
    node_states[:, 0] = states
    node_done[:, 0] = _state.game_ended(states)
    prior[:, 0] = root_prior
    parent[:, 0] = -1
    if warm_root is not None:
        visit[:, 0] = warm_root[0].to(torch.int32)
        wsum[:, 0] = warm_root[1].to(torch.float32)
    if warm_root is not None or warm_tree is not None:
        # carried root statistics were gathered under the full rules; the
        # final policy samples raw root visits, so mask what the root excludes
        visit[:, 0] = torch.where(valid_root, visit[:, 0], 0)
        wsum[:, 0] = torch.where(valid_root, wsum[:, 0], 0.0)

    bidx = torch.arange(b, device=dev)
    bidx_path = bidx[:, None].expand(b, max_depth)
    depth_iota = torch.arange(max_depth, device=dev)

    def select_paths(eff_visit, eff_wsum, filled):
        """The wave's walk; slots [0, filled) are the only ones a path can
        reach, so no path is longer."""
        scores = _puct_scores(prior, eff_visit, eff_wsum, c_puct)
        scores = torch.where(prior > 0, scores, -torch.inf)
        return _treewalk.walk_paths(*_treewalk.node_tables(scores, child, node_done), max_depth,
                                    depth_bound=filled)

    def path_index(path_n, path_a, depth):
        """(index, on_path) of a batched scatter-add over each path's edges.
        The (node, action) pairs of one path are distinct (strict descent);
        the slots past the path point at (0, 0) and add 0, so the sums are
        exact in any order."""
        on_path = depth_iota < depth[:, None]
        index = (bidx_path, torch.where(on_path, path_n, 0).to(torch.int64),
                 torch.where(on_path, path_a, 0).to(torch.int64))
        return index, on_path

    for wave in range(num_waves):
        # ---- K selections, each seeing the wave's earlier paths as losses
        filled = r_slots + wave * k_par
        if k_par == 1:
            paths = [select_paths(visit, wsum, filled)]
        else:
            vn = torch.zeros_like(visit)
            paths = []
            for k in range(k_par):
                paths.append(select_paths(visit + vn, wsum - vn.to(torch.float32), filled))
                if k < k_par - 1:
                    index, on_path = path_index(paths[-1][1], paths[-1][2], paths[-1][0])
                    vn.index_put_(index, on_path.to(torch.int32), accumulate=True)

        # ---- one env step and one net call for all B * K leaves
        exp_parents, exp_actions = [], []
        for sel_depth, path_n, path_a in paths:
            last = (sel_depth - 1).clamp_min(0).to(torch.int64)[:, None]
            exp_parents.append(path_n.gather(1, last)[:, 0].to(torch.int64))
            exp_actions.append(path_a.gather(1, last)[:, 0].to(torch.int64))
        parent_states = torch.cat([node_states[bidx, p] for p in exp_parents])
        new_states_all, info = _step.step_states(parent_states, torch.cat(exp_actions))
        new_probs_all, new_values_all = masked_policy(new_states_all)
        new_done_all = _state.game_ended(new_states_all)
        # the terminal outcome from the step's own areas (those of the result
        # state, as ``score.winning`` of it)
        win_black = torch.sign(info.black_area.to(torch.float32) - info.white_area.to(torch.float32) - komi)
        terminal_all = torch.where(_state.turn(new_states_all) == 1, -win_black, win_black)
        # the leaf value from the LEAF mover's view.  A selected edge that has
        # a child already (a terminal revisit, or a duplicate in the wave)
        # re-steps to that child's exact state, so this value holds in every
        # case and ``already`` only gates the node writes.
        leaf_all = torch.where(new_done_all, terminal_all, new_values_all)

        for k, (sel_depth, path_n, path_a) in enumerate(paths):
            exp_parent, exp_action = exp_parents[k], exp_actions[k]
            sl = slice(k * b, (k + 1) * b)
            prev = child[bidx, exp_parent, exp_action]
            write = prev < 0
            slot = r_slots + wave * k_par + k
            node_states[:, slot] = torch.where(write[:, None, None, None], new_states_all[sl], node_states[:, slot])
            node_done[:, slot] = torch.where(write, new_done_all[sl], node_done[:, slot])
            prior[:, slot] = torch.where(write[:, None], new_probs_all[sl], prior[:, slot])
            child[bidx, exp_parent, exp_action] = torch.where(write, slot, prev)
            parent[:, slot] = torch.where(write, exp_parent.to(torch.int32), parent[:, slot])
            # ---- backup: the deepest edge sees the leaf as its child (-v),
            # the sign alternating per ply upward
            index, on_path = path_index(path_n, path_a, sel_depth)
            steps_up = sel_depth[:, None] - 1 - depth_iota
            sign = torch.where(steps_up % 2 == 0, -1.0, 1.0)
            visit.index_put_(index, on_path.to(torch.int32), accumulate=True)
            wsum.index_put_(index, torch.where(on_path, sign * leaf_all[sl, None], 0.0), accumulate=True)

    root_visits = visit[:, 0]
    vp = root_visits.to(torch.float32)
    if temperature != 1.0:
        vp = vp.pow(1.0 / max(temperature, 1e-6))
    vp_sum = vp.sum(dim=-1, keepdim=True)
    uniform_valid = valid_root.to(torch.float32)
    uniform_valid = uniform_valid / uniform_valid.sum(dim=-1, keepdim=True)
    visit_policy = torch.where(vp_sum > 0, vp / vp_sum.clamp_min(1), uniform_valid)
    root_q = wsum[:, 0].sum(dim=-1) / root_visits.sum(dim=-1).clamp_min(1)
    if gumbel is None:
        gumbel = _actions.gumbel_noise(generator, (b, a_size), dev)
    pick = torch.log(visit_policy.clamp_min(1e-30)) + gumbel.to(device=dev, dtype=torch.float32)
    result = MCTSResult(
        actions=pick.argmax(dim=-1).to(torch.int32),
        visit_policy=visit_policy,
        root_value=root_q,
        root_visits=root_visits.clone(),
    )
    if return_tree:
        return result, MCTSTree(node_states, node_done, prior, visit, wsum, child, parent)
    return result


run_mcts = compiled(
    run_mcts,
    static_argnames=("net", "num_simulations", "c_puct", "komi", "dirichlet_alpha", "dirichlet_fraction",
                     "temperature", "num_parallel", "return_tree", "pass_min_stones"),
    when=capturable_states,
)


def make_mcts_policy(net, num_simulations: int = 32, **kw):
    """Adapter: ``policy_fn(generator, states) -> actions`` for
    ``batch_env.rollout`` and ``evaluate.play_match``."""

    def policy_fn(generator, states):
        return run_mcts(generator, states, net, num_simulations=num_simulations, **kw).actions

    return policy_fn
