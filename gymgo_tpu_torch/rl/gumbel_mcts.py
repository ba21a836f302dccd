"""Batched Gumbel MCTS with sequential halving (counterpart of
``gymgo_tpu.rl.gumbel_mcts``).

Policy-improvement search that is an improvement operator even at tiny
simulation budgets (Danihelka et al., "Policy improvement by planning with
Gumbel", 2022): sample ``max_considered`` root actions without replacement by
Gumbel-top-k, spread the simulation budget over them with sequential halving
(scores g + logits + sigma(q)), and descend interior nodes with the
deterministic completed-Q rule.  The returned ``improved_policy`` =
softmax(logits + sigma(completedQ)) is the AZ training target; ``actions`` is
the halving winner (no sampling noise beyond the root Gumbels).

The network chooses the simulator, and both run the same root candidates,
halving, interior scores, walk, backup and outputs; they differ only in the
expansion and the masks:

* An ``AZNet`` (any ``net(canonical_states) -> (logits, value)``): the
  simulator is the exact env step (one ``step_states`` per simulation, so one
  launch of the flood kernel of the step and one of its seed); the tree
  stores each node's board, masks illegal moves at every node, and a node
  where the game ended is terminal, valued by its outcome.
* A learned model (``models.muzero_net.MuZeroNet``, anything with
  ``represent``, ``dynamics`` and ``predict``): Gumbel MuZero.  The root is
  ``h`` then ``f``; simulation i gathers the hidden state of the expanded
  edge's parent from the tree's store of hidden states, applies ``g`` for the
  edge's action, writing into the store's slot i + 1, then ``f``.  As MuZero
  does, only the root is masked to legal moves (the environment is not
  queried inside the tree): below it every action is selectable, no node is
  terminal and a leaf's value is ``f``'s.  ``LearnedMCTSResult`` adds each
  slot's parent, action, value and logits.

The whole search is batched over envs, and the tree lives in fixed-shape
tensors: node 0 is the root and simulation i expands slot i + 1.

Tree layouts.  The default stores visits as int32 and priors and value sums as
float32.  ``GYMGO_GUMBEL_PACK`` (read at import, a comma list, as in the JAX
package; ``set_gumbel_pack`` switches it inside a process) narrows the
(B, nodes, A) tables for search at large B: ``i16`` stores visits as int16
(simulations <= 32767), ``bf16`` stores the value sums (and the log-priors
under ``logp``) as bfloat16, computing q in float32 (the backup rounds to
bfloat16, so results move), and ``logp`` stores log-softmax priors plus a bool
validity plane, which takes the log over the whole prior table out of every
simulation.

On CUDA tensors a whole search is one CUDA graph, the counterpart of the
JAX package's ``lax.fori_loop`` over the simulations under ``jax.jit``
(``utils.graphs.compiled``): keyed by the net (by identity), the simulation
counts, the constants and the tree layout, replayed with the states, the
generator and the noise copied in.  Boards over 181x181 run the search
eagerly (``core.flood.capturable``); ``run_gumbel_mcts.fn`` is the eager
search, which the studies measure.

Ties are resolved as in JAX so that, given the same Gumbel noise, both
packages search the same tree: the top-k and the rank of the candidates come
from stable descending sorts (the lower index first among equals, which is
what ``lax.top_k`` and ``jnp.argsort`` give), and ``argmax`` / ``argmin`` take
the first of equals in both.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.core import transform as _transform
from gymgo_tpu_torch.core.flood import capturable_states
from gymgo_tpu_torch.rl import treewalk as _treewalk
from gymgo_tpu_torch.utils import tracing
from gymgo_tpu_torch.utils.graphs import compiled, register_key_part

__all__ = ["GumbelMCTSResult", "LearnedMCTSResult", "seq_halving_schedule", "run_gumbel_mcts",
           "make_gumbel_mcts_policy", "PACK_TOKENS", "set_gumbel_pack"]

PACK_TOKENS = ("i16", "bf16", "logp")
pack = frozenset(t for t in os.environ.get("GYMGO_GUMBEL_PACK", "").split(",") if t)
# a graph captured under one layout never replays under another
register_key_part(lambda: tuple(sorted(pack)))


def set_gumbel_pack(tokens) -> frozenset:
    """Use the tree layout of ``tokens`` (an iterable of ``PACK_TOKENS``;
    empty is the default layout) in every later search of the process;
    returns the set in force before."""
    global pack
    tokens = frozenset(tokens)
    unknown = tokens.difference(PACK_TOKENS)
    if unknown:
        raise ValueError(f"unknown GYMGO_GUMBEL_PACK tokens {sorted(unknown)}; known: {PACK_TOKENS}")
    previous, pack = pack, tokens
    return previous


class GumbelMCTSResult(NamedTuple):
    actions: torch.Tensor  # int32 (B,): sequential-halving winner
    improved_policy: torch.Tensor  # float32 (B, A): softmax(logits + sigma(cQ))
    root_value: torch.Tensor  # float32 (B,): completed-Q root estimate
    root_visits: torch.Tensor  # int32 (B, A)
    sampled_actions: torch.Tensor  # int32 (B, M): Gumbel-top-k candidates


class LearnedMCTSResult(NamedTuple):
    """A search over a learned model: ``GumbelMCTSResult``'s fields, then
    each tree slot's edge and what ``f`` said there (slot 0 is the root)."""

    actions: torch.Tensor
    improved_policy: torch.Tensor
    root_value: torch.Tensor
    root_visits: torch.Tensor
    sampled_actions: torch.Tensor
    node_parent: torch.Tensor  # int32 (B, S): the slot's parent slot, -1 at the root
    node_action: torch.Tensor  # int32 (B, S): the action from the parent, -1 at the root
    node_value: torch.Tensor  # float32 (B, S): f's value, from the slot's mover's view
    node_logits: torch.Tensor  # float32 (B, S, A): f's logits, unmasked
    node_latents: torch.Tensor | None = None  # (K, S, C, N, N): the stored states of ``latent_rows``' boards


def seq_halving_schedule(num_simulations: int, max_considered: int) -> tuple:
    """Static per-simulation considered-count table.

    Phase p keeps ``m / 2^p`` candidates and gives each
    ``max(1, n // (ceil(log2 m) * considered))`` visits; once one candidate
    remains, the tail of the budget keeps refining it.
    """
    n, m = num_simulations, max(2, max_considered)
    log2m = max(1, math.ceil(math.log2(m)))
    out: list[int] = []
    considered = m
    while len(out) < n:
        if considered > 1:
            per_candidate = max(1, n // (log2m * considered))
            block = per_candidate * considered
        else:
            block = n - len(out)
        out.extend([considered] * min(block, n - len(out)))
        considered = max(1, considered // 2)
    return tuple(out)


def _sigma(q, max_visit, c_visit: float, c_scale: float):
    """Monotone value->logit transform: (c_visit + maxN) * c_scale * q."""
    return (c_visit + max_visit.to(torch.float32)) * c_scale * q


@torch.no_grad()
def run_gumbel_mcts(
    generator: torch.Generator,
    states: torch.Tensor,
    net,
    num_simulations: int = 32,
    max_considered: int = 16,
    c_visit: float = 50.0,
    c_scale: float = 1.0,
    komi: float = 0.0,
    pass_min_stones: int = 0,
    gumbel: torch.Tensor | None = None,
    latent_rows: torch.Tensor | None = None,
) -> GumbelMCTSResult:
    """Run Gumbel MCTS from each state, on the states' device.

    ``net(canonical_states) -> (logits, value)``, the value from the canonical
    mover's view: an ``AZNet`` or any callable, searched over the exact env
    step; or a learned model (``represent``, ``dynamics``, ``predict``, as
    ``MuZeroNet``), searched over its own dynamics, which returns a
    ``LearnedMCTSResult``.  ``gumbel`` is the root noise,
    float32 ``(B, N*N+1)``; it is drawn from ``generator`` unless given, so a
    caller can hand two searches the same noise.  ``latent_rows``, int
    ``(K,)`` board indices, asks a learned search for those boards' trees of
    hidden states, ``node_latents`` ``(K, S, C, N, N)`` in the store's type
    (the others' are dropped with the search).

    ``pass_min_stones`` > 0 applies the self-play opening constraint
    (``actions.mask_early_pass``) to the root action set only; interior nodes
    search the full rules."""
    b = states.shape[0]
    n = states.shape[-1]
    dev = states.device
    a_size = n * n + 1
    m = min(max_considered, a_size)
    num_nodes = num_simulations + 1
    max_depth = num_simulations + 1
    schedule = seq_halving_schedule(num_simulations, m)
    neg_inf = -torch.inf
    visit_dt = torch.int16 if "i16" in pack else torch.int32
    wsum_dt = torch.bfloat16 if "bf16" in pack else torch.float32
    use_logp = "logp" in pack
    learned = hasattr(net, "dynamics")
    if latent_rows is not None and not learned:
        raise ValueError("latent_rows needs a learned model: the exact simulator keeps no hidden states")

    def masked_policy(sts):
        with tracing.span("search.net"):
            tracing.count("search.net_rows", sts.shape[0])
            logits, value = net(_transform.batch_canonical_form(sts))
            valid = _actions.batch_valid_moves(sts) > 0
            return torch.where(valid, logits, neg_inf), value, valid

    if learned:
        with tracing.span("search.represent"):
            store = net.latent_store(num_nodes, b, dev)
            net.represent(_transform.batch_canonical_form(states), out=store[0])
        with tracing.span("search.predict"):
            net_logits, root_value_net = net.predict(store[0])
        with tracing.span("search.root"):
            valid_root = _actions.batch_valid_moves(states) > 0
            root_logits = torch.where(valid_root, net_logits, neg_inf)
    else:
        root_logits, root_value_net, valid_root = masked_policy(states)
    with tracing.span("search.root"):
        valid_root = _actions.mask_early_pass(valid_root, states, pass_min_stones)
        root_logits = torch.where(valid_root, root_logits, neg_inf)
        if gumbel is None:
            gumbel = _actions.gumbel_noise(generator, (b, a_size), dev)
        g = gumbel.to(device=dev, dtype=torch.float32)
        # Gumbel-top-m without replacement over valid actions; an env with fewer
        # than m valid actions fills its tail with the lowest invalid indices.
        noisy = torch.where(valid_root, root_logits + g, neg_inf)
        cand = noisy.sort(dim=1, descending=True, stable=True).indices[:, :m]  # (B, M) int64
        cand_valid = valid_root.gather(1, cand)
        cand_base = torch.where(cand_valid, noisy.gather(1, cand), neg_inf)

    # Tree arrays.  Values are stored from the node mover's view throughout.
    if learned:
        node_parent = torch.full((b, num_nodes), -1, dtype=torch.int32, device=dev)
        node_action = torch.full((b, num_nodes), -1, dtype=torch.int32, device=dev)
        node_logits = torch.zeros((b, num_nodes, a_size), dtype=torch.float32, device=dev)
        node_logits[:, 0] = net_logits
        # every action is selectable below the root
        below_root = (torch.arange(num_nodes, device=dev) > 0)[None, :, None]
        latent_bytes = 2 * store[0].numel() * store.element_size()  # the parents' states read and gathered
    else:
        node_states = torch.zeros((b, num_nodes) + tuple(states.shape[1:]), dtype=states.dtype, device=dev)
        node_states[:, 0] = states
    node_done = torch.zeros((b, num_nodes), dtype=torch.bool, device=dev)
    node_done[:, 0] = _state.game_ended(states)
    node_value = torch.zeros((b, num_nodes), dtype=torch.float32, device=dev)
    node_value[:, 0] = root_value_net
    if use_logp:
        prior = torch.full((b, num_nodes, a_size), neg_inf, dtype=wsum_dt, device=dev)
        prior[:, 0] = torch.log_softmax(root_logits, dim=-1)
        node_valid = torch.zeros((b, num_nodes, a_size), dtype=torch.bool, device=dev)
        node_valid[:, 0] = valid_root
        if learned:
            node_valid[:, 1:] = True
    else:
        prior = torch.zeros((b, num_nodes, a_size), dtype=torch.float32, device=dev)
        prior[:, 0] = torch.softmax(root_logits, dim=-1)
    visit = torch.zeros((b, num_nodes, a_size), dtype=visit_dt, device=dev)
    wsum = torch.zeros((b, num_nodes, a_size), dtype=wsum_dt, device=dev)
    child = torch.full((b, num_nodes, a_size), -1, dtype=torch.int32, device=dev)

    bidx = torch.arange(b, device=dev)
    slot_rank = torch.arange(m, dtype=torch.int32, device=dev).expand(b, m)
    depth_iota = torch.arange(max_depth, dtype=torch.int32, device=dev)

    def root_candidate_stats():
        """Per-candidate (N, q) at the root; q from the root mover's view."""
        cn = visit[:, 0].gather(1, cand).to(torch.int32)
        cw = wsum[:, 0].gather(1, cand).to(torch.float32)
        return cn, torch.where(cn > 0, cw / cn.clamp_min(1), 0.0)

    def candidate_scores(cq):
        max_n = visit[:, 0].amax(dim=1, keepdim=True)
        return cand_base + _sigma(cq, max_n, c_visit, c_scale), max_n

    def interior_scores():
        """Deterministic non-root selection: argmax pi'(a) - N(a)/(1+sumN), for
        all (B, M) nodes at once (the statistics are frozen during one walk).
        completedQ(a) = q(a) when visited, else the node's own net value."""
        total = visit.sum(dim=-1, keepdim=True)
        q = torch.where(visit > 0, wsum.to(torch.float32) / visit.clamp_min(1).to(torch.float32),
                        node_value[..., None])
        if use_logp:
            logits_pi, selectable = prior.to(torch.float32), node_valid
        else:
            logits_pi, selectable = torch.log(prior.clamp_min(1e-30)), prior > 0
            if learned:
                selectable = selectable | below_root
        max_n = visit.amax(dim=-1, keepdim=True)
        improved = torch.softmax(logits_pi + _sigma(q, max_n, c_visit, c_scale), dim=-1)
        scores = improved - visit.to(torch.float32) / (1.0 + total)
        return torch.where(selectable, scores, neg_inf)

    def expand_exact(slot, exp_parent, exp_action, prev_child, already):
        """One exact env step per env into ``slot``; returns the leaf value.
        The terminal outcome comes from the step's own areas, not from a
        second scoring flood."""
        with tracing.span("search.expand"):
            new_states, step_info = _step.step_states(node_states[bidx, exp_parent], exp_action)
        new_logits, new_values, new_valid = masked_policy(new_states)
        with tracing.span("search.expand"):
            new_done = _state.game_ended(new_states)
            win_black = torch.sign(
                step_info.black_area.to(torch.float32) - step_info.white_area.to(torch.float32) - komi
            )
            outcome = torch.where(_state.turn(new_states) == 1, -win_black, win_black)
            leaf_value = torch.where(new_done, outcome, new_values)

            # Slot sim + 1 is new in this simulation, so an env that revisits a
            # terminal child leaves it as it was made: zeros.
            write = ~already
            node_states[:, slot] = torch.where(write[:, None, None, None], new_states, 0)
            node_done[:, slot] = write & new_done
            node_value[:, slot] = torch.where(write, leaf_value, 0.0)
            if use_logp:
                prior[:, slot] = torch.where(write[:, None], torch.log_softmax(new_logits, dim=-1).to(wsum_dt),
                                             neg_inf)
                node_valid[:, slot] = write[:, None] & new_valid
            else:
                prior[:, slot] = torch.where(write[:, None], torch.softmax(new_logits, dim=-1), 0.0)
            child[bidx, exp_parent, exp_action] = torch.where(write, slot, prev_child)
            # A revisited child is terminal, so its stored value is its exact
            # outcome from its own mover's view: back that up again.
            revisit_value = _treewalk.gather_node(node_value, prev_child.clamp_min(0))
            return torch.where(already, revisit_value, leaf_value)

    def expand_learned(slot, exp_parent, exp_action):
        """``g`` from the parent's hidden state into the store's ``slot``,
        then ``f``; returns ``f``'s value.  No node is terminal, so every
        walk ends on an unexpanded edge and the slot is always new."""
        with tracing.span("search.latent"):
            tracing.count("search.latent_bytes", latent_bytes)
            x = net.dynamics_input(store, exp_parent, exp_action)
        with tracing.span("search.dynamics"):
            tracing.count("search.dynamics_rows", b)
            net.dynamics_from_input(x, out=store[slot])
        with tracing.span("search.predict"):
            new_logits, new_values = net.predict(store[slot])
        with tracing.span("search.backup"):
            node_value[:, slot] = new_values
            node_logits[:, slot] = new_logits
            node_parent[:, slot] = exp_parent.to(torch.int32)
            node_action[:, slot] = exp_action.to(torch.int32)
            if use_logp:
                prior[:, slot] = torch.log_softmax(new_logits, dim=-1).to(wsum_dt)
            else:
                prior[:, slot] = torch.softmax(new_logits, dim=-1)
            child[bidx, exp_parent, exp_action] = torch.full((b,), slot, dtype=child.dtype, device=dev)
        return new_values

    for sim in range(num_simulations):
        # ---- root action by sequential halving: among the top-`considered`
        # candidates by g + logits + sigma(q), visit the least-visited.
        with tracing.span("search.root"):
            cn, cq = root_candidate_stats()
            score = torch.where(cand_valid, candidate_scores(cq)[0], neg_inf)
            order = torch.argsort(-score, dim=1, stable=True)
            rank = torch.empty((b, m), dtype=torch.int32, device=dev).scatter_(1, order, slot_rank)
            in_play = (rank < schedule[sim]) & cand_valid
            # lexicographic (visits, rank) argmin; slots out of play are pushed
            # past any reachable visit count (<= num_simulations < 2^20)
            pick_key = torch.where(in_play, cn, 1 << 20) * m + rank
            root_action = cand.gather(1, pick_key.argmin(dim=1, keepdim=True))[:, 0]

        # ---- selection walk: the depth-0 edge is forced to root_action,
        # interior edges follow the deterministic rule; stop at an unexpanded
        # edge or a terminal child.
        with tracing.span("search.walk"):
            tables = _treewalk.node_tables(interior_scores(), child, node_done)
            f_nxt, f_keep = _treewalk.forced_root_edge(root_action, child, node_done)
            # slots 0..sim are filled, so no path is longer than sim + 1
            sel_depth, path_n, path_a = _treewalk.walk_paths(
                *tables, max_depth, forced_root=(root_action, f_nxt, f_keep), depth_bound=sim + 1
            )
            last = (sel_depth - 1).clamp_min(0).to(torch.int64)[:, None]
            exp_parent = path_n.gather(1, last)[:, 0].to(torch.int64)
            exp_action = path_a.gather(1, last)[:, 0].to(torch.int64)
            prev_child = child[bidx, exp_parent, exp_action]
            already = prev_child >= 0

        slot = sim + 1
        if learned:
            leaf_value = expand_learned(slot, exp_parent, exp_action)
        else:
            leaf_value = expand_exact(slot, exp_parent, exp_action, prev_child, already)

        # ---- backup along the path with a sign flip per ply: one batched
        # scatter-add per array.  The (node, action) pairs of a path are
        # distinct; entries past the path point at (0, 0) and add 0, so the
        # sums are exact and the same on every run.
        with tracing.span("search.backup"):
            on_path = depth_iota < sel_depth[:, None]
            index = (bidx[:, None].expand(b, max_depth),
                     torch.where(on_path, path_n, 0).to(torch.int64),
                     torch.where(on_path, path_a, 0).to(torch.int64))
            steps_up = sel_depth[:, None] - 1 - depth_iota
            sign = torch.where(steps_up % 2 == 0, -1.0, 1.0)
            visit.index_put_(index, on_path.to(visit_dt), accumulate=True)
            wsum.index_put_(index, torch.where(on_path, sign * leaf_value[:, None], 0.0).to(wsum_dt),
                            accumulate=True)

    # ---- outputs.
    with tracing.span("search.root"):
        cn, cq = root_candidate_stats()
        final_score, max_n = candidate_scores(cq)
        final_score = torch.where(cand_valid & (cn > 0), final_score, neg_inf)
        actions = cand.gather(1, final_score.argmax(dim=1, keepdim=True))[:, 0]

        # Improved policy over the full action space: completedQ(a) = q(a) for
        # visited root actions, the root's net value otherwise.
        rn = visit[:, 0].to(torch.int32)
        w0 = wsum[:, 0].to(torch.float32)
        rq = torch.where(rn > 0, w0 / rn.clamp_min(1), root_value_net[:, None])
        improved_logits = root_logits + _sigma(rq, max_n, c_visit, c_scale)
        improved = torch.softmax(torch.where(valid_root, improved_logits, neg_inf), dim=-1)
        # Root value: the visit-weighted mean of completed Q (the net's value
        # with no visits).
        total_n = rn.sum(dim=1)
        root_q = torch.where(total_n > 0, w0.sum(dim=1) / total_n.clamp_min(1), root_value_net)
    out = GumbelMCTSResult(
        actions=actions.to(torch.int32),
        improved_policy=improved,
        root_value=root_q,
        root_visits=rn.clone(),
        sampled_actions=cand.to(torch.int32),
    )
    if not learned:
        return out
    node_latents = None
    if latent_rows is not None:
        with tracing.span("search.latent"):
            kept = store.index_select(1, latent_rows.to(torch.int64))
            tracing.count("search.latent_bytes", 2 * kept.numel() * kept.element_size())
            node_latents = kept.transpose(0, 1)
    return LearnedMCTSResult(*out, node_parent, node_action, node_value, node_logits, node_latents)


run_gumbel_mcts = compiled(
    run_gumbel_mcts,
    static_argnames=("net", "num_simulations", "max_considered", "c_visit", "c_scale", "komi", "pass_min_stones"),
    when=capturable_states,
)


def make_gumbel_mcts_policy(net, num_simulations=32, max_considered=16, **kw):
    """Adapter: ``policy_fn(generator, states) -> actions`` for
    ``batch_env.rollout`` and ``evaluate.play_match``."""

    def policy_fn(generator, states):
        return run_gumbel_mcts(
            generator, states, net,
            num_simulations=num_simulations, max_considered=max_considered, **kw
        ).actions

    return policy_fn
