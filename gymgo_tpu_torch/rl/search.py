"""Batched one-ply lookahead action selection (counterpart of
``gymgo_tpu.rl.search``).

A policy-improvement operator in the spirit of Gumbel AlphaZero's root action
selection: sample k actions without replacement by Gumbel top-k on the masked
policy logits, expand each child with the exact env step, score the children
with the value head (negated: a child's value is from the opponent's view),
and pick the argmax of g + logits + c_q * q.  B * k child evaluations per move.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import state as _state
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.core import transform as _transform

__all__ = ["SearchResult", "gumbel_oneply", "make_search_policy"]


class SearchResult(NamedTuple):
    actions: torch.Tensor  # int32 (B,): selected action per env
    sampled_actions: torch.Tensor  # int32 (B, K)
    q_values: torch.Tensor  # float32 (B, K): child values, the mover's view
    improved_policy: torch.Tensor  # float32 (B, A): softmax(logits + c_q * q)


@torch.no_grad()
def gumbel_oneply(
    generator: torch.Generator,
    states: torch.Tensor,
    net,
    num_sampled: int = 16,
    c_q: float = 1.0,
    komi: float = 0.0,
    pass_min_stones: int = 0,
    gumbel: torch.Tensor | None = None,
) -> SearchResult:
    """Select actions by one-ply value lookahead over Gumbel-sampled moves.

    ``net(canonical_states) -> (logits, value)``.  ``gumbel`` is the noise,
    float32 ``(B, N*N+1)``, drawn from ``generator`` unless given.
    ``pass_min_stones`` > 0 applies the self-play opening constraint to the
    root action set (``actions.mask_early_pass``)."""
    b = states.shape[0]
    n = states.shape[-1]
    a_size = n * n + 1
    k = min(num_sampled, a_size)
    neg_inf = -torch.inf

    logits, _ = net(_transform.batch_canonical_form(states))
    valid = _actions.batch_valid_moves(states) > 0
    valid = _actions.mask_early_pass(valid, states, pass_min_stones)
    masked = torch.where(valid, logits, neg_inf)

    if gumbel is None:
        gumbel = _actions.gumbel_noise(generator, (b, a_size), states.device)
    g = gumbel.to(device=states.device, dtype=torch.float32)
    scores = torch.where(valid, masked + g, neg_inf)
    # stable: the lower index first among equals, as lax.top_k orders them
    top_actions = scores.sort(dim=1, descending=True, stable=True).indices[:, :k]

    # Expand children: B * K exact env steps (each state K times in a row,
    # by a view: no output size to read on the host).
    parents = states[:, None].expand((b, k) + tuple(states.shape[1:])).reshape((b * k,) + tuple(states.shape[1:]))
    children, _ = _step.step_states(parents, top_actions.reshape(-1))

    # Child value from the mover's view = -V(child for the next player);
    # terminal children take the exact outcome sign instead of the net's.
    _, child_values = net(_transform.batch_canonical_form(children))
    q = -child_values.reshape(b, k)
    child_done = _state.game_ended(children).reshape(b, k)
    mover_is_white = _state.turn(states) == 1
    sign_black = _score.winning(children, komi).reshape(b, k)
    q = torch.where(child_done, torch.where(mover_is_white[:, None], -sign_black, sign_black), q)

    pick = (g.gather(1, top_actions) + masked.gather(1, top_actions) + c_q * q).argmax(dim=1, keepdim=True)
    actions = top_actions.gather(1, pick)[:, 0]

    # Improved policy over the full action space: logits + c_q * q at the
    # sampled actions (distinct per row), the logits elsewhere, softmaxed
    # over the valid moves.
    improved_logits = masked.scatter_add(1, top_actions, c_q * q)
    improved = torch.softmax(torch.where(valid, improved_logits, neg_inf), dim=-1)
    return SearchResult(
        actions=actions.to(torch.int32),
        sampled_actions=top_actions.to(torch.int32),
        q_values=q,
        improved_policy=improved,
    )


def make_search_policy(net, num_sampled=16, c_q=1.0, komi=0.0, pass_min_stones: int = 0):
    """Adapter: ``policy_fn(generator, states) -> actions`` for
    ``batch_env.rollout`` and ``evaluate.play_match``."""

    def policy_fn(generator, states):
        return gumbel_oneply(
            generator, states, net,
            num_sampled=num_sampled, c_q=c_q, komi=komi, pass_min_stones=pass_min_stones,
        ).actions

    return policy_fn
