"""The learner: AZ loss and one AdamW update (counterpart of
``gymgo_tpu.rl.learner``).

``optax.adamw(lr, weight_decay=1e-4)`` is ``torch.optim.AdamW`` with betas
(0.9, 0.999), eps 1e-8 and the same decay (PyTorch's default decay, 1e-2, is
not the JAX package's).  Both decay every parameter and apply the same update:
p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with p before the update.
The module holds float32 master parameters and computes in its config's dtype,
as flax does.  The backward pass is PyTorch's autograd through its convolutions
and dense layers; the JAX package has no kernel of its own there either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["TrainState", "make_train_state", "az_loss", "train_step"]


class TrainState(NamedTuple):
    net: torch.nn.Module  # float32 master parameters, updated in place
    optimizer: torch.optim.AdamW
    step: int


def make_train_state(net, learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> TrainState:
    optimizer = torch.optim.AdamW(
        net.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    return TrainState(net=net, optimizer=optimizer, step=0)


def az_loss(net, obs, policy_target, value_target, mask, value_mask=None):
    """Masked cross-entropy on the policy + MSE on the value head.

    obs: (M, 6, N, N) canonical states; targets as in ``SelfPlayBatch``, the
    leading dims flattened to M.  ``value_mask`` (optional, (M,) bool) gates
    ONLY the value term: rows of a truncated game tail then train the policy
    and give the value head no gradient (``--value-grounded-only``).  Returns
    ``(loss, (policy_loss, value_loss))``, 0-d tensors."""
    logits, value = net(obs)
    logp = F.log_softmax(logits, dim=-1)
    # target rows are masked softmaxes: zeros at invalid moves
    pi_loss = -(policy_target * logp).sum(dim=-1)
    v_loss = (value - value_target).square()
    m = mask.to(torch.float32)
    pi_loss = (pi_loss * m).sum() / m.sum().clamp_min(1.0)
    vm = m if value_mask is None else m * value_mask.to(torch.float32)
    v_loss = (v_loss * vm).sum() / vm.sum().clamp_min(1.0)
    return pi_loss + v_loss, (pi_loss, v_loss)


def train_step(state: TrainState, batch):
    """One AdamW update.  ``batch`` = (obs, policy_target, value_target, mask)
    or the same plus a trailing value_mask, leading dim flattened.  Updates
    the module and the optimizer in place; returns ``(state, metrics)`` with
    ``loss``, ``policy_loss`` and ``value_loss`` as 0-d tensors (no host
    sync)."""
    obs, pi_t, v_t, mask, *rest = batch
    vmask = rest[0] if rest else None
    state.optimizer.zero_grad(set_to_none=True)
    loss, (pi_loss, v_loss) = az_loss(state.net, obs, pi_t, v_t, mask, vmask)
    loss.backward()
    state.optimizer.step()
    metrics = {"loss": loss.detach(), "policy_loss": pi_loss.detach(), "value_loss": v_loss.detach()}
    return state._replace(step=state.step + 1), metrics
