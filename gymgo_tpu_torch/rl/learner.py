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

from gymgo_tpu_torch.parallel.mesh import all_reduce_sum

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


def _masked_sums(net, obs, policy_target, value_target, mask, value_mask):
    """The loss's numerators and denominators: the masked sums of the policy
    cross-entropy and of the value error, and the sums of the two masks."""
    logits, value = net(obs)
    logp = F.log_softmax(logits, dim=-1)
    # target rows are masked softmaxes: zeros at invalid moves
    pi_loss = -(policy_target * logp).sum(dim=-1)
    v_loss = (value - value_target).square()
    m = mask.to(torch.float32)
    vm = m if value_mask is None else m * value_mask.to(torch.float32)
    return (pi_loss * m).sum(), (v_loss * vm).sum(), m.sum(), vm.sum()


def az_loss(net, obs, policy_target, value_target, mask, value_mask=None):
    """Masked cross-entropy on the policy + MSE on the value head.

    obs: (M, 6, N, N) canonical states; targets as in ``SelfPlayBatch``, the
    leading dims flattened to M.  ``value_mask`` (optional, (M,) bool) gates
    ONLY the value term: rows of a truncated game tail then train the policy
    and give the value head no gradient (``--value-grounded-only``).  Returns
    ``(loss, (policy_loss, value_loss))``, 0-d tensors."""
    pi_sum, v_sum, m_sum, vm_sum = _masked_sums(net, obs, policy_target, value_target, mask, value_mask)
    pi_loss = pi_sum / m_sum.clamp_min(1.0)
    v_loss = v_sum / vm_sum.clamp_min(1.0)
    return pi_loss + v_loss, (pi_loss, v_loss)


def _data_parallel_backward(net, batch, group):
    """This rank's part of the global loss's gradient, summed over ``group``
    into every parameter's ``.grad``; returns the global (policy_loss,
    value_loss).

    Both terms are masked means, so each rank divides its masked sums by the
    *global* mask sums (all-reduced first) and the ranks' gradients add up
    to the gradient of the loss on the whole batch.  An average of per-rank
    losses would weigh the ranks' rows unequally whenever their masks
    differ.  GroupNorm works per sample: no statistic crosses ranks."""
    pi_sum, v_sum, m_sum, vm_sum = _masked_sums(net, *batch)
    denoms = all_reduce_sum(torch.stack([m_sum, vm_sum]).detach(), group).clamp_min(1.0)
    pi_loss, v_loss = pi_sum / denoms[0], v_sum / denoms[1]
    (pi_loss + v_loss).backward()
    params = list(net.parameters())
    flat = all_reduce_sum(torch.cat([p.grad.reshape(-1) for p in params]
                                    + [torch.stack([pi_loss, v_loss]).detach()]), group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
    return flat[-2], flat[-1]


def train_step(state: TrainState, batch, group=None):
    """One AdamW update.  ``batch`` = (obs, policy_target, value_target, mask)
    or the same plus a trailing value_mask, leading dim flattened.  Updates
    the module and the optimizer in place; returns ``(state, metrics)`` with
    ``loss``, ``policy_loss`` and ``value_loss`` as 0-d tensors.

    With a process ``group`` (``torch.distributed.group.WORLD`` for the
    default one), each rank passes its env slice of the global batch and
    holds the same parameters; every rank then makes the update of the
    single-process step on the global batch (the counterpart of JAX's
    ``train_step`` on an env-sharded batch, where XLA adds the gradient
    psum), and the metrics are the global batch's.  Without one it makes no
    host sync."""
    obs, pi_t, v_t, mask, *rest = batch
    vmask = rest[0] if rest else None
    state.optimizer.zero_grad(set_to_none=True)
    if group is None:
        loss, (pi_loss, v_loss) = az_loss(state.net, obs, pi_t, v_t, mask, vmask)
        loss.backward()
    else:
        pi_loss, v_loss = _data_parallel_backward(state.net, (obs, pi_t, v_t, mask, vmask), group)
        loss = pi_loss + v_loss
    state.optimizer.step()
    metrics = {"loss": loss.detach(), "policy_loss": pi_loss.detach(), "value_loss": v_loss.detach()}
    return state._replace(step=state.step + 1), metrics
