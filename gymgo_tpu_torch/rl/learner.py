"""The learner: AZ loss and one AdamW update (counterpart of
``gymgo_tpu.rl.learner``).

``optax.adamw(lr, weight_decay=1e-4)`` is ``torch.optim.AdamW`` with betas
(0.9, 0.999), eps 1e-8 and the same decay (PyTorch's default decay, 1e-2, is
not the JAX package's).  Both decay every parameter and apply the same update:
p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with p before the update.
The module holds float32 master parameters and computes in its config's dtype,
as flax does.  The backward pass is PyTorch's autograd through its convolutions
and dense layers; the JAX package has no kernel of its own there either.

``make_jitted_train_step`` is the compiled form: on the card the forward, the
backward and the AdamW update are one CUDA graph (``utils.graphs``), with
``AdamW(capturable=True)``, whose bias corrections are computed on the card in
float32 where the eager step computes them on the host in float64 (the
parameters agree within rounding, not bit for bit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gymgo_tpu_torch.parallel.mesh import all_reduce_sum
from gymgo_tpu_torch.utils.graphs import compiled

__all__ = ["TrainState", "make_train_state", "az_loss", "train_step", "make_jitted_train_step"]


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


def _held_tensors(state: TrainState) -> list:
    """The tensors a captured step reads and updates in place: the
    parameters, their gradients and the optimizer's state."""
    held = []
    for p in state.net.parameters():
        held += [p, p.grad] + [v for v in state.optimizer.state.get(p, {}).values() if isinstance(v, torch.Tensor)]
    return held


def make_jitted_train_step(state: TrainState, sample=None):
    """The compiled ``train_step`` for ``group=None`` (the counterpart of the
    JAX package's ``make_jitted_train_step``): ``step(state, batch) ->
    (state, metrics)`` as ``train_step`` returns them, for ``state``'s net
    and optimizer.

    With ``sample``, ``step(state, *args)`` computes its batch as
    ``sample(*args)`` inside the same program, as JAX's trainer jits the
    replay's sample with the step (the trainer passes the replay's ``filled``
    count and the generator; the rows are read where they lie).

    On the card the forward, the backward and the AdamW update are one CUDA
    graph per batch shape: the optimizer is switched to ``capturable=True``
    (its step counts moved to the card) and the gradients are zeroed in place,
    never freed, so the graph's tensors stay those of ``state``.  A step whose
    parameters, gradients or optimizer state were replaced since its capture
    (a ``load_state_dict`` of the optimizer, a ``zero_grad`` that frees)
    raises.  On the CPU it is ``train_step``.  The data-parallel step
    (``group=``) has no compiled form: its all-reduce goes through the host
    under gloo."""
    net, opt = state.net, state.optimizer
    device = next(net.parameters()).device
    if device.type == "cuda":
        for group in opt.param_groups:
            group["capturable"] = True
        for st in opt.state.values():
            if isinstance(st.get("step"), torch.Tensor) and not st["step"].is_cuda:
                st["step"] = st["step"].to(device=device, dtype=torch.float32)

    def update(*args):
        obs, pi_t, v_t, mask, *rest = args if sample is None else sample(*args)
        vmask = rest[0] if rest else None
        opt.zero_grad(set_to_none=False)
        loss, (pi_loss, v_loss) = az_loss(net, obs, pi_t, v_t, mask, vmask)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "policy_loss": pi_loss.detach(), "value_loss": v_loss.detach()}

    update = compiled(update)
    held = []

    def step(st: TrainState, *args):
        if st.net is not net or st.optimizer is not opt:
            raise ValueError("this step was made for another TrainState's net and optimizer")
        now = _held_tensors(st) if held else held
        if len(now) != len(held) or any(a is not b for a, b in zip(held, now)):
            raise RuntimeError("the parameters, gradients or optimizer state were replaced since the capture: "
                               "make a new step")
        metrics = update(*(args[0] if sample is None else args))
        if device.type == "cuda":
            held[:] = _held_tensors(st)
        return st._replace(step=st.step + 1), metrics

    step.update = update  # the compiled update, with its graphs
    return step
