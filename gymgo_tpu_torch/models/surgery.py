"""Model surgery: value-head re-initialization and function-preserving
Net2Net widening / deepening of the AZ trunk (counterpart of
``gymgo_tpu.models.surgery``).

* ``reinit_value_head`` recovers from a collapsed value head without
  discarding the policy trunk: the head (``value_conv``, ``value_hidden``,
  ``value_out``; flax's Conv_2 / Dense_1 / Dense_2) is drawn fresh with its
  final dense layer zeroed, and ``zero_moments_for`` zeroes its AdamW moments.
* ``widen_deepen`` grows a trained net (e.g. 64 channels x 3 blocks -> 128 x
  6) so training continues from the parent's strength (Net2Net, Chen et al.
  2015, arXiv:1511.05641).  New channel ``g*r*gs + q`` copies old channel
  ``g*gs + q % gs`` (each GroupNorm group becomes [originals..., copies...]),
  which leaves every group's mean and variance unchanged; consumers split each
  old input weight 1/r across the copies.  The copies' incoming weights get a
  small relative noise so they do not receive identical gradients forever.
  New blocks have a zero second GroupNorm scale: exact identities through
  ``relu(x + 0)``.

The flax kernels' trailing output axis is axis 0 of an OIHW conv weight and
of an ``nn.Linear`` weight here, and flax's input axis -2 is axis 1.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig, init_params

__all__ = ["VALUE_HEAD_KEYS", "reinit_value_head", "zero_moments_for", "widen_deepen"]

VALUE_HEAD_KEYS = ("value_conv", "value_hidden", "value_out")
_GROUPS = 8  # GroupNorm(8) throughout the net


def _head_parameters(net, keys):
    return [(name, p) for name, p in net.named_parameters() if name.split(".")[0] in keys]


@torch.no_grad()
def reinit_value_head(net: AZNet, generator: torch.Generator) -> AZNet:
    """Draw ``net``'s value head afresh, in place, from ``generator`` (as
    ``init_params`` draws a whole net), and zero its final dense layer.

    A trained trunk's activations are far larger than at init, so a
    default-scale head saturates tanh at once (the JAX package measured mean
    |v| = 1.000 on the 19x19 iter-420 trunk); v = tanh(0) = 0 starts the head
    neutral with full gradient flow."""
    fresh = dict(init_params(generator, net.config).named_parameters())
    for name, p in _head_parameters(net, VALUE_HEAD_KEYS):
        p.copy_(fresh[name])
    net.value_out.weight.zero_()
    net.value_out.bias.zero_()
    return net


@torch.no_grad()
def zero_moments_for(optimizer: torch.optim.Optimizer, net, keys=VALUE_HEAD_KEYS):
    """Zero the AdamW moments (``exp_avg``, ``exp_avg_sq``) of ``net``'s
    parameters under the given top-level modules; the step count stays."""
    for _, p in _head_parameters(net, keys):
        state = optimizer.state.get(p)
        if state:
            state["exp_avg"].zero_()
            state["exp_avg_sq"].zero_()
    return optimizer


def _dup_index(old_c: int, new_c: int, groups: int, device) -> torch.Tensor:
    """src[j] = the old channel copied into new channel j (group-aware)."""
    if new_c % old_c or old_c % groups:
        raise ValueError(f"cannot widen {old_c} -> {new_c} channels in {groups} groups")
    r, gs = new_c // old_c, old_c // groups
    j = torch.arange(new_c, device=device)
    return (j // (r * gs)) * gs + (j % (r * gs)) % gs


def _copy_mask(old_c: int, new_c: int, groups: int, device) -> torch.Tensor:
    """True at the new channels that are copies (q >= gs in each group)."""
    r, gs = new_c // old_c, old_c // groups
    return torch.arange(new_c, device=device) % (r * gs) >= gs


def _noisy(w, copy_mask, axis, generator, noise_scale):
    """``w`` plus relative noise (times the rms of ``w``) at the copies along
    ``axis``."""
    if noise_scale <= 0.0:
        return w
    shape = [1] * w.dim()
    shape[axis] = w.shape[axis]
    noise = torch.randn(w.shape, generator=generator, device=w.device, dtype=w.dtype) * noise_scale
    rms = torch.sqrt(w.square().mean() + 1e-12)
    return w + torch.where(copy_mask.view(shape), noise * rms, 0.0)


@torch.no_grad()
def widen_deepen(net: AZNet, new_config: AZNetConfig, generator: torch.Generator,
                 noise_scale: float = 1e-2) -> AZNet:
    """Net2Net: a new float32 ``AZNet(new_config)`` (same board; channels grown
    by an integer factor; blocks may grow) that computes, to ``noise_scale``,
    the same function as ``net``.  The new blocks' convolutions are drawn from
    ``generator`` (on ``net``'s device) as ``init_params`` draws them, and so
    is the noise."""
    old_config = net.config
    oc, nc = old_config.channels, new_config.channels
    if new_config.board_size != old_config.board_size:
        raise ValueError("widen_deepen keeps the board size")
    if nc % oc or new_config.blocks < old_config.blocks:
        raise ValueError("channels must grow by an integer factor and blocks must not shrink")
    r = nc // oc
    old = {k: v.to(torch.float32) for k, v in net.state_dict().items()}
    dev = old["stem.weight"].device
    src = _dup_index(oc, nc, _GROUPS, dev)
    cmask = _copy_mask(oc, nc, _GROUPS, dev)
    fresh = init_params(generator, new_config).state_dict()
    out = {}

    def widen_out(name):  # flax's trailing (output) axis
        return old[name].index_select(0, src) if r > 1 else old[name]

    def widen_in(w):  # flax's input axis -2, split 1/r, copies perturbed
        return _noisy(w.index_select(1, src) / r, cmask, 1, generator, noise_scale) if r > 1 else w

    for name in ("stem.weight", "stem_norm.weight", "stem_norm.bias"):
        out[name] = widen_out(name)
    for i in range(old_config.blocks):
        for j in (0, 1):
            conv = f"blocks.{i}.conv_{j}.weight"
            w = widen_in(old[conv])
            out[conv] = w.index_select(0, src) if r > 1 else w
            for part in ("weight", "bias"):
                out[f"blocks.{i}.norm_{j}.{part}"] = widen_out(f"blocks.{i}.norm_{j}.{part}")
    for i in range(old_config.blocks, new_config.blocks):
        for name in ("conv_0.weight", "norm_0.weight", "norm_0.bias", "conv_1.weight"):
            out[f"blocks.{i}.{name}"] = fresh[f"blocks.{i}.{name}"]
        # zero GroupNorm scale, not zero conv weights: a normalizer after a
        # zero tensor would blow the first update's O(lr) change up to unit
        # variance (the JAX package measured that collapse)
        out[f"blocks.{i}.norm_1.weight"] = torch.zeros_like(fresh[f"blocks.{i}.norm_1.weight"])
        out[f"blocks.{i}.norm_1.bias"] = torch.zeros_like(fresh[f"blocks.{i}.norm_1.bias"])
    # heads: the 1x1 convs consume the duplicated trunk; output widths fixed
    for conv in ("policy_conv", "value_conv"):
        out[f"{conv}.weight"] = widen_in(old[f"{conv}.weight"])
        out[f"{conv}.bias"] = old[f"{conv}.bias"]
    out["policy_out.weight"], out["policy_out.bias"] = old["policy_out.weight"], old["policy_out.bias"]
    # the value MLP's hidden width follows the channels: duplicate its units
    # (no normalizer there), split the last layer 1/r
    if r > 1:
        hsrc = torch.arange(oc, device=dev).repeat(r)
        is_copy = torch.arange(nc, device=dev) >= oc
        out["value_hidden.weight"] = _noisy(old["value_hidden.weight"].index_select(0, hsrc), is_copy, 0,
                                            generator, noise_scale)
        out["value_hidden.bias"] = old["value_hidden.bias"].index_select(0, hsrc)
        out["value_out.weight"] = old["value_out.weight"].index_select(1, hsrc) / r
    else:
        out["value_hidden.weight"], out["value_hidden.bias"] = old["value_hidden.weight"], old["value_hidden.bias"]
        out["value_out.weight"] = old["value_out.weight"]
    out["value_out.bias"] = old["value_out.bias"]
    grown = AZNet(new_config, torch.float32).to(dev)
    grown.load_state_dict(out, strict=True)
    return grown
