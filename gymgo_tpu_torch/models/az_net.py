"""AlphaZero-style convolutional policy/value network (counterpart of
``gymgo_tpu.models.az_net``).

The same architecture as the flax module, so the JAX package's checkpoints load
into it (``gymgo_tpu_torch.convert``): a 3x3 stem, ``blocks`` residual blocks of
conv + GroupNorm(8) + relu, a policy head (1x1 conv, flatten, dense to
``N*N + 1`` logits) and a value head (1x1 conv, flatten, dense, dense, tanh).

Where it differs from the flax module, and why the numbers still agree:

* Layout.  PyTorch convolves NCHW with OIHW kernels; flax NHWC with HWIO.  The
  heads here flatten ``(c, h, w)``, flax ``(h, w, c)``: the loader permutes
  the rows of the two dense kernels that follow a flatten, once, so no
  activation is permuted at run time.
* GroupNorm's epsilon is flax's 1e-6, not PyTorch's default 1e-5.
* ``dtype``.  Like the flax module, every layer computes in ``config.dtype``
  from parameters cast at the call, so a module can hold float32 master
  parameters for training (``init_params``, ``AZNet(config, torch.float32)``)
  and compute in bfloat16.  A serving module keeps its parameters in
  ``dtype`` (the same rounded values; the casts are then no-ops).  GroupNorm's
  statistics are computed in float32 as PyTorch does for bfloat16 inputs, and
  the last dense layer stays float32 as in flax.  float32 agrees with flax to
  rounding; bfloat16 rounds at other places than XLA and is not bit-equal.

The convolutions and dense layers are PyTorch's: the JAX package computes them
with XLA outside any kernel of its own.  ``param_shardings`` is the
tensor-parallel rule of the JAX package in this layout.

Served on the card (a CUDA forward that autograd does not record: search,
self-play, evaluation, GTP), the tower keeps its activations channels-last
(NHWC in memory, as the flax module), and each GroupNorm runs with the relu
and the residual add that follow it as one hand kernel
(``ops/group_norm_act.py``), the counterpart of XLA's fusion of those blocks.
A serving module holds its convolution kernels channels-last for that path,
so cuDNN converts no layout.  Every other forward (the CPU, and training with
autograd) runs the library's operations on NCHW activations.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.ops.group_norm_act import group_norm_act_cuda, group_norm_act_plain

__all__ = ["AZNetConfig", "ResBlock", "AZNet", "init_params", "acting_copy", "refresh_", "param_shardings",
           "shard_state_dict"]

_GROUPS = 8
_GN_EPS = 1e-6  # flax.linen.GroupNorm's default
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@dataclasses.dataclass(frozen=True)
class AZNetConfig:
    board_size: int
    channels: int = 128
    blocks: int = 6
    policy_channels: int = 8
    value_channels: int = 8
    dtype: torch.dtype = torch.bfloat16


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def _conv(conv: nn.Conv2d, x, layout: torch.memory_format):
    """``conv`` in the dtype of ``x`` (its parameters cast at the call), its
    kernel in ``layout``, the layout of ``x``."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype, memory_format=layout), bias, padding=conv.padding)


def _norm_act(norm: nn.GroupNorm, h, served: bool, residual=None):
    """``relu(norm(h) [+ residual])``: the hand kernel when ``served``, else
    the library's operations."""
    fn = group_norm_act_cuda if served else group_norm_act_plain
    return fn(h, norm.num_groups, norm.weight.to(h.dtype), norm.bias.to(h.dtype), norm.eps, residual)


def _dense(dense: nn.Linear, x):
    return F.linear(x, dense.weight.to(x.dtype), dense.bias.to(x.dtype))


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_0 = _conv3x3(channels, channels)
        self.norm_0 = nn.GroupNorm(_GROUPS, channels, eps=_GN_EPS)
        self.conv_1 = _conv3x3(channels, channels)
        self.norm_1 = nn.GroupNorm(_GROUPS, channels, eps=_GN_EPS)

    def forward(self, x, served: bool = False):
        layout = torch.channels_last if served else torch.contiguous_format
        h = _norm_act(self.norm_0, _conv(self.conv_0, x, layout), served)
        return _norm_act(self.norm_1, _conv(self.conv_1, h, layout), served, residual=x)


class AZNet(nn.Module):
    """Input: int8/float states ``(B, 6, N, N)``; output: ``(policy_logits
    float32 (B, N*N+1), value float32 (B,))``, the value from the view of the
    player to move in a canonical state.

    Parameters are held in ``param_dtype`` (default ``config.dtype``: a
    serving module, whose convolution kernels are channels-last); the last
    dense layer's in float32."""

    def __init__(self, config: AZNetConfig, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        n, c = config.board_size, config.channels
        self.stem = _conv3x3(govars.NUM_CHNLS, c)
        self.stem_norm = nn.GroupNorm(_GROUPS, c, eps=_GN_EPS)
        self.blocks = nn.ModuleList(ResBlock(c) for _ in range(config.blocks))
        self.policy_conv = nn.Conv2d(c, config.policy_channels, 1)
        self.policy_out = nn.Linear(n * n * config.policy_channels, n * n + 1)
        self.value_conv = nn.Conv2d(c, config.value_channels, 1)
        self.value_hidden = nn.Linear(n * n * config.value_channels, c)
        self.value_out = nn.Linear(c, 1)
        self.to(param_dtype or config.dtype)
        self.value_out.to(torch.float32)
        if param_dtype is None:
            self.to(memory_format=torch.channels_last)

    def forward(self, states: torch.Tensor):
        served = states.is_cuda and not torch.is_grad_enabled()
        layout = torch.channels_last if served else torch.contiguous_format
        x = states.to(self.config.dtype, memory_format=layout)
        x = _norm_act(self.stem_norm, _conv(self.stem, x, layout), served)
        for block in self.blocks:
            x = block(x, served)
        p = F.relu(_conv(self.policy_conv, x, layout)).flatten(1)
        policy_logits = _dense(self.policy_out, p)
        v = F.relu(_conv(self.value_conv, x, layout)).flatten(1)
        v = F.relu(_dense(self.value_hidden, v))
        value = torch.tanh(_dense(self.value_out, v.to(torch.float32)))[:, 0]
        return policy_logits.to(torch.float32), value


@torch.no_grad()
def init_params(generator: torch.Generator, config: AZNetConfig) -> AZNet:
    """A fresh ``AZNet`` with float32 parameters on ``generator``'s device,
    drawn as flax draws them: every conv and dense kernel from ``lecun_normal``
    (a normal truncated at two standard deviations, rescaled to variance
    1 / fan_in, fan_in = kh * kw * in for a conv and ``in`` for a dense
    layer), zero biases, GroupNorm scale 1 and bias 0."""
    net = AZNet(config, torch.float32).to(generator.device)
    for name, p in net.named_parameters():
        if p.dim() > 1:
            std = (1.0 / p[0].numel()) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif "norm" in name and name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return net


@torch.no_grad()
def refresh_(dst: AZNet, src: AZNet) -> AZNet:
    """Copy ``src``'s parameters into ``dst`` in place, each rounded to
    ``dst``'s dtype: the values flax computes with when it casts float32
    parameters at the call."""
    torch._foreach_copy_(list(dst.parameters()), list(src.parameters()))
    return dst


def acting_copy(net: AZNet) -> AZNet:
    """A frozen eval-mode copy of ``net`` with its parameters in
    ``config.dtype`` (self-play, evaluation, the frozen target network);
    ``refresh_`` brings it up to date after an update."""
    device = next(net.parameters()).device
    copy = AZNet(net.config).to(device).eval().requires_grad_(False)
    return refresh_(copy, net)


def param_shardings(net: nn.Module, mesh, model_axis: str = "model") -> dict:
    """Tensor-parallel sharding rule (``gymgo_tpu.models.az_net.param_shardings``):
    a tensor of two or more dims whose *output* dim divides over the model
    axis is split on it; everything else is replicated.  The output dim is
    dim 0 here (a conv's OIHW weight, a dense ``(out, in)`` weight), where flax
    keeps it last.  Returns ``{state_dict name: split dim or None}``."""
    axis = mesh.shape[model_axis]
    return {name: 0 if axis > 1 and p.dim() >= 2 and p.shape[0] % axis == 0 else None
            for name, p in net.state_dict().items()}


def shard_state_dict(state_dict: dict, shardings: dict, index: int, axis_size: int) -> dict:
    """The part of ``state_dict`` that model-axis index ``index`` of
    ``axis_size`` holds under ``shardings``: split tensors' blocks, views of
    the replicated ones."""
    out = {}
    for name, t in state_dict.items():
        dim = shardings[name]
        out[name] = t if dim is None else t.chunk(axis_size, dim=dim)[index]
    return out
