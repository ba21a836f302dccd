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
* ``dtype``.  The flax module keeps float32 parameters and casts them at every
  call; this module keeps its parameters in ``dtype`` (the same rounded
  values), computes GroupNorm's statistics in float32 as PyTorch does for
  bfloat16 inputs, and keeps the last dense layer in float32 as flax does.
  float32 agrees with flax to rounding; bfloat16 rounds at other places than
  XLA and is not bit-equal.

The convolutions and dense layers are PyTorch's: the JAX package computes them
with XLA outside any kernel of its own.  Tensor-parallel ``param_shardings``
waits for the port of ``parallel/``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gymgo_tpu_torch import govars

__all__ = ["AZNetConfig", "ResBlock", "AZNet"]

_GROUPS = 8
_GN_EPS = 1e-6  # flax.linen.GroupNorm's default


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


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_0 = _conv3x3(channels, channels)
        self.norm_0 = nn.GroupNorm(_GROUPS, channels, eps=_GN_EPS)
        self.conv_1 = _conv3x3(channels, channels)
        self.norm_1 = nn.GroupNorm(_GROUPS, channels, eps=_GN_EPS)

    def forward(self, x):
        h = F.relu(self.norm_0(self.conv_0(x)))
        h = self.norm_1(self.conv_1(h))
        return F.relu(x + h)


class AZNet(nn.Module):
    """Input: int8/float states ``(B, 6, N, N)``; output: ``(policy_logits
    float32 (B, N*N+1), value float32 (B,))``, the value from the view of the
    player to move in a canonical state."""

    def __init__(self, config: AZNetConfig):
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
        self.to(config.dtype)
        self.value_out.to(torch.float32)

    def forward(self, states: torch.Tensor):
        x = states.to(self.config.dtype)
        x = F.relu(self.stem_norm(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        p = F.relu(self.policy_conv(x)).flatten(1)
        policy_logits = self.policy_out(p)
        v = F.relu(self.value_conv(x)).flatten(1)
        v = F.relu(self.value_hidden(v))
        value = torch.tanh(self.value_out(v.to(torch.float32)))[:, 0]
        return policy_logits.to(torch.float32), value
