"""Plain float32 forward of the AlphaGo Zero network as the configuration
states it, in PyTorch.

A 3x3 convolution of the 6 input planes to ``channels``, GroupNorm(8, eps
1e-6) and relu; ``blocks`` residual blocks of two 3x3 convolutions, each
normed, relu between, the input added before the last relu; a policy head (1x1
convolution to ``policy_channels``, relu, flattened channel-major, dense to
N*N + 1 logits) and a value head (1x1 convolution to ``value_channels``,
relu, flattened, dense to ``channels`` with relu, dense to 1, tanh).  The
input is the state seen by the player to move: for white to move the colour
planes swap and the turn plane flips.

The weights are a dict of tensors under the names ``portbench.lib.weights``
gives them (the benchmark makes them; they are handed here cast to float32).
TF32 is switched off for the forward, so convolutions and matrix products
run in float32.  ``fp8=True`` is the control: every convolution and dense
layer takes its input and weight rounded to float8 e4m3, each tensor scaled
so that its largest magnitude maps to the format's largest value.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

GROUPS = 8
EPS = 1e-6
_FP8_MAX = 448.0


def canonical(states: torch.Tensor) -> torch.Tensor:
    """float32 planes of int8 states ``(B, 6, N, N)`` from the mover's view."""
    x = states.to(torch.float32)
    swapped = torch.cat([x[:, 1:2], x[:, 0:1], 1 - x[:, 2:3], x[:, 3:]], dim=1)
    white = (x[:, 2, 0, 0] != 0)[:, None, None, None]
    return torch.where(white, swapped, x)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = _FP8_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def forward(w: dict, states: torch.Tensor, fp8: bool = False):
    """``(policy_logits (B, N*N + 1), value (B,))``, float32."""
    q = _fp8 if fp8 else (lambda t: t)
    blocks = sum(1 for k in w if k.endswith(".conv_0.weight"))

    def conv(x, name, padding):
        bias = w.get(name + ".bias")
        return F.conv2d(q(x), q(w[name + ".weight"]), bias, padding=padding)

    def norm(x, name):
        return F.group_norm(x, GROUPS, w[name + ".weight"], w[name + ".bias"], EPS)

    def dense(x, name):
        return F.linear(q(x), q(w[name + ".weight"]), w[name + ".bias"])

    with _no_tf32():
        x = F.relu(norm(conv(canonical(states), "stem", 1), "stem_norm"))
        for i in range(blocks):
            h = F.relu(norm(conv(x, f"blocks.{i}.conv_0", 1), f"blocks.{i}.norm_0"))
            h = norm(conv(h, f"blocks.{i}.conv_1", 1), f"blocks.{i}.norm_1")
            x = F.relu(x + h)
        p = F.relu(conv(x, "policy_conv", 0)).flatten(1)
        logits = dense(p, "policy_out")
        v = F.relu(conv(x, "value_conv", 0)).flatten(1)
        v = F.relu(dense(v, "value_hidden"))
        value = torch.tanh(dense(v, "value_out"))[:, 0]
    return logits, value


def forward_blocks(w: dict, states: torch.Tensor, rows: int = 256):
    """``forward`` over ``states`` in blocks of ``rows``, on ``w``'s device."""
    dev = next(iter(w.values())).device
    logits, values = [], []
    for i in range(0, states.shape[0], rows):
        lg, v = forward(w, states[i:i + rows].to(dev))
        logits.append(lg)
        values.append(v)
    return torch.cat(logits), torch.cat(values)
