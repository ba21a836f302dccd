"""Plain float32 forward of MuZero's Go network as the configuration states
it, in PyTorch (the network part of the repository's test reference,
``tests/muzero_reference.py``).

``h`` (``represent``): a 3x3 convolution of the 6 input planes, seen by the
player to move (``aznet.canonical``), to ``channels``, GroupNorm(8, eps 1e-6)
and relu, ``blocks`` residual blocks of two 3x3 convolutions (each normed,
relu between, the input added before the last relu), then ``scale``.  ``g``
(``dynamics``): the same tower over the hidden state and one action plane (1
at the stone the action plays, none for a pass), then ``scale``.  ``f``
(``predict``): a policy head (1x1 convolution to ``policy_channels``, relu,
flattened channel-major, dense to N*N + 1 logits) and a value head (1x1
convolution to ``value_channels``, relu, flattened, dense to
``value_hidden`` with relu, dense to 1, tanh).  ``scale`` maps each board's
values onto [0, 1] by its minimum and range, the range clamped to at least
1e-5.

The weights are a dict of tensors under ``MuZeroNet``'s parameter names
(``lib/muzero_weights.py`` makes them, handed here in float32).  TF32 is
switched off, so convolutions and matrix products run in float32.
``fp8=True`` is the control, as ``aznet``'s: every convolution and dense
layer takes its input and weight rounded to float8 e4m3, each tensor scaled
so that its largest magnitude maps to the format's largest value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.aznet import EPS, GROUPS, _fp8, _no_tf32, canonical

SCALE_EPS = 1e-5


def scale(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(SCALE_EPS)


def _tower(w: dict, prefix: str, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    q = _fp8 if fp8 else (lambda t: t)
    blocks = sum(1 for k in w if k.startswith(prefix + ".blocks.") and k.endswith(".conv_0.weight"))

    def conv(x, name):
        return F.conv2d(q(x), q(w[f"{prefix}.{name}.weight"]), padding=1)

    def norm(x, name):
        return F.group_norm(x, GROUPS, w[f"{prefix}.{name}.weight"], w[f"{prefix}.{name}.bias"], EPS)

    x = F.relu(norm(conv(x, "stem"), "stem_norm"))
    for i in range(blocks):
        h = F.relu(norm(conv(x, f"blocks.{i}.conv_0"), f"blocks.{i}.norm_0"))
        h = norm(conv(h, f"blocks.{i}.conv_1"), f"blocks.{i}.norm_1")
        x = F.relu(x + h)
    return x


def action_plane(actions: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, 1, N, N)`` float32: 1 at the stone each action plays, none for a pass."""
    cells = torch.arange(n * n, device=actions.device)
    return (cells == actions.to(torch.int64)[:, None]).to(torch.float32).view(-1, 1, n, n)


@torch.no_grad()
def represent(w: dict, states: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """``h`` of int8 states ``(B, 6, N, N)``, float32 ``(B, C, N, N)``."""
    with _no_tf32():
        return scale(_tower(w, "h", canonical(states), fp8))


@torch.no_grad()
def dynamics(w: dict, s: torch.Tensor, actions: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """``g(s, a)`` of hidden states ``(B, C, N, N)`` and actions ``(B,)``."""
    with _no_tf32():
        x = torch.cat([s.to(torch.float32), action_plane(actions, s.shape[-1])], dim=1)
        return scale(_tower(w, "g", x, fp8))


@torch.no_grad()
def predict(w: dict, s: torch.Tensor, fp8: bool = False):
    """``f(s)``: ``(policy logits (B, N*N + 1), value (B,))``, float32."""
    q = _fp8 if fp8 else (lambda t: t)
    s = s.to(torch.float32)

    def conv(x, name):
        return F.conv2d(q(x), q(w[name + ".weight"]), w[name + ".bias"])

    def dense(x, name):
        return F.linear(q(x), q(w[name + ".weight"]), w[name + ".bias"])

    with _no_tf32():
        logits = dense(F.relu(conv(s, "policy_conv")).flatten(1), "policy_out")
        v = F.relu(dense(F.relu(conv(s, "value_conv")).flatten(1), "value_hidden"))
        value = torch.tanh(dense(v, "value_out"))[:, 0]
    return logits, value
