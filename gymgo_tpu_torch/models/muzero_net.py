"""MuZero's learned model for Go (Schrittwieser et al. 2020, arXiv:1911.08265,
Appendices E and F): a representation ``h``, a dynamics ``g`` and a
prediction ``f`` over a hidden state ``s`` of ``channels`` planes of the
board.

* ``h(obs)``: a 3x3 convolution of the 6 input planes to ``channels``,
  GroupNorm and relu, then ``blocks`` residual blocks (AZNet's tower), then
  ``scale``.
* ``g(s, a)``: the same tower over ``concat(s, plane(a))``, ``channels + 1``
  input planes, where ``plane(a)`` is one board plane with a 1 at the stone
  ``a`` plays (all zero for a pass), then ``scale``.
* ``f(s)``: AZNet's heads: a policy of ``N*N + 1`` logits and a tanh value,
  from the view of the player to move.

``scale(x) = (x - min x) / (max x - min x)`` over each board's every value
(the paper's "same range as the action input ([0, 1])"), in float32 with the
denominator clamped to at least ``SCALE_EPS``, rounded to the working type.
Board games have no reward head: the search backs up ``f``'s value alone.

The towers are built of ``az_net``'s ``ResBlock``, ``_conv`` and
``_norm_act``, so the forward is AZNet's: served on the card (a CUDA forward
that autograd does not record) channels-last with the hand GroupNorm +
relu (+ residual) kernel, the library's NCHW operations on the CPU and under
autograd.  On the served path ``g``'s first convolution takes the hidden
state's ``channels`` planes alone, as the tower's convolutions do (cuDNN's
NHWC kernels), and the action plane's part of it, its 3x3 filter stamped
at the played point and clipped at the edge, is added to the output
(``_stamp_``): the same sum, as the plane is 0 but at one point.

A search keeps the hidden state of every node of its tree in one store
(``latent_store``), one slot per node, each slot a ``(B, channels, N, N)``
view in the layout the towers produce, so ``represent`` and ``dynamics``
write their output into a slot (``out=``); ``dynamics_input`` gathers each
board's parent slot.  Training (the K-step unrolled
loss) is not part of the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.models.az_net import (_GN_EPS, _GROUPS, ResBlock, _conv, _conv3x3, _dense, _init_, _norm_act,
                                           refresh_)

__all__ = ["MuZeroNetConfig", "MuZeroNet", "SCALE_EPS", "scale", "action_plane", "init_params", "acting_copy"]

SCALE_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class MuZeroNetConfig:
    board_size: int
    channels: int = 256
    blocks: int = 15
    policy_channels: int = 2
    value_channels: int = 1
    value_hidden: int = 256
    dtype: torch.dtype = torch.bfloat16


def _served(x: torch.Tensor) -> bool:
    return x.is_cuda and not torch.is_grad_enabled()


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``(B, C*H*W)`` view of a ``(B, C, H, W)`` tensor in its memory order
    (contiguous or channels-last)."""
    if x.is_contiguous():
        return x.view(x.shape[0], -1)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # a view of a channels-last tensor


def scale(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``(x - min) / max(max - min, SCALE_EPS)`` per board over all of its
    values, in float32, rounded to ``x``'s type: into ``out`` (laid out as
    ``x``) when given.

    Into a type narrower than float32 (the served bfloat16) it is one pass,
    ``x / d - min / d``: its float32 result is the quotient's to two float32
    ulps, which the rounding to the narrower type absorbs, and it is 0 at the
    minimum and at most 1 at the maximum, so the rounded state lies in
    [0, 1].  Into float32 it is the quotient itself."""
    if out is None:
        out = torch.empty_like(x)
    rows = _rows(x)
    lo, hi = torch.aminmax(rows, dim=1)
    lo = lo.to(torch.float32)[:, None]
    den = (hi.to(torch.float32)[:, None] - lo).clamp_min(SCALE_EPS)
    if out.dtype == torch.float32:
        torch.div(rows - lo, den, out=_rows(out))
    else:
        torch.addcdiv(-lo / den, rows, den, out=_rows(out))
    return out


def action_plane(actions: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``(B, 1, N, N)``: 1 at the stone each action plays, none for a pass."""
    plane = torch.arange(n * n, device=actions.device) == actions.to(torch.int64)[:, None]
    return plane.view(-1, 1, n, n).to(dtype)


def _stamp_(h: torch.Tensor, taps: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Add to ``h`` (B, C, N, N), channels-last, a 3x3 convolution's part from
    the action plane: the plane is 1 at the played point alone, so output
    point (y + dy, x + dx) gains the tap (1 - dy, 1 - dx) of ``taps``
    (C, 3, 3), clipped at the edge; a pass adds nothing.  One addition a
    channel at each of at most 9 points a board, in ``h``'s type."""
    b, c, n, _ = h.shape
    k = torch.arange(9, device=h.device)
    dy, dx = k // 3 - 1, k % 3 - 1
    a = actions.to(torch.int64)[:, None]
    y, x = a // n + dy, a % n + dx
    on = (a < n * n) & (y >= 0) & (y < n) & (x >= 0) & (x < n)
    points = torch.where(on, (torch.arange(b, device=h.device)[:, None] * n + y) * n + x, 0).view(-1)
    values = torch.where(on[..., None], taps[:, 1 - dy, 1 - dx].T.to(h.dtype), 0).reshape(-1, c)
    # an index met twice gets a zero the second time: the sums are exact in any order
    h.permute(0, 2, 3, 1).view(b * n * n, c).index_add_(0, points, values)
    return h


class _Tower(nn.Module):
    """A 3x3 convolution of ``inputs`` planes to ``channels``, GroupNorm and
    relu, then ``blocks`` residual blocks."""

    def __init__(self, inputs: int, channels: int, blocks: int):
        super().__init__()
        self.stem = _conv3x3(inputs, channels)
        self.stem_norm = nn.GroupNorm(_GROUPS, channels, eps=_GN_EPS)
        self.blocks = nn.ModuleList(ResBlock(channels) for _ in range(blocks))

    def forward(self, x, served: bool):
        layout = torch.channels_last if served else torch.contiguous_format
        return self.body(_conv(self.stem, x, layout), served)

    def body(self, h, served: bool):
        """The tower after its first convolution's output ``h``."""
        x = _norm_act(self.stem_norm, h, served)
        for block in self.blocks:
            x = block(x, served)
        return x


class MuZeroNet(nn.Module):
    """``represent(states) -> s``, ``dynamics(s, actions) -> s'``,
    ``predict(s) -> (policy_logits float32 (B, N*N+1), value float32 (B,))``;
    ``forward(states)`` is ``predict(represent(states))``, so a caller of a
    network's forward (a greedy mover) runs ``f(h(obs))``.  States come in
    canonical form, as AZNet takes them.

    Parameters are held in ``param_dtype`` (default ``config.dtype``: a
    serving module, its convolution kernels channels-last); the last dense
    layer's in float32."""

    def __init__(self, config: MuZeroNetConfig, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        n, c = config.board_size, config.channels
        self.h = _Tower(govars.NUM_CHNLS, c, config.blocks)
        self.g = _Tower(c + 1, c, config.blocks)
        self.policy_conv = nn.Conv2d(c, config.policy_channels, 1)
        self.policy_out = nn.Linear(n * n * config.policy_channels, n * n + 1)
        self.value_conv = nn.Conv2d(c, config.value_channels, 1)
        self.value_hidden = nn.Linear(n * n * config.value_channels, config.value_hidden)
        self.value_out = nn.Linear(config.value_hidden, 1)
        self.to(param_dtype or config.dtype)
        self.value_out.to(torch.float32)
        if param_dtype is None:
            self.to(memory_format=torch.channels_last)

    def latent_store(self, slots: int, batch: int, device) -> torch.Tensor:
        """An uninitialised ``(slots, batch, channels, N, N)`` store of
        hidden states on ``device`` whose every slot is laid out as the
        towers' output there: channels-last on the served path."""
        c, n, dtype = self.config.channels, self.config.board_size, self.config.dtype
        if torch.device(device).type == "cuda" and not torch.is_grad_enabled():
            return torch.empty((slots, batch, n, n, c), dtype=dtype, device=device).permute(0, 1, 4, 2, 3)
        return torch.empty((slots, batch, c, n, n), dtype=dtype, device=device)

    def represent(self, states: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """``h``: the scaled hidden state of canonical ``states`` (B, 6, N, N)."""
        served = _served(states)
        layout = torch.channels_last if served else torch.contiguous_format
        x = self.h(states.to(self.config.dtype, memory_format=layout), served)
        return scale(x, out)

    def dynamics_input(self, store: torch.Tensor, parent: torch.Tensor, actions: torch.Tensor):
        """``g``'s inputs ``(s, actions)``: for each board b, slot
        ``parent[b]`` of ``store`` (its row b), gathered in the slots'
        layout, and its action."""
        slots, b, c, n, _ = store.shape
        rows = parent.to(torch.int64) * b + torch.arange(b, device=store.device)
        if store[0].is_contiguous():
            return store.reshape(slots * b, c, n, n).index_select(0, rows), actions
        raw = store.permute(0, 1, 3, 4, 2).reshape(slots * b, n, n, c)  # channels-last slots: their memory, a view
        return raw.index_select(0, rows).permute(0, 3, 1, 2), actions

    def dynamics_from_input(self, inputs, out: torch.Tensor | None = None) -> torch.Tensor:
        """``g`` of ``dynamics_input``'s ``(s, actions)``: the tower over
        ``concat(s, plane(a))``, then ``scale``.  The served path convolves
        ``s`` alone and adds the action plane's part by ``_stamp_``, so its
        first convolution is the tower's own shape."""
        s, actions = inputs
        if not _served(s):
            s = s.to(self.config.dtype)
            x = torch.cat([s, action_plane(actions, s.shape[-1], s.dtype)], dim=1)
            return scale(self.g(x, False), out)
        s = s.to(self.config.dtype, memory_format=torch.channels_last)
        # split at each call, so that a captured graph reads the weights refresh_ copies in later;
        # cuDNN pads a 257-plane input to 264 and runs it 1.5x slower (scripts/muzero_stem.py)
        weight, c = self.g.stem.weight, s.shape[1]
        h = F.conv2d(s, weight[:, :c].to(s.dtype, memory_format=torch.channels_last), padding=1)
        return scale(self.g.body(_stamp_(h, weight[:, c], actions), True), out)

    def dynamics(self, s: torch.Tensor, actions: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """``g(s, a)``: the scaled next hidden state of ``s`` (B, C, N, N)
        after ``actions`` (B,), flat ints with ``N*N`` the pass."""
        return self.dynamics_from_input((s, actions), out)

    def predict(self, s: torch.Tensor):
        """``f``: ``(policy_logits float32 (B, N*N+1), value float32 (B,))``."""
        layout = torch.channels_last if _served(s) else torch.contiguous_format
        p = F.relu(_conv(self.policy_conv, s, layout)).flatten(1)
        policy_logits = _dense(self.policy_out, p)
        v = F.relu(_conv(self.value_conv, s, layout)).flatten(1)
        v = F.relu(_dense(self.value_hidden, v))
        value = torch.tanh(_dense(self.value_out, v.to(torch.float32)))[:, 0]
        return policy_logits.to(torch.float32), value

    def forward(self, states: torch.Tensor):
        return self.predict(self.represent(states))


@torch.no_grad()
def init_params(generator: torch.Generator, config: MuZeroNetConfig) -> MuZeroNet:
    """A fresh ``MuZeroNet`` with float32 parameters on ``generator``'s
    device, drawn as ``az_net.init_params`` draws AZNet's: truncated
    ``lecun_normal`` kernels, zero biases, GroupNorm scale 1 and bias 0."""
    return _init_(MuZeroNet(config, torch.float32).to(generator.device), generator)


def acting_copy(net: MuZeroNet) -> MuZeroNet:
    """A frozen eval-mode copy of ``net`` with its parameters in
    ``config.dtype`` (search, self-play, evaluation)."""
    device = next(net.parameters()).device
    copy = MuZeroNet(net.config).to(device).eval().requires_grad_(False)
    return refresh_(copy, net)
