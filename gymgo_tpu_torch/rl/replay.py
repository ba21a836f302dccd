"""Circular replay buffer for self-play training rows (counterpart of
``gymgo_tpu.rl.replay``).

Preallocated tensors on the device; ``add`` writes its rows in place and
``sample`` draws on the device, so neither syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymgo_tpu_torch.core.state import resolve_device

__all__ = ["ReplayState", "ReplayBuffer"]


class ReplayState(NamedTuple):
    obs: torch.Tensor  # (C, 6, N, N) int8
    policy: torch.Tensor  # (C, A) float32, A = N*N + 1, pass last
    value: torch.Tensor  # (C,) float32
    mask: torch.Tensor  # (C,) bool: row is a live-game step (trains the loss)
    vmask: torch.Tensor  # (C,) bool: row also trains the VALUE head (off for
    # truncated-tail rows under --value-grounded-only)
    cursor: torch.Tensor  # int64 0-d: next write slot
    filled: torch.Tensor  # int64 0-d: number of valid rows


class ReplayBuffer:
    def __init__(self, capacity: int, board_size: int, device=None):
        self.capacity = capacity
        self.board_size = board_size
        self.device = resolve_device(device)

    def init(self) -> ReplayState:
        n, c, dev = self.board_size, self.capacity, self.device
        return ReplayState(
            obs=torch.zeros((c, 6, n, n), dtype=torch.int8, device=dev),
            policy=torch.zeros((c, n * n + 1), dtype=torch.float32, device=dev),
            value=torch.zeros((c,), dtype=torch.float32, device=dev),
            mask=torch.zeros((c,), dtype=torch.bool, device=dev),
            vmask=torch.zeros((c,), dtype=torch.bool, device=dev),
            cursor=torch.zeros((), dtype=torch.int64, device=dev),
            filled=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def add(self, state: ReplayState, obs, policy, value, mask=None, vmask=None) -> ReplayState:
        """Append M rows at ``(cursor + arange(M)) % capacity``, in place into
        ``state``'s tensors; returns the state with the new cursor (advanced
        by M) and ``filled`` (clamped to the capacity).  Shapes: obs
        (M, 6, N, N), policy (M, A), value (M,), mask/vmask (M,) bool
        (defaults: all live, vmask = mask).  Dead rows (a game-boundary step
        under auto-reset) are stored but flagged, so the loss masks them out;
        vmask False keeps a row policy-only.

        When M exceeds the capacity only the last ``capacity`` rows are
        written, each at the slot it would have reached: a later row of the
        same add overwrites an earlier one there (what JAX's ``.at[].set``
        keeps on the CPU), and a scatter with repeated indices would leave
        the winner undefined on CUDA."""
        m = obs.shape[0]
        if mask is None:
            mask = torch.ones((m,), dtype=torch.bool, device=obs.device)
        if vmask is None:
            vmask = mask
        skip = max(m - self.capacity, 0)
        idx = (state.cursor + skip + torch.arange(m - skip, device=state.cursor.device)) % self.capacity
        state.obs[idx] = obs[skip:].to(torch.int8)
        state.policy[idx] = policy[skip:]
        state.value[idx] = value[skip:]
        state.mask[idx] = mask[skip:]
        state.vmask[idx] = vmask[skip:]
        return state._replace(
            cursor=(state.cursor + m) % self.capacity,
            filled=(state.filled + m).clamp_max(self.capacity),
        )

    def sample(self, state: ReplayState, generator: torch.Generator, batch_size: int, indices=None):
        """Uniform sample with replacement over ``[0, max(filled, 1))``:
        ``(obs, policy, value, mask, vmask)``.  The indices (int64
        ``(batch_size,)``) are drawn from ``generator`` unless given: one
        31-bit word each, scaled by multiply-and-shift on the device (bias
        below filled / 2^31)."""
        if indices is None:
            word = torch.randint(0, 1 << 31, (batch_size,), generator=generator,
                                 device=state.filled.device, dtype=torch.int64)
            indices = (word * state.filled.clamp_min(1)) >> 31
        indices = indices.to(device=state.obs.device, dtype=torch.int64)
        return (state.obs[indices], state.policy[indices], state.value[indices],
                state.mask[indices], state.vmask[indices])
