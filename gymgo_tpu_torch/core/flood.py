"""Fixed-point flood-fill primitives (counterpart of ``gymgo_tpu.core.flood``).

Every question the rules of Go ask of a group ("does it have a liberty?",
"exactly one?", "which colours does this empty region touch?") is a monotone
property propagated to a fixpoint through 4-connected components, so no group
labels are needed.

Conventions: planes are ``(..., N, N)``; leading batch dimensions are untouched.
Connectivity is 4-neighbour.

Two floods live here:

* ``flood_or``: a plain PyTorch loop that checks convergence on the host.  Only
  the stateless capture path of ``step_states`` uses it.
* the bundle flood: one packed int32 OR-flood per cell that yields the liberty
  classes, the Trump-Taylor claims and the atari encoding of every step.
  ``bundle_flood_plain`` is its plain PyTorch version; on a CUDA tensor
  ``flood_bundle`` runs the hand kernel of ``gymgo_tpu_torch.ops.bundle_flood``
  instead, which converges each board on its own without a host sync.
"""

from __future__ import annotations

import torch

__all__ = [
    "shift",
    "neighbor_or",
    "flood_or",
    "bundle_flood_plain",
    "unpack_bundle",
    "flood_bundle",
    "MAX_BUNDLE_CELLS",
]

# The bundle word's 9-bit liberty-code field holds flat index + 1 <= N*N.
MAX_BUNDLE_CELLS = (1 << 9) - 1
_MASK9 = (1 << 9) - 1
_BIT_A = 1 << 18
_BIT_B = 1 << 19
# (dr, dc) in the order of the JAX bitpack flood.
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
# Substeps between the plain floods' convergence checks (each check syncs
# with the host); substeps past the fixpoint are no-ops.
_UNROLL = 4


def shift(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Shift the last two dims of ``x`` by (dr, dc), filling vacated cells.

    out[..., i, j] = x[..., i - dr, j - dc] where in-bounds, else ``fill``.
    """
    n_r, n_c = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dr, 0):n_r + min(dr, 0), max(dc, 0):n_c + min(dc, 0)] = x[
        ..., max(-dr, 0):n_r - max(dr, 0), max(-dc, 0):n_c - max(dc, 0)
    ]
    return out


def neighbor_or(x: torch.Tensor) -> torch.Tensor:
    """Bitwise/logical OR over the 4 in-bounds neighbours of each cell."""
    out = shift(x, 1, 0, 0)
    for dr, dc in _DIRS[1:]:
        out |= shift(x, dr, dc, 0)
    return out


def flood_or(seed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """OR-propagate ``seed`` through 4-connected components of ``mask``.

    Returns the fixpoint f = mask & (seed | dilate(f)).  ``seed`` may be a bool
    plane or an integer bit-mask plane (independent floods per bit); ``mask``
    gates all bits.  Each convergence check reads a flag on the host, so this
    loop syncs with the device.
    """
    if seed.dtype == torch.bool:
        gate = mask
    else:
        gate = torch.where(mask, ~torch.zeros_like(seed), torch.zeros_like(seed))
    x = seed & gate
    while True:
        nx = x
        for _ in range(_UNROLL):
            nx = gate & (nx | neighbor_or(nx))
        if torch.equal(nx, x):
            return x
        x = nx


def _bundle_seed_and_gates(mover: torch.Tensor, opp: torch.Tensor):
    """The bundle flood's seed word and its four same-class direction gates."""
    n = mover.shape[-1]
    a = mover.bool()
    b = opp.bool()
    stones = a | b
    empty = ~stones
    code = torch.arange(1, n * n + 1, dtype=torch.int32, device=mover.device).reshape(n, n)
    packed_cell = torch.where(empty, code | ((~code & _MASK9) << 9), 0)
    lib_seed = torch.zeros_like(packed_cell)
    touch_a = torch.zeros_like(a)
    touch_b = torch.zeros_like(b)
    gates = []
    for dr, dc in _DIRS:
        lib_seed |= shift(packed_cell, dr, dc, 0)
        na = shift(a, dr, dc, False)
        nb = shift(b, dr, dc, False)
        ne = shift(empty, dr, dc, False)
        touch_a |= na
        touch_b |= nb
        gates.append((a & na) | (b & nb) | (empty & ne))
    seed = torch.where(stones, lib_seed, 0)
    seed |= (empty & touch_a).to(torch.int32) << 18
    seed |= (empty & touch_b).to(torch.int32) << 19
    return seed, gates


def bundle_flood_plain(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Converged bundle word, int32 ``(B, N, N)``; plain PyTorch version.

    Same function as ``gymgo_tpu.ops.pallas_flood.bundle_flood_pallas``:

      bits 0-8   OR of the codes idx+1 of the empty cells adjacent to the
                 stone's group (stones)
      bits 9-17  OR of those codes' 9-bit complements (stones)
      bit 18     the empty region touches ``mover`` (empties)
      bit 19     the empty region touches ``opp`` (empties)

    flooded within same-class runs (mover-mover, opp-opp, empty-empty) to the
    fixpoint.  The fixpoint is unique, so the order of propagation does not
    matter.  Checks convergence on the host, so it syncs with the device.
    """
    if mover.shape[-1] * mover.shape[-2] > MAX_BUNDLE_CELLS:
        raise ValueError(
            f"bundle flood needs N*N <= {MAX_BUNDLE_CELLS}, got {tuple(mover.shape)}"
        )
    x, gates = _bundle_seed_and_gates(mover, opp)
    while True:
        nx = x
        for _ in range(_UNROLL):
            for (dr, dc), gate in zip(_DIRS, gates):
                nx = nx | torch.where(gate, shift(nx, dr, dc, 0), 0)
        if torch.equal(nx, x):
            return x
        x = nx


def unpack_bundle(packed: torch.Tensor, color_a: torch.Tensor, color_b: torch.Tensor):
    """(one_lib, multi_lib, only_a, only_b, atari_enc) from the bundle word.

    A group has exactly one distinct liberty iff the OR of its liberty codes
    equals the AND (the complement of the complements' OR).  ``atari_enc`` is
    int16: the sole liberty's flat index + 1 on stones of one-liberty groups,
    else 0.
    """
    stones = color_a | color_b
    empty = ~stones
    or_bits = packed & _MASK9
    and_bits = ~(packed >> 9) & _MASK9
    has_lib = or_bits != 0
    one_lib = stones & has_lib & (or_bits == and_bits)
    multi_lib = stones & has_lib & (or_bits != and_bits)
    got_a = (packed & _BIT_A) != 0
    got_b = (packed & _BIT_B) != 0
    only_a = empty & got_a & ~got_b
    only_b = empty & got_b & ~got_a
    atari_enc = torch.where(one_lib, or_bits, 0).to(torch.int16)
    return one_lib, multi_lib, only_a, only_b, atari_enc


def flood_bundle(color_a: torch.Tensor, color_b: torch.Tensor):
    """Bundle flood of two bool stone planes, unpacked.

    CPU tensors take the plain version; CUDA tensors launch the hand kernel
    (which raises rather than falls back when it cannot run).
    """
    from gymgo_tpu_torch.ops.bundle_flood import bundle_flood

    return unpack_bundle(bundle_flood(color_a, color_b), color_a, color_b)
