"""Fixed-point flood-fill primitives (counterpart of ``gymgo_tpu.core.flood``).

Every question the rules of Go ask of a group ("does it have a liberty?",
"exactly one?", "which colours does this empty region touch?") is a monotone
property propagated to a fixpoint through 4-connected components, so no group
labels are needed.

Conventions: planes are ``(..., N, N)``; leading batch dimensions are untouched.
Connectivity is 4-neighbour.

The floods, each with a plain PyTorch version that checks convergence on the
host every few substeps:

* ``flood_or``: an OR-flood through a mask; the stateless capture path of
  ``step_states`` uses it on CPU tensors.
* the claim flood: which colours each empty region touches, a two-bit
  ``flood_or`` of the empty cells.  ``claim_flood_plain`` is its plain
  version; on a CUDA tensor the minmax route and the score of boards over
  22x22 run the hand kernel of ``gymgo_tpu_torch.ops.claim_flood`` instead.
* the bundle flood: one packed int32 OR-flood per cell that yields the liberty
  classes, the Trump-Taylor claims and the atari encoding of every step.
  ``bundle_flood_plain`` is its plain version; on a CUDA tensor
  ``flood_bundle`` runs the hand kernel of ``gymgo_tpu_torch.ops.bundle_flood``
  instead.
* the min/max liberty flood: per stone, the least and greatest flat index of
  its group's liberties.  ``minmax_flood_plain`` is its plain version; on a
  CUDA tensor ``liberty_classes_from_minmax`` runs the hand kernel of
  ``gymgo_tpu_torch.ops.minmax_flood`` instead.

The kernels converge each board on its own without a host sync.

The size rule.  ``bundle_fits`` decides which flood a board takes: boards
whose cell codes the bundle word holds (N*N <= ``MAX_BUNDLE_CELLS``, up to
22x22) the bundle flood, larger ones the minmax route (the min/max
classification plus the claim flood), on CPU and CUDA tensors alike; the
card's kernels take boards up to ``MAX_KERNEL_BOARD`` (``capturable``).
"""

from __future__ import annotations

import torch

__all__ = [
    "shift",
    "neighbor_or",
    "neighbor_min",
    "neighbor_max",
    "neighbor_count_edge1",
    "flood_or",
    "flood_or_unrolled",
    "claim_flood_plain",
    "flood_min_max_two_colors",
    "flood_min_max_two_colors_unrolled",
    "minmax_seeds",
    "minmax_flood_plain",
    "liberty_classes_from_minmax",
    "liberty_classes_bitpack",
    "bundle_seed_and_gates",
    "bundle_substep",
    "bundle_flood_plain",
    "unpack_bundle",
    "flood_bundle",
    "flood_bundle_from_parts",
    "flood_or_best",
    "liberty_classification_best",
    "flood_bundle_best",
    "bundle_fits",
    "capturable",
    "capturable_states",
    "MAX_BUNDLE_CELLS",
    "MAX_KERNEL_BOARD",
]

# The bundle word's 9-bit liberty-code field holds flat index + 1 <= N*N.
MAX_BUNDLE_CELLS = (1 << 9) - 1
# The largest board the card's kernels take: the min/max and claim kernels'
# int16 indices stop at 181x181, as the JAX package's do.
MAX_KERNEL_BOARD = 181
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


def neighbor_min(x: torch.Tensor, big) -> torch.Tensor:
    """Min over the 4 in-bounds neighbours; out-of-bounds contributes ``big``."""
    out = shift(x, 1, 0, big)
    for dr, dc in _DIRS[1:]:
        out = torch.minimum(out, shift(x, dr, dc, big))
    return out


def neighbor_max(x: torch.Tensor, small) -> torch.Tensor:
    """Max over the 4 in-bounds neighbours; out-of-bounds contributes ``small``."""
    out = shift(x, 1, 0, small)
    for dr, dc in _DIRS[1:]:
        out = torch.maximum(out, shift(x, dr, dc, small))
    return out


def neighbor_count_edge1(x: torch.Tensor) -> torch.Tensor:
    """int8 count of set 4-neighbours, counting out-of-bounds as set (the
    reference's edge-as-wall convolution): 4 means fully surrounded by stones
    and/or board edges."""
    x8 = x.to(torch.int8)
    out = shift(x8, 1, 0, 1)
    for dr, dc in _DIRS[1:]:
        out += shift(x8, dr, dc, 1)
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


# JAX's flood_or_unrolled: the same fixpoint with fused substeps, which
# flood_or already runs.
flood_or_unrolled = flood_or


def flood_min_max_two_colors(seed_min, seed_max, color_a, color_b, big: int):
    """Propagate per-stone (min, max) values within same-colour components.

    ``color_a``/``color_b`` are disjoint bool stone planes.  Propagation runs
    only between 4-adjacent cells of the same colour; other cells keep their
    seeds.  Seeded with the min/max flat index of each stone's adjacent empty
    cells (``big`` / -1 when none), the fixpoint gives every stone the min/max
    over its group's distinct liberties: ``mn == big`` no liberty, ``mn == mx``
    exactly one, ``mn < mx`` two or more.  One colour after the other per
    iteration, as in JAX; checks convergence on the host every iteration.
    """

    def one_color(mn, mx, color):
        nmn = neighbor_min(torch.where(color, mn, big), big)
        nmx = neighbor_max(torch.where(color, mx, -1), -1)
        return (torch.where(color, torch.minimum(mn, nmn), mn),
                torch.where(color, torch.maximum(mx, nmx), mx))

    mn, mx = seed_min, seed_max
    while True:
        mn2, mx2 = one_color(mn, mx, color_a)
        mn2, mx2 = one_color(mn2, mx2, color_b)
        if torch.equal(mn2, mn) and torch.equal(mx2, mx):
            return mn, mx
        mn, mx = mn2, mx2


def flood_min_max_two_colors_unrolled(seed_min, seed_max, color_a, color_b, big: int,
                                      unroll: int = _UNROLL):
    """Same fixpoint as ``flood_min_max_two_colors``, in int16 with the four
    same-colour direction gates computed once, Gauss-Seidel within a substep
    (later directions see earlier updates), and a host convergence check
    every ``unroll`` substeps.  Returns the seeds' dtype."""
    in_dtype = seed_min.dtype
    mn = seed_min.to(torch.int16)
    mx = seed_max.to(torch.int16)
    same = [(color_a & shift(color_a, dr, dc, False)) | (color_b & shift(color_b, dr, dc, False))
            for dr, dc in _DIRS]
    while True:
        nmn, nmx = mn, mx
        for _ in range(unroll):
            for (dr, dc), same_d in zip(_DIRS, same):
                nmn = torch.minimum(nmn, torch.where(same_d, shift(nmn, dr, dc, big), big))
                nmx = torch.maximum(nmx, torch.where(same_d, shift(nmx, dr, dc, -1), -1))
        if torch.equal(nmn, mn) and torch.equal(nmx, mx):
            return mn.to(in_dtype), mx.to(in_dtype)
        mn, mx = nmn, nmx


def minmax_seeds(color_a: torch.Tensor, color_b: torch.Tensor, n: int):
    """int32 (seed_min, seed_max): per cell, the min/max flat index of its
    empty 4-neighbours, N*N / -1 when none."""
    big = n * n
    empty = ~(color_a | color_b)
    cell_idx = torch.arange(big, dtype=torch.int32, device=color_a.device).view(n, n)
    return (neighbor_min(torch.where(empty, cell_idx, big), big),
            neighbor_max(torch.where(empty, cell_idx, -1), -1))


def minmax_flood_plain(mover: torch.Tensor, opp: torch.Tensor):
    """``(mn, mx)`` int16 ``(B, N, N)``; plain PyTorch version.

    Same function as ``gymgo_tpu.ops.pallas_flood.minmax_liberty_flood_pallas``:
    the seeds of ``liberty_classes_from_minmax`` flooded by
    ``flood_min_max_two_colors_unrolled``.  Cells that are not stones keep
    their seeds.  Checks convergence on the host, so it syncs with the device.
    """
    a, b = mover.bool(), opp.bool()
    n = a.shape[-1]
    seed_min, seed_max = minmax_seeds(a, b, n)
    return flood_min_max_two_colors_unrolled(
        seed_min.to(torch.int16), seed_max.to(torch.int16), a, b, n * n)


def liberty_classes_from_minmax(color_a: torch.Tensor, color_b: torch.Tensor,
                                n: int | None = None, minmax_fn=None):
    """(one_lib, multi_lib, atari_enc) from a (min, max) liberty flood.

    ``minmax_fn(seed_min, seed_max, color_a, color_b, big)`` floods the seeds
    built here, as in JAX.  Without it, ``ops.minmax_flood.minmax_flood``
    builds the same seeds itself: the hand kernel on CUDA tensors,
    ``minmax_flood_plain`` on CPU tensors.  ``atari_enc`` is int16: the sole
    liberty's flat index + 1 on stones of one-liberty groups, else 0.
    """
    n = color_a.shape[-1] if n is None else n
    big = n * n
    if minmax_fn is None:
        from gymgo_tpu_torch.ops.minmax_flood import minmax_flood

        mn, mx = minmax_flood(color_a, color_b)
    else:
        mn, mx = minmax_fn(*minmax_seeds(color_a, color_b, n), color_a, color_b, big)
    stones = color_a | color_b
    one_lib = stones & (mn < big) & (mn == mx)
    multi_lib = stones & (mn < mx)
    atari_enc = torch.where(one_lib, (mn + 1).to(torch.int16), 0)
    return one_lib, multi_lib, atari_enc


def bundle_seed_and_gates(mover: torch.Tensor, opp: torch.Tensor):
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


def bundle_substep(x: torch.Tensor, gates, reverse: bool = False) -> torch.Tensor:
    """One substep of the bundle flood: each direction in turn (later ones see
    the earlier ones' updates) ORs into a cell the word of its neighbour in
    that direction, within same-class runs.  ``gates`` are
    ``bundle_seed_and_gates``' four; the order is JAX's forward one, or its
    reverse."""
    steps = list(zip(_DIRS, gates))
    for (dr, dc), gate in (reversed(steps) if reverse else steps):
        x = x | torch.where(gate, shift(x, dr, dc, 0), 0)
    return x


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
    x, gates = bundle_seed_and_gates(mover, opp)
    while True:
        nx = x
        for _ in range(_UNROLL):
            nx = bundle_substep(nx, gates)
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


def liberty_classes_bitpack(color_a: torch.Tensor, color_b: torch.Tensor):
    """(one_lib, multi_lib, atari_enc) from the bundle flood.

    JAX's ``liberty_classes_bitpack`` floods only the stone fields of the
    bundle word; stones never propagate to or from empty cells, so those
    fields equal the bundle flood's, and its unpacked outputs 0, 1 and 4 are
    these classes.
    """
    one_lib, multi_lib, _, _, atari_enc = flood_bundle(color_a, color_b)
    return one_lib, multi_lib, atari_enc


def claim_flood_plain(color_a: torch.Tensor, color_b: torch.Tensor) -> torch.Tensor:
    """uint8 ``(B, N, N)``: on each empty cell, bit 0 if its empty region
    touches ``color_a``, bit 1 if it touches ``color_b``; 0 on stones.  Plain
    PyTorch version of ``ops.claim_flood``'s kernel: the two-bit touch word of
    JAX's ``flood_bundle_from_parts`` flooded by ``flood_or_best``, which
    checks its convergence on the host."""
    a, b = color_a.bool(), color_b.bool()
    empty = ~(a | b)
    touch = (empty & neighbor_or(a)).to(torch.uint8)
    touch |= (empty & neighbor_or(b)).to(torch.uint8) << 1
    return flood_or_best(touch, empty)


def flood_bundle_from_parts(color_a: torch.Tensor, color_b: torch.Tensor):
    """The bundle flood's five outputs from the minmax route: the min/max
    liberty classification plus the claim flood of the empty regions (each
    a hand kernel on CUDA tensors, with no host sync)."""
    from gymgo_tpu_torch.ops.claim_flood import claim_flood

    one_lib, multi_lib, atari_enc = liberty_classes_from_minmax(color_a, color_b)
    claims = claim_flood(color_a, color_b)
    return one_lib, multi_lib, claims == 1, claims == 2, atari_enc


# The JAX package floods claims with an OR-flood of the same fixpoint on its
# bundle and minmax routes alike: flood_or_unrolled.
flood_or_best = flood_or_unrolled


def bundle_fits(n: int) -> bool:
    """True when N x N boards take the bundle flood: their cell codes fit
    the bundle word (N*N <= ``MAX_BUNDLE_CELLS``, up to 22x22).  Larger
    boards take the minmax route."""
    return n * n <= MAX_BUNDLE_CELLS


def liberty_classification_best(color_a: torch.Tensor, color_b: torch.Tensor):
    """(one_lib, multi_lib, atari_enc) by the flood ``bundle_fits`` picks."""
    if bundle_fits(color_a.shape[-1]):
        return liberty_classes_bitpack(color_a, color_b)
    return liberty_classes_from_minmax(color_a, color_b)


def flood_bundle_best(color_a: torch.Tensor, color_b: torch.Tensor):
    """The bundle flood's five outputs by the flood ``bundle_fits`` picks."""
    if bundle_fits(color_a.shape[-1]):
        return flood_bundle(color_a, color_b)
    return flood_bundle_from_parts(color_a, color_b)


def capturable(board_size: int) -> bool:
    """True when the step, the rollout and the area score of ``board_size``
    boards run on the card's kernels, which make no host sync, so a CUDA
    graph may hold them (N <= ``MAX_KERNEL_BOARD``); larger boards run
    eagerly, where the kernels raise."""
    return board_size <= MAX_KERNEL_BOARD


def capturable_states(arguments: dict) -> bool:
    """The ``when`` of a compiled function of ``states``: ``capturable`` of
    their board size."""
    return capturable(arguments["states"].shape[-1])
