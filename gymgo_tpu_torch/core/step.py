"""The batched Go state transition (counterpart of ``gymgo_tpu.core.step``).

Per-env semantics of the reference's single-state ``next_state``: pass
bookkeeping and the double-pass end, stone placement, captures, simple ko, the
invalid-move mask with the suicide rule, and the turn flip.  An env that is
already done, or whose action is invalid, is left unchanged ("frozen") and
flagged in ``StepInfo``.

Algorithm (the same as the JAX package's, so results agree bit for bit):

* Captures: with the carried ``atari`` plane, an opponent group dies iff its
  sole liberty is the point just played.  Without it, CPU tensors take the
  JAX package's stateless path, a plain OR-flood of "touches an empty cell"
  through the opponent's stones.  CUDA tensors classify the board before the
  move with one launch of the selected route's kernel instead: a group dies
  iff its sole liberty is the point played or it stands without a liberty
  already (a hand-made board), which is what that flood finds.
* One flood of the post-capture board, by the route ``core.flood`` selects
  (``flood_bundle_best``: the bundle flood by default, else the minmax
  route), classifies every group by its number of distinct liberties
  (0 / 1 / >= 2), claims empty regions for Trump-Taylor areas and yields the
  next step's ``atari`` plane.
* One packed uint8 dilation turns the classes into the next player's invalid
  mask (suicide rule) and the next step's ko-surround map.

Ablation.  ``GYMGO_ABLATE`` (read at import, a comma list, as in the JAX
package) names step components to skip so that the step's cost can be taken
apart: ``hit`` (the invalid-move probe), ``ko`` (the ko probe), ``capsum``
(the capture count and the ko point), ``bundle`` (the post-move flood; the
stateless CUDA path still classifies the board before the move), ``areas``
(the area sums) and ``invd`` (the invalid-mask dilation).  Each puts in the
JAX package's stand-in values, so an ablated step is wrong by design but
equal to the JAX package's ablated step.  ``set_ablate`` switches them inside
a process; ``rollout`` reads ``sampler`` too (all actions 0).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.core import flood as _flood
from gymgo_tpu_torch.core.flood import flood_or, neighbor_or, shift
from gymgo_tpu_torch.utils import tracing

__all__ = [
    "StepInfo",
    "PlanesState",
    "step_states",
    "step_planes",
    "planes_from_states",
    "states_from_planes",
    "invalid_action_flags",
    "init_atari",
    "init_ko_surr",
    "ABLATE_TOKENS",
    "set_ablate",
]

# The GYMGO_ABLATE tokens: the step's six, and the rollout's sampler.
ABLATE_TOKENS = ("hit", "ko", "capsum", "bundle", "areas", "invd", "sampler")
ablate = frozenset(x for x in os.environ.get("GYMGO_ABLATE", "").split(",") if x)


def set_ablate(tokens) -> frozenset:
    """Skip the step components named in ``tokens`` (an iterable of
    ``ABLATE_TOKENS``; empty restores the whole step) in every later step of
    the process; returns the set in force before.  Results are wrong by
    design while any is set."""
    global ablate
    tokens = frozenset(tokens)
    unknown = tokens.difference(ABLATE_TOKENS)
    if unknown:
        raise ValueError(f"unknown GYMGO_ABLATE tokens {sorted(unknown)}; known: {ABLATE_TOKENS}")
    previous, ablate = ablate, tokens
    return previous


class StepInfo(NamedTuple):
    """Per-env diagnostics of one step."""

    invalid_action: torch.Tensor  # bool (B,): move hit INVD_CHNL or out of range
    was_done: torch.Tensor  # bool (B,): env was already finished at entry
    num_captured: torch.Tensor  # int32 (B,): opponent stones removed this step
    black_area: torch.Tensor  # int32 (B,): Trump-Taylor area of the result state
    white_area: torch.Tensor  # int32 (B,): (frozen envs report their unchanged state)


class PlanesState(NamedTuple):
    """The env state as separate planes, carried through a rollout.

    TURN/PASS/DONE are per-env bits rather than whole planes.  ``atari`` (int16
    ``(B, N, N)``: per stone, its group's sole liberty's flat index + 1 when the
    group is in atari, else 0) and ``ko_surr`` (bool ``(B, N, N)``: every
    in-bounds neighbour holds a stone of the player who is the opponent on the
    next step) are optional carried planes; ``None`` selects the stateless
    computation.  Both are consistent when zero-filled on auto-reset.
    """

    black: torch.Tensor  # bool (B, N, N)
    white: torch.Tensor  # bool (B, N, N)
    invd: torch.Tensor  # bool (B, N, N)
    white_to_move: torch.Tensor  # bool (B,)
    prev_passed: torch.Tensor  # bool (B,)
    done: torch.Tensor  # bool (B,)
    atari: Optional[torch.Tensor] = None
    ko_surr: Optional[torch.Tensor] = None


def planes_from_states(states: torch.Tensor) -> PlanesState:
    """Split int8 ``(B, 6, N, N)`` states into fresh planes (never views of
    ``states``, so a rollout may update them in place)."""
    return PlanesState(
        black=states[:, govars.BLACK] != 0,
        white=states[:, govars.WHITE] != 0,
        invd=states[:, govars.INVD_CHNL] != 0,
        white_to_move=states[:, govars.TURN_CHNL, 0, 0] != 0,
        prev_passed=states[:, govars.PASS_CHNL, 0, 0] != 0,
        done=states[:, govars.DONE_CHNL, 0, 0] != 0,
    )


def states_from_planes(ps: PlanesState, dtype=torch.int8) -> torch.Tensor:
    b, n, _ = ps.black.shape

    def plane(v):
        return v[:, None, None].expand(b, n, n)

    return torch.stack(
        [
            ps.black,
            ps.white,
            plane(ps.white_to_move),
            ps.invd,
            plane(ps.prev_passed),
            plane(ps.done),
        ],
        dim=1,
    ).to(dtype)


def _surrounded_by(stones: torch.Tensor) -> torch.Tensor:
    """Per cell: every in-bounds neighbour is in ``stones``."""
    out = shift(stones, 1, 0, True)
    for dr, dc in ((-1, 0), (0, 1), (0, -1)):
        out &= shift(stones, dr, dc, True)
    return out


def init_ko_surr(ps: PlanesState) -> torch.Tensor:
    """Seed the carried ko-surround map for an arbitrary board."""
    opp = torch.where(ps.white_to_move[:, None, None], ps.black, ps.white)
    return _surrounded_by(opp)


def init_atari(ps: PlanesState) -> torch.Tensor:
    """Seed the carried atari encoding for an arbitrary board (one liberty
    classification of the selected route; every later ``step_planes``
    refreshes it for free)."""
    with tracing.span("env.flood"):
        return _flood.liberty_classification_best(ps.black.contiguous(), ps.white.contiguous())[2]


def _killed_by_classes(black, white, opp, board_idx):
    """Opponent stones that a stone at ``board_idx`` removes, from one liberty
    classification of the board before the move (no host sync on CUDA
    tensors): groups whose sole liberty is that point, and groups that stand
    without a liberty already.  Equal to the flood of the board after the
    move, since the move takes away that one empty cell and no other."""
    with tracing.span("env.flood"):
        one_lib, multi_lib, atari = _flood.liberty_classification_best(black.contiguous(), white.contiguous())
    placed_enc = (board_idx + 1).to(torch.int16)[:, None, None]
    return opp & ((atari == placed_enc) | ~(one_lib | multi_lib))


def invalid_action_flags(states: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """bool (B,): action is out of range, or a board move into INVD_CHNL."""
    b, n = states.shape[0], states.shape[-1]
    pass_idx = n * n
    actions = actions.to(torch.int64)
    oob = (actions < 0) | (actions > pass_idx)
    is_pass = actions == pass_idx
    flat_invd = states[:, govars.INVD_CHNL].reshape(b, -1)
    hit = flat_invd.gather(1, actions.clamp(0, pass_idx - 1)[:, None])[:, 0] != 0
    return oob | (~is_pass & hit)


def step_planes(ps: PlanesState, actions: torch.Tensor):
    """Core transition on the planes state; see ``step_states``.

    On CUDA tensors it makes no host sync on the default route, with or
    without the carried planes.  On CPU tensors without ``atari`` the capture
    flood is the plain ``flood_or``, which checks its convergence on the host.
    Runs under the span ``env.rules``, its flood under ``env.flood`` and its
    area sums under ``env.score`` (``utils.tracing``).
    """
    with tracing.span("env.rules"):
        return _step_planes(ps, actions)


def _step_planes(ps: PlanesState, actions: torch.Tensor):
    b, n, _ = ps.black.shape
    m = n * n
    dev = ps.black.device
    black, white = ps.black, ps.white
    white_to_move, prev_passed, done = ps.white_to_move, ps.prev_passed, ps.done

    actions = actions.to(device=dev, dtype=torch.int64)
    is_pass = actions == m
    oob = (actions < 0) | (actions > m)
    board_idx = actions.clamp(0, m - 1)
    not_pass = ~is_pass
    np3 = not_pass[:, None, None]
    place = (
        torch.zeros((b, m), dtype=torch.bool, device=dev)
        .scatter_(1, board_idx[:, None], not_pass[:, None])
        .view(b, n, n)
    )

    def at_place(plane):
        return plane.reshape(b, m).gather(1, board_idx[:, None])[:, 0] & not_pass

    invalid_action = oob if "hit" in ablate else oob | at_place(ps.invd)

    wtm = white_to_move[:, None, None]
    mover = torch.where(wtm, white, black) | place
    opp = torch.where(wtm, black, white)

    # Ko probe, pre-capture: every in-bounds neighbour of the move is an
    # opponent stone.
    if "ko" in ablate:
        surrounded_pre = is_pass
    elif ps.ko_surr is not None:
        surrounded_pre = at_place(ps.ko_surr)
    else:
        surrounded_pre = at_place(_surrounded_by(opp))

    if ps.atari is not None:
        placed_enc = (board_idx + 1).to(torch.int16)[:, None, None]
        killed = opp & (ps.atari == placed_enc)
    elif black.is_cuda:
        killed = _killed_by_classes(black, white, opp, board_idx)
    else:
        killed = opp & ~flood_or(opp & neighbor_or(~(mover | opp)), opp)
    killed = killed & np3
    opp = opp & ~killed

    # Frozen envs flood their unchanged board, so the areas and carried
    # planes describe the state every env keeps.
    frozen = done | invalid_action
    fz = frozen[:, None, None]
    mover = torch.where(fz, black, mover)
    opp = torch.where(fz, white, opp)
    mover_is_white = white_to_move & ~frozen

    all_pieces = mover | opp
    empty = ~all_pieces
    cell_idx = torch.arange(m, dtype=torch.int32, device=dev).view(n, n)

    # Capture count (bits 18+) and the sole captured cell's index (bits 0-17)
    # in one reduction; the index is exact whenever one stone died, the only
    # case ko reads it.
    if "capsum" in ablate:
        num_captured = ko_flat = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        kill_word = torch.where(killed, cell_idx + (1 << 18), 0)
        kill_sum = kill_word.view(b, m).sum(1, dtype=torch.int32)
        num_captured = kill_sum >> 18
        ko_flat = kill_sum & ((1 << 18) - 1)
    ko_active = (num_captured == 1) & surrounded_pre

    if "bundle" in ablate:
        one_lib, multi_lib, only_mover, only_opp = all_pieces, empty, empty, empty
        atari_enc = torch.zeros((b, n, n), dtype=torch.int16, device=dev)
    else:
        with tracing.span("env.flood"):
            one_lib, multi_lib, only_mover, only_opp, atari_enc = _flood.flood_bundle_best(
                mover.contiguous(), opp.contiguous()
            )

    with tracing.span("env.score"):
        if "areas" in ablate:
            mover_area = opp_area = torch.zeros((b,), dtype=torch.int32, device=dev)
        else:
            # Both Trump-Taylor areas in one reduction (area <= N*N < 2^10).
            area_word = ((mover | only_mover).to(torch.int32) << 10) | (opp | only_opp).to(torch.int32)
            area_sum = area_word.view(b, m).sum(1, dtype=torch.int32)
            mover_area = area_sum >> 10
            opp_area = area_sum & ((1 << 10) - 1)
        black_area = torch.where(mover_is_white, opp_area, mover_area)
        white_area = torch.where(mover_is_white, mover_area, opp_area)

    white_to_move_next = white_to_move ^ ~frozen

    if "invd" in ablate:
        invd = all_pieces
        ko_surr_next = torch.zeros_like(black)
    else:
        # One packed uint8 dilation: bits 0 atari_mover, 1 multi_mover, 2
        # atari_opp, 3 multi_opp, 4 empty, 5 non-mover, 6 non-opp.  A clear
        # dilated bit 4 means no in-bounds neighbour is empty (the reference's
        # edge-as-wall surround test); clear bits 5/6 mean every in-bounds
        # neighbour is a mover / opp stone (next step's ko-surround map).
        cls = one_lib.to(torch.uint8) | (multi_lib.to(torch.uint8) << 1)
        packed_cls = torch.where(mover, cls, torch.where(opp, cls << 2, 16))
        packed_cls |= ((~mover).to(torch.uint8) << 5) | ((~opp).to(torch.uint8) << 6)
        dil = neighbor_or(packed_cls)
        possible = empty & ((dil & 6) != 0)  # next to multi_mover | atari_opp
        definite = (dil & 9) != 0  # next to atari_mover | multi_opp
        surrounded_cells = (dil & 16) == 0
        invd = all_pieces | (possible & ~definite & surrounded_cells)
        invd |= (cell_idx == ko_flat[:, None, None]) & ko_active[:, None, None]
        all_nb_mover = (dil & 32) == 0
        all_nb_opp = (dil & 64) == 0
        miw = mover_is_white[:, None, None]
        all_nb_black = torch.where(miw, all_nb_opp, all_nb_mover)
        all_nb_white = torch.where(miw, all_nb_mover, all_nb_opp)
        # the next step's opponent is black iff white moves next
        ko_surr_next = torch.where(white_to_move_next[:, None, None], all_nb_black, all_nb_white)

    new_ps = PlanesState(
        black=torch.where(fz, black, torch.where(wtm, opp, mover)),
        white=torch.where(fz, white, torch.where(wtm, mover, opp)),
        invd=torch.where(fz, ps.invd, invd),
        white_to_move=white_to_move_next,
        prev_passed=torch.where(frozen, prev_passed, is_pass),
        done=torch.where(frozen, done, done | (prev_passed & is_pass)),
        atari=None if ps.atari is None else atari_enc,
        ko_surr=None if ps.ko_surr is None else ko_surr_next,
    )
    info = StepInfo(
        invalid_action=invalid_action,
        was_done=done,
        num_captured=torch.where(frozen, 0, num_captured),
        black_area=black_area,
        white_area=white_area,
    )
    return new_ps, info


def step_states(states: torch.Tensor, actions: torch.Tensor):
    """Apply one move per env.  ``states`` int8 (B,6,N,N), ``actions`` (B,).

    Actions are flat ints in [0, N*N]; N*N means pass.  Returns
    ``(new_states, StepInfo)``.  Envs that are already done, or whose action
    is invalid, pass through unchanged and are flagged.
    """
    ps, info = step_planes(planes_from_states(states), actions)
    return states_from_planes(ps, states.dtype), info
