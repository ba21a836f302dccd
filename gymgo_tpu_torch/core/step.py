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
  move with one launch of its flood's kernel instead: a group dies
  iff its sole liberty is the point played or it stands without a liberty
  already (a hand-made board), which is what that flood finds.
* One flood of the post-capture board, the one ``core.flood``'s size rule
  picks (``flood_bundle_best``: the bundle flood up to 22x22, else the minmax
  route), classifies every group by its number of distinct liberties
  (0 / 1 / >= 2), claims empty regions for Trump-Taylor areas and yields the
  next step's ``atari`` plane.
* One packed uint8 dilation turns the classes into the next player's invalid
  mask (suicide rule) and the next step's ko-surround map.

On the card.  ``fused_step`` decides, from what it can see, whether a step
runs as the hand kernels of ``ops.env_step``: CUDA tensors, boards that take
the bundle flood (``core.flood.bundle_fits``), and no ablation token.  There
a step that holds the carried ``atari`` plane is one launch
(``env_fused``: the rollout's auto-reset and sampler, the rules, the bundle
flood's labelling and the score), and one without it, the stateless step,
five (``env_split``, a bundle launch on the board before the move,
``env_rules``, the bundle flood, ``env_score``), each result equal bit for
bit to the op-by-op ``step_planes_plain``, which every other case runs: the
CPU, boards over 22x22 and the ablations.

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
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import flood as _flood
from gymgo_tpu_torch.core.flood import flood_or, neighbor_or, shift
from gymgo_tpu_torch.core.score import reward_from_areas
from gymgo_tpu_torch.ops import env_step as _kernels
from gymgo_tpu_torch.ops.bundle_flood import bundle_flood
from gymgo_tpu_torch.utils import tracing
from gymgo_tpu_torch.utils.graphs import register_key_part

__all__ = [
    "StepInfo",
    "PlanesState",
    "step_states",
    "step_planes",
    "step_states_plain",
    "step_planes_plain",
    "step_window_row",
    "fused_step",
    "seed_planes",
    "reset_finished",
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
# a graph captured under one ablation never replays under another
register_key_part(lambda: tuple(sorted(ablate)))


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
    classification by ``core.flood``'s size rule; every later ``step_planes``
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


def seed_planes(states: torch.Tensor) -> PlanesState:
    """``planes_from_states`` with the carried planes seeded (``init_atari``,
    ``init_ko_surr``): the planes state a rollout carries, made once a
    window."""
    ps = planes_from_states(states)
    return ps._replace(atari=init_atari(ps), ko_surr=init_ko_surr(ps))


def reset_finished(ps: PlanesState) -> None:
    """Zero the finished boards of the planes state in place, the carried
    planes too (every plane a fresh tensor the rollout owns).  Under
    ``fused_step`` one launch of ``ops.env_step.sample``."""
    if fused_step(ps.black):
        _kernels.sample(*ps[:6], atari=ps.atari, ko_surr=ps.ko_surr, reset=True)
        return
    reset = ps.done.clone()
    for x in ps:
        if x is not None:
            x.masked_fill_(reset.view((-1,) + (1,) * (x.dim() - 1)), 0)


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


def fused_step(boards: torch.Tensor) -> bool:
    """True when a step of ``boards`` (``(..., N, N)``) runs as the hand
    kernels of ``ops.env_step`` around the bundle flood: on a CUDA device,
    for boards that take the bundle flood (``core.flood.bundle_fits``),
    while no ``GYMGO_ABLATE`` token is set."""
    return boards.is_cuda and _flood.bundle_fits(boards.shape[-1]) and not ablate


def step_planes(ps: PlanesState, actions: torch.Tensor):
    """Core transition on the planes state; see ``step_states``.

    On CUDA tensors it makes no host sync, with or without the carried
    planes.  On CPU tensors without ``atari`` the capture flood is the plain
    ``flood_or``, which checks its convergence on the host.
    Runs under the span ``env.rules``, its flood under ``env.flood`` and its
    area sums under ``env.score`` (``utils.tracing``); with the carried
    ``atari`` plane on the card under ``env.fused`` alone.  Under
    ``fused_step`` the hand kernels (``_step_planes_fused``), else
    ``step_planes_plain``.
    """
    if fused_step(ps.black):
        return _step_planes_fused(ps, actions)
    return step_planes_plain(ps, actions)


def step_planes_plain(ps: PlanesState, actions: torch.Tensor):
    """``step_planes`` op by op in PyTorch: the plain version of the hand
    kernels, which every device and board size takes."""
    with tracing.span("env.rules"):
        return _step_planes(ps, actions)


def _kernel_actions(actions: torch.Tensor, dev) -> torch.Tensor:
    """The actions as ``ops.env_step.rules`` takes them: int32 or int64,
    contiguous, on ``dev``."""
    if actions.device != dev or actions.dtype not in (torch.int32, torch.int64):
        actions = actions.to(device=dev, dtype=torch.int64)
    return actions.contiguous()


def step_window_row(ps: PlanesState, x: torch.Tensor, rows, t: int, config, *, words: bool,
                    reset: bool = False) -> PlanesState:
    """One step of a rollout's boards, written into row ``t`` of their
    window ``rows`` = ``(actions, rewards, dones, invalid, obs)`` (``(T, B)``
    each, ``obs`` ``(T, B, 6, N, N)`` int8 or None); returns the new planes
    state.

    ``x`` is either the random words of ``core.actions.draw_words``
    (``words``), from which the uniform sampler picks each board's action,
    or the actions.  With ``reset`` the finished boards restart first
    (``reset_finished``, span ``env.reset``); the rest runs under the span
    ``env.step``.  The reward is ``core.score.reward_from_areas``'s under
    ``config``.  Under ``fused_step``, with the carried ``atari`` plane (a
    rollout's), one ``env_fused`` launch restarts, samples, steps and writes
    the rows, and the old planes are left as they were; else the op-by-op
    code.
    """
    acts_out, rewards, dones, inval, obs = rows
    fused = fused_step(ps.black) and ps.atari is not None
    if reset and not fused:
        with tracing.span("env.reset"):
            reset_finished(ps)
    with tracing.span("env.step"):
        if fused:
            ps, _ = _step_planes_fused(
                ps, None if words else x, words=x if words else None, reset=reset, actions_out=acts_out[t],
                reward=rewards[t], komi=config.komi, reward_method=config.reward_method, done_row=dones[t],
                invalid=inval[t], states=None if obs is None else obs[t])
            return ps
        if words:
            with tracing.span("env.sampler"):
                x = _actions.uniform_from_words(x, ~ps.invd.reshape(ps.invd.shape[0], -1))
        ps, info = step_planes_plain(ps, x)
        acts_out[t] = x
        rewards[t] = reward_from_areas(info.black_area, info.white_area, ps.done, config)
        dones[t] = ps.done
        inval[t] = info.invalid_action
        if obs is not None:
            obs[t] = states_from_planes(ps)
    return ps


def _step_planes_fused(ps: PlanesState, actions, *, words=None, reset: bool = False, actions_out=None,
                       **outputs):
    """``step_planes_plain``'s results from the hand kernels (CUDA planes
    that ``fused_step`` takes).

    With the carried ``atari`` plane, one ``env_fused`` launch (span
    ``env.fused``), which also takes the sampler's ``words`` in place of the
    ``actions`` and, with ``reset``, restarts the finished boards first.
    Without it the stateless chain: a bundle launch on the board before the
    move, ``env_rules`` (span ``env.rules``), the bundle flood
    (``env.flood``), ``env_score`` (``env.score``); ``words`` and ``reset``
    are the caller's there.

    ``actions_out`` (int32 ``(B,)``) gets the actions, and ``outputs`` are
    more outputs of ``ops.env_step.score``, which ``step_window_row`` hands
    the rows of its window: ``reward`` with ``komi`` and ``reward_method``,
    ``done_row``, ``states``, and ``invalid`` in place of a new tensor.
    """
    b, n, _ = ps.black.shape
    dev = ps.black.device

    def new_planes():
        """The step's planes and flags, and its info's outputs, to write."""
        plane = torch.empty((b, n, n), dtype=torch.bool, device=dev)
        new_ps = PlanesState(
            plane, torch.empty_like(plane), torch.empty_like(plane),
            *(torch.empty((b,), dtype=torch.bool, device=dev) for _ in range(3)),
            atari=None if ps.atari is None else torch.empty((b, n, n), dtype=torch.int16, device=dev),
            ko_surr=None if ps.ko_surr is None else torch.empty_like(plane))
        outputs.setdefault("invalid", torch.empty((b,), dtype=torch.bool, device=dev))
        info = (outputs["invalid"], ps.done, *(torch.empty((b,), dtype=torch.int32, device=dev) for _ in range(3)))
        return new_ps, StepInfo(*info), dict(
            black=new_ps.black, white=new_ps.white, invd=new_ps.invd, atari=new_ps.atari, ko_surr=new_ps.ko_surr,
            wtm=new_ps.white_to_move, passed=new_ps.prev_passed, done=new_ps.done, captured=info[2],
            black_area=info[3], white_area=info[4])

    if ps.atari is not None:
        with tracing.span("env.fused"):
            new_ps, info, planes = new_planes()
            if reset:  # a restarted board was not done
                info = info._replace(was_done=torch.empty((b,), dtype=torch.bool, device=dev))
                outputs["was_done"] = info.was_done
            _kernels.fused(ps, words=words,
                           actions=None if words is not None else _kernel_actions(actions, dev),
                           actions_out=actions_out, reset=reset, **planes, **outputs)
        return new_ps, info
    with tracing.span("env.rules"):
        with tracing.span("env.flood"):
            word = bundle_flood(ps.black.contiguous(), ps.white.contiguous())
        mover, opp, code = _kernels.rules(ps.black, ps.white, ps.invd, ps.white_to_move, ps.prev_passed, ps.done,
                                          _kernel_actions(actions, dev), ko_surr=ps.ko_surr, word=word,
                                          actions_out=actions_out)
        with tracing.span("env.flood"):
            word = bundle_flood(mover, opp)
        with tracing.span("env.score"):
            new_ps, info, planes = new_planes()
            _kernels.score(mover, opp, word, code, ps.invd, **planes, **outputs)
    return new_ps, info


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
    is invalid, pass through unchanged and are flagged.  Under
    ``fused_step`` (states of one byte a value) the hand kernels read and
    write the states themselves, else ``step_states_plain``.
    """
    if fused_step(states) and states.element_size() == 1:
        return _step_states_fused(states.contiguous(), actions)
    return step_states_plain(states, actions)


def step_states_plain(states: torch.Tensor, actions: torch.Tensor):
    """``step_states`` op by op in PyTorch (``step_planes_plain``)."""
    ps, info = step_planes_plain(planes_from_states(states), actions)
    return states_from_planes(ps, states.dtype), info


def _step_states_fused(states: torch.Tensor, actions: torch.Tensor):
    """The stateless step from the hand kernels: the split and a bundle
    launch classify the board before the move, ``env_rules`` reads the
    states through their strides, ``env_score`` writes the new ones."""
    b, dev = states.shape[0], states.device
    with tracing.span("env.rules"):
        black, white = _kernels.split(states)
        with tracing.span("env.flood"):
            word = bundle_flood(black, white)
        mover, opp, info = _kernels.rules(
            states[:, govars.BLACK], states[:, govars.WHITE], states[:, govars.INVD_CHNL],
            states[:, govars.TURN_CHNL, 0, 0], states[:, govars.PASS_CHNL, 0, 0], states[:, govars.DONE_CHNL, 0, 0],
            _kernel_actions(actions, dev), word=word)
        with tracing.span("env.flood"):
            word = bundle_flood(mover, opp)
        with tracing.span("env.score"):
            new_states = torch.empty_like(states)
            invalid, was_done = (torch.empty((b,), dtype=torch.bool, device=dev) for _ in range(2))
            captured, black_area, white_area = (torch.empty((b,), dtype=torch.int32, device=dev) for _ in range(3))
            _kernels.score(mover, opp, word, info, states[:, govars.INVD_CHNL], states=new_states, invalid=invalid,
                          was_done=was_done, captured=captured, black_area=black_area, white_area=white_area)
    return new_states, StepInfo(invalid, was_done, captured, black_area, white_area)
