"""The reference-compatible functional Go API ("low level API"), numpy in and
out (counterpart of ``gymgo_tpu.gogame``), backed by the port's batched
PyTorch core.

States cross this boundary as float64 0/1 arrays (the reference's dtype) and
are stepped as int8 tensors.  Every function that computes takes a
keyword-only ``device``: ``cuda`` unless the caller names another, raising
when there is no card (``core.state.resolve_device``).  On the card every
transition, ``children`` and ``areas`` launch the bundle flood kernel through
``core.step.step_states`` and ``core.score``.  The six device functions are
compiled once at import, as the JAX package jits them (``_step_states``,
``_batch_canonical``, ``_children_jit``, ``_areas_jit``,
``_num_liberties_jit``, ``_liberties_jit``): on the card each replays a CUDA
graph per input shape, but the step, ``children`` and the score run their
eager functions on boards over 181x181 (``core.flood.capturable``).
Importing this module touches no device.

The contract is the JAX package's:
  * ``batch_next_states`` applies per-env single-state semantics; the
    reference's batch capture-misalignment bug (Q1) is not reproduced.
  * ``next_state`` on a finished game is a frozen no-op.
  * An invalid move raises ``AssertionError``, as in the reference.
  * ``invalid_moves`` is all zeros once the game has ended;
    ``batch_invalid_moves`` has no game-ended branch.
  * ``random_symmetry`` and ``random_action`` draw from global ``np.random``.
"""

from __future__ import annotations

import numpy as np
import torch

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.core import actions as _actions
from gymgo_tpu_torch.core import score as _score
from gymgo_tpu_torch.core import step as _step
from gymgo_tpu_torch.core import transform as _transform
from gymgo_tpu_torch.core.flood import capturable
from gymgo_tpu_torch.core.state import resolve_device
from gymgo_tpu_torch.utils import render as _render
from gymgo_tpu_torch.utils import tracing
from gymgo_tpu_torch.utils.graphs import compiled

_OUT_DTYPE = np.float64

# the compiled device functions (cached per input shape)
_step_states = compiled(_step.step_states)
_batch_canonical = compiled(_transform.batch_canonical_form)
_children_jit = compiled(_actions.children, static_argnames=("canonical",))
_areas_jit = compiled(_score.areas)
_num_liberties_jit = compiled(_score.num_liberties)
_liberties_jit = compiled(_score.liberties)


def _run(fn, states, *args, **kw):
    """The compiled ``fn`` (a step or a score) on ``states``, or its eager
    function where that work syncs with the host
    (``core.flood.capturable``)."""
    return (fn if capturable(states.shape[-1]) else fn.fn)(states, *args, **kw)


def _to_device(state, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(state).astype(np.int8)).to(resolve_device(device))


def _to_host(state: torch.Tensor) -> np.ndarray:
    with tracing.sync("gogame.to_host"):
        return state.cpu().numpy().astype(_OUT_DTYPE)


def _step_checked(batch_states, batch_action1d, device):
    dev = _to_device(batch_states, device)
    acts = torch.from_numpy(np.asarray(batch_action1d).astype(np.int32)).to(dev.device)
    new_states, info = _run(_step_states, dev, acts)
    with tracing.sync("gogame.step_checked"):
        bad = info.invalid_action.cpu().numpy()
    assert not bad.any(), ("Invalid move", np.nonzero(bad)[0].tolist())
    return new_states, info


# --------------------------------------------------------------------------
# state constructors
# --------------------------------------------------------------------------

def init_state(size):
    return np.zeros((govars.NUM_CHNLS, size, size), dtype=_OUT_DTYPE)


def batch_init_state(batch_size, board_size):
    return np.zeros((batch_size, govars.NUM_CHNLS, board_size, board_size), dtype=_OUT_DTYPE)


# --------------------------------------------------------------------------
# transitions
# --------------------------------------------------------------------------

def next_state(state, action1d, canonical=False, *, device=None):
    return batch_next_states(np.asarray(state)[None], np.asarray([action1d]), canonical, device=device)[0]


def _next_state_with_areas(state, action1d, *, device=None):
    """Internal (the ``GoEnv`` path): ``next_state`` and the step's own
    Trump-Taylor areas ``(black, white)``, which the step computes anyway,
    so the reward pays no second flood."""
    new_states, info = _step_checked(np.asarray(state)[None], np.asarray([action1d]), device)
    with tracing.sync("gogame.step_areas"):
        areas = (int(info.black_area[0]), int(info.white_area[0]))
    return _to_host(new_states)[0], areas


def batch_next_states(batch_states, batch_action1d, canonical=False, *, device=None):
    new_states, _ = _step_checked(batch_states, batch_action1d, device)
    if canonical:
        new_states = _batch_canonical(new_states)
    return _to_host(new_states)


# --------------------------------------------------------------------------
# move masks
# --------------------------------------------------------------------------

def invalid_moves(state):
    # All moves are valid once the game is over (the reference's quirk).
    if game_ended(state):
        return np.zeros(action_size(state))
    return np.append(np.asarray(state)[govars.INVD_CHNL].flatten(), 0)


def valid_moves(state):
    return 1 - invalid_moves(state)


def batch_invalid_moves(batch_state):
    # The reference's batch variant has no game-ended branch.
    batch_state = np.asarray(batch_state)
    n = len(batch_state)
    flat = batch_state[:, govars.INVD_CHNL].reshape(n, -1)
    return np.append(flat, np.zeros((n, 1)), axis=1)


def batch_valid_moves(batch_state):
    return 1 - batch_invalid_moves(batch_state)


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------

def children(state, canonical=False, padded=True, *, device=None):
    out = _to_host(_run(_children_jit, _to_device(state, device), canonical=bool(canonical)))
    if not padded:
        out = out[np.nonzero(valid_moves(state))]
    return out


# --------------------------------------------------------------------------
# scalar queries
# --------------------------------------------------------------------------

def action_size(state=None, board_size: int = None):
    if state is not None:
        m, n = np.asarray(state).shape[1:]
    elif board_size is not None:
        m, n = board_size, board_size
    else:
        raise RuntimeError("No argument passed")
    return m * n + 1


def prev_player_passed(state):
    return np.max(np.asarray(state)[govars.PASS_CHNL] == 1) == 1


def batch_prev_player_passed(batch_state):
    return np.max(np.asarray(batch_state)[:, govars.PASS_CHNL], axis=(1, 2)) == 1


def game_ended(state):
    m, n = np.asarray(state).shape[1:]
    return int(np.count_nonzero(np.asarray(state)[govars.DONE_CHNL] == 1) == m * n)


def batch_game_ended(batch_state):
    return np.max(np.asarray(batch_state)[:, govars.DONE_CHNL], axis=(1, 2))


def turn(state):
    return int(np.max(np.asarray(state)[govars.TURN_CHNL]))


def batch_turn(batch_state):
    return np.max(np.asarray(batch_state)[:, govars.TURN_CHNL], axis=(1, 2)).astype(int)


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------

def winning(state, komi=0, *, device=None):
    black_area, white_area = areas(state, device=device)
    return np.sign(black_area - white_area - komi)


def batch_winning(state, komi=0, *, device=None):
    batch_black, batch_white = batch_areas(state, device=device)
    return np.sign(batch_black - batch_white - komi)


def areas(state, *, device=None):
    ba, wa = _run(_areas_jit, _to_device(state, device)[None])
    with tracing.sync("gogame.areas"):
        return float(ba[0]), float(wa[0])


def batch_areas(batch_state, *, device=None):
    ba, wa = _run(_areas_jit, _to_device(batch_state, device))
    with tracing.sync("gogame.areas"):
        return ba.cpu().numpy().astype(_OUT_DTYPE), wa.cpu().numpy().astype(_OUT_DTYPE)


def liberties(state, *, device=None):
    bl, wl = _liberties_jit(_to_device(state, device)[None])
    with tracing.sync("gogame.liberties"):
        return bl[0].cpu().numpy(), wl[0].cpu().numpy()


def num_liberties(state, *, device=None):
    bl, wl = _num_liberties_jit(_to_device(state, device)[None])
    with tracing.sync("gogame.liberties"):
        return int(bl[0]), int(wl[0])


# --------------------------------------------------------------------------
# canonical form and symmetries
# --------------------------------------------------------------------------

def canonical_form(state, *, device=None):
    return _to_host(_transform.canonical_form(_to_device(state, device)))


def batch_canonical_form(batch_state, *, device=None):
    return _to_host(_batch_canonical(_to_device(batch_state, device)))


def _orient(image, orientation):
    if (orientation >> 0) % 2:
        image = np.flip(image, 2)
    if (orientation >> 1) % 2:
        image = np.flip(image, 1)
    if (orientation >> 2) % 2:
        image = np.rot90(image, axes=(1, 2))
    return image


def random_symmetry(image):
    """One of the 8 dihedral symmetries, drawn from global ``np.random`` as the
    reference draws it (``core.transform.random_symmetry`` takes a
    generator)."""
    return _orient(np.asarray(image), np.random.randint(0, 8))


def all_symmetries(image):
    image = np.asarray(image)
    return [_orient(image, i) for i in range(8)]


# --------------------------------------------------------------------------
# random policies: host-side, global np.random, so that fixed-seed action
# streams match the reference's own
# --------------------------------------------------------------------------

def random_weighted_action(move_weights):
    move_weights = np.asarray(move_weights, dtype=np.float64)
    probs = move_weights / np.sum(np.abs(move_weights))
    return np.random.choice(np.arange(len(probs)), p=probs)


def random_action(state):
    invalid = np.append(np.asarray(state)[govars.INVD_CHNL].flatten(), 0)
    return random_weighted_action(1 - invalid)


# --------------------------------------------------------------------------
# terminal renderer
# --------------------------------------------------------------------------

def str(state, *, device=None):  # noqa: A001 - shadows the builtin, as the reference's API does
    state = np.asarray(state)
    black_area, white_area = areas(state, device=device)
    return _render.board_str(
        state,
        black_area=int(black_area),
        white_area=int(white_area),
        done=bool(game_ended(state)),
        passed=bool(prev_player_passed(state)),
        turn=turn(state),
    )
