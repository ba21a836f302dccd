"""Plain NumPy rules of the benchmark's Go environment, for S boards at once.

The semantics the configuration states (the GymGo environment's): a board
move on a cell the player to move may not take is rejected and leaves the
board as it was; two passes in a row end the game; a move captures every
opponent group left without a liberty; a move that would leave its own group
without a liberty (suicide) is not allowed; simple ko forbids retaking a
single stone at once when the capturing stone stood alone among the
opponent's stones; the score is Trump-Taylor area (stones plus empty regions
that touch one colour only).  States are int8 ``(S, 6, N, N)`` planes: black,
white, turn (1 = white to move), the invalid moves of the player to move,
passed, done; the last four as whole-plane indicators.

Groups and regions come from ``scipy.ndimage.label`` with 4-connectivity,
one board at a time; nothing here follows the program's algorithm (which
classifies groups by packed floods on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage

BLACK, WHITE, TURN, INVD, PASS, DONE = range(6)
HEURISTIC, REAL = "heuristic", "real"

# 4-connectivity inside a board and none across the batch axis
_CROSS = np.zeros((3, 3, 3), dtype=bool)
_CROSS[1] = [[False, True, False], [True, True, True], [False, True, False]]


def touches(x: np.ndarray) -> np.ndarray:
    """Per cell: some in-bounds neighbour is in ``x`` (bool (S, N, N))."""
    out = np.zeros_like(x)
    out[:, 1:] |= x[:, :-1]
    out[:, :-1] |= x[:, 1:]
    out[:, :, 1:] |= x[:, :, :-1]
    out[:, :, :-1] |= x[:, :, 1:]
    return out


def surrounded_by(x: np.ndarray) -> np.ndarray:
    """Per cell: every in-bounds neighbour is in ``x``."""
    out = np.ones_like(x)
    out[:, 1:] &= x[:, :-1]
    out[:, :-1] &= x[:, 1:]
    out[:, :, 1:] &= x[:, :, :-1]
    out[:, :, :-1] &= x[:, :, 1:]
    return out


def label(x: np.ndarray):
    """4-connected components of ``x`` per board: (labels int32 (S, N, N),
    0 off ``x``; number of components)."""
    lab, count = ndimage.label(x, structure=_CROSS)
    return lab.astype(np.int32, copy=False), int(count)


def _neighbours(lab: np.ndarray):
    """The four neighbours' values of every cell (0 off the board)."""
    up, down, left, right = (np.zeros_like(lab) for _ in range(4))
    up[:, 1:] = lab[:, :-1]
    down[:, :-1] = lab[:, 1:]
    left[:, :, 1:] = lab[:, :, :-1]
    right[:, :, :-1] = lab[:, :, 1:]
    return up, down, left, right


def liberty_counts(lab: np.ndarray, count: int, empty: np.ndarray) -> np.ndarray:
    """Distinct liberties of each component of ``lab`` (index 0 unused): an
    empty cell counts once for each different component beside it."""
    nbs = _neighbours(lab)
    out = np.zeros(count + 1, dtype=np.int64)
    for i, nb in enumerate(nbs):
        new = empty & (nb > 0)
        for earlier in nbs[:i]:
            new &= nb != earlier
        out += np.bincount(nb[new], minlength=count + 1)
    return out


@dataclasses.dataclass
class Boards:
    """S games: colour planes, the invalid moves of the player to move, and
    the per-game flags."""

    black: np.ndarray  # bool (S, N, N)
    white: np.ndarray
    invd: np.ndarray
    white_to_move: np.ndarray  # bool (S,)
    passed: np.ndarray
    done: np.ndarray

    @classmethod
    def empty(cls, s: int, n: int) -> "Boards":
        z = np.zeros((s, n, n), dtype=bool)
        f = np.zeros(s, dtype=bool)
        return cls(z, z.copy(), z.copy(), f, f.copy(), f.copy())

    @classmethod
    def from_states(cls, states: np.ndarray) -> "Boards":
        st = np.asarray(states) != 0
        return cls(st[:, BLACK].copy(), st[:, WHITE].copy(), st[:, INVD].copy(), st[:, TURN, 0, 0].copy(),
                   st[:, PASS, 0, 0].copy(), st[:, DONE, 0, 0].copy())

    def to_states(self) -> np.ndarray:
        s, n, _ = self.black.shape

        def plane(v):
            return np.broadcast_to(v[:, None, None], (s, n, n))

        return np.stack([self.black, self.white, plane(self.white_to_move), self.invd, plane(self.passed),
                         plane(self.done)], axis=1).astype(np.int8)

    @property
    def size(self) -> int:
        return self.black.shape[-1]


def reset_done(b: Boards) -> Boards:
    """Finished games replaced by empty boards (the environment's auto-reset)."""
    d = b.done
    if not d.any():
        return b
    d3 = d[:, None, None]
    return Boards(b.black & ~d3, b.white & ~d3, b.invd & ~d3, b.white_to_move & ~d, b.passed & ~d, b.done & ~d)


def forbidden(black, white, white_to_move, ko=None) -> np.ndarray:
    """The cells the player to move may not take: stones, suicide points and
    the ko point (``ko``, bool (S, N, N), or none)."""
    stones = black | white
    empty = ~stones
    w3 = white_to_move[:, None, None]
    own = np.where(w3, white, black)
    other = np.where(w3, black, white)
    lab_own, n_own = label(own)
    lab_other, n_other = label(other)
    libs_own = liberty_counts(lab_own, n_own, empty)
    libs_other = liberty_counts(lab_other, n_other, empty)
    safe_own = own & (libs_own[lab_own] >= 2)  # joining it keeps a liberty
    atari_other = other & (libs_other[lab_other] == 1)  # taking its last liberty captures it
    suicide = empty & ~touches(empty) & ~touches(safe_own) & ~touches(atari_other)
    out = stones | suicide
    return out if ko is None else out | ko


def areas(black: np.ndarray, white: np.ndarray):
    """Trump-Taylor areas, int64 (S,) each."""
    empty = ~(black | white)
    lab, count = label(empty)
    tb = np.zeros(count + 1, dtype=bool)
    tw = np.zeros(count + 1, dtype=bool)
    tb[lab[empty & touches(black)]] = True
    tw[lab[empty & touches(white)]] = True
    only_b = empty & tb[lab] & ~tw[lab]
    only_w = empty & tw[lab] & ~tb[lab]
    return (black | only_b).sum((1, 2)), (white | only_w).sum((1, 2))


def reward(black_area, white_area, done, komi: float, method: str, n: int) -> np.ndarray:
    """float32 (S,): ``heuristic`` pays black's lead every step and +/- N*N at
    the end (a tie counts as a loss); ``real`` pays the sign of the lead at
    the end."""
    lead = np.asarray(black_area, np.float32) - np.asarray(white_area, np.float32) - np.float32(komi)
    if method == HEURISTIC:
        return np.where(done, np.where(lead > 0, 1.0, -1.0) * (n * n), lead).astype(np.float32)
    if method == REAL:
        return np.where(done, np.sign(lead), 0.0).astype(np.float32)
    raise ValueError(method)


@dataclasses.dataclass
class StepOut:
    reward: np.ndarray  # float32 (S,)
    done: np.ndarray  # bool (S,)
    invalid: np.ndarray  # bool (S,): the move was rejected
    captured: np.ndarray  # int (S,)


def step(b: Boards, actions, komi: float, method: str):
    """One move per game (flat cell index, N*N = pass).  Returns the new
    boards and ``StepOut``.  A finished game, or a rejected move, leaves the
    game as it was."""
    s, n = b.black.shape[0], b.size
    m = n * n
    a = np.asarray(actions, dtype=np.int64)
    rows = np.arange(s)
    is_pass = a == m
    idx = np.clip(a, 0, m - 1)
    r, c = idx // n, idx % n
    invalid = (a < 0) | (a > m) | (~is_pass & b.invd[rows, r, c])
    frozen = b.done | invalid
    play = ~frozen & ~is_pass
    w3 = b.white_to_move[:, None, None]
    mover = np.where(w3, b.white, b.black)
    opp = np.where(w3, b.black, b.white)
    lone = surrounded_by(opp)[rows, r, c]  # every neighbour of the move is the opponent's

    mover = mover.copy()
    mover[rows[play], r[play], c[play]] = True
    empty = ~(mover | opp)
    lab, count = label(opp)
    breathes = np.zeros(count + 1, dtype=bool)
    breathes[lab[opp & touches(empty)]] = True
    dead = opp & ~breathes[lab] & play[:, None, None]
    captured = dead.sum((1, 2))
    opp = opp & ~dead
    ko = dead & (play & (captured == 1) & lone)[:, None, None]

    f3 = frozen[:, None, None]
    black = np.where(f3, b.black, np.where(w3, opp, mover))
    white = np.where(f3, b.white, np.where(w3, mover, opp))
    white_to_move = b.white_to_move ^ ~frozen
    invd = np.where(f3, b.invd, forbidden(black, white, white_to_move, ko))
    passed = np.where(frozen, b.passed, is_pass)
    done = np.where(frozen, b.done, b.done | (b.passed & is_pass))
    ba, wa = areas(black, white)
    out = StepOut(reward(ba, wa, done, komi, method, n), done, invalid, np.where(frozen, 0, captured))
    return Boards(black, white, invd, white_to_move, passed, done), out


def legal_actions(b: Boards) -> np.ndarray:
    """bool (S, N*N + 1): the moves the player to move may make (pass last)."""
    s = b.black.shape[0]
    return np.concatenate([~b.invd.reshape(s, -1), np.ones((s, 1), dtype=bool)], axis=1)


def handed_over_faults(b: Boards) -> np.ndarray:
    """bool (S,): a state that no game reaches.  Stones overlap, a group has
    no liberty, or the invalid moves differ from stones, suicide points and
    at most one ko point; a ko point is empty, every neighbour is a stone of
    the player who just moved, and one of them stands alone in atari."""
    s, n = b.black.shape[0], b.size
    bad = (b.black & b.white).any((1, 2))
    stones = b.black | b.white
    empty = ~stones
    for colour in (b.black, b.white):
        lab, count = label(colour)
        libs = liberty_counts(lab, count, empty)
        bad |= (colour & (libs[lab] == 0)).any((1, 2))
    expected = forbidden(b.black, b.white, b.white_to_move)
    extra = b.invd & ~expected
    bad |= (expected & ~b.invd).any((1, 2)) | (extra.sum((1, 2)) > 1)
    last = np.where(b.white_to_move[:, None, None], b.black, b.white)  # who just moved
    lab, count = label(last)
    libs = liberty_counts(lab, count, empty)
    sizes = np.bincount(lab.ravel(), minlength=count + 1)
    lone_atari = last & (libs[lab] == 1) & (sizes[lab] == 1)
    ko_shape = empty & surrounded_by(last) & touches(lone_atari)
    bad |= (extra & ~ko_shape).any((1, 2))
    return bad


def rank_of(legal: np.ndarray, actions: np.ndarray) -> np.ndarray:
    """Each legal action's rank among the legal moves in flat order, pass
    last: the draw ``k`` in [0, num_legal - 1] that a uniform sampler over
    those moves would have made."""
    a = np.asarray(actions, dtype=np.int64)
    before = np.cumsum(legal, axis=1) - legal
    return before[np.arange(len(a)), a]
