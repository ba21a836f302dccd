"""Board makers shared by the port's tests (numpy only; imports no JAX, so the
card tests can use it on a machine without JAX)."""

import numpy as np


def serpentine_mask(n):
    """Worst-case run structure: full rows joined by single connectors."""
    m = np.zeros((n, n), bool)
    for r in range(0, n, 2):
        m[r, :] = True
    for r in range(1, n, 2):
        m[r, n - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def staircase_mask(n):
    m = np.zeros((n, n), bool)
    r = c = 0
    while r < n and c < n:
        m[r, c] = True
        if (r + c) % 2 == 0:
            c += 1
        else:
            r += 1
    return m


def random_boards(rng, b, n):
    """Disjoint (a, b) stone planes over a spread of densities."""
    r = rng.random((b, n, n))
    dens = np.linspace(0.05, 0.95, b)[:, None, None]
    return r < dens / 2, (r >= dens / 2) & (r < dens)


def adversarial_boards(n):
    """Long chains of stones and of empty cells, for many flood rounds."""
    serp, stair = serpentine_mask(n), staircase_mask(n)
    none = np.zeros((n, n), bool)
    a = np.stack([serp, none, ~serp, stair, ~stair, serp])
    b = np.stack([none, serp, none, none, none, ~serp & (np.arange(n * n).reshape(n, n) % 3 == 0)])
    return a, b & ~a


def spiral_mask(n):
    """A rectangular spiral one cell wide, wound inwards from the top-left
    corner with one cell between its turns: the longest path a board holds.
    Its complement is a spiral too."""
    m = np.zeros((n, n), bool)
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    r = c = d = 0
    m[0, 0] = True
    turns = 0
    while turns < 2:
        dr, dc = steps[d]
        nr, nc = r + dr, c + dc
        ahead = (nr + dr, nc + dc)
        free = (0 <= nr < n and 0 <= nc < n and not m[nr, nc]
                and not (0 <= ahead[0] < n and 0 <= ahead[1] < n and m[ahead]))
        if free:
            r, c, turns = nr, nc, 0
            m[r, c] = True
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def comb_mask(n):
    """One full row with a tooth hanging from every other column."""
    m = np.zeros((n, n), bool)
    m[0, :] = True
    m[:, 0::2] = True
    return m


def component_boards(n):
    """Boards that try a component labelling: one component of N*N cells,
    N*N components of one, spirals of stones and of empty cells, combs."""
    spiral, comb = spiral_mask(n), comb_mask(n)
    none, full = np.zeros((n, n), bool), np.ones((n, n), bool)
    checks = np.indices((n, n)).sum(0) % 2 == 0
    a = np.stack([spiral, none, ~spiral, spiral, comb, none, ~comb, none, full, none, checks, checks, none])
    b = np.stack([none, spiral, none, ~spiral, none, comb, comb, none, none, full, ~checks, none, ~checks])
    return a, b


def states_on_boards(n, seed):
    """int8 ``(352, 6, n, n)`` states on the random, adversarial and component
    boards (hand-made: some groups stand without a liberty): both colours to
    move, some after a pass, the occupied cells invalid."""
    planes = [random_boards(np.random.default_rng(seed), 333, n), adversarial_boards(n), component_boards(n)]
    black, white = (np.concatenate(x) for x in zip(*planes))
    states = np.zeros((len(black), 6, n, n), np.int8)
    states[:, 0], states[:, 1] = black, white & ~black
    states[1::2, 2] = 1
    states[:, 3] = states[:, 0] | states[:, 1]
    states[::5, 4] = 1
    return states


def midgame_states(n, b, plies, seed):
    """int8 ``(b, 6, n, n)`` states after ``plies`` uniform-random legal moves
    of the port's CPU rollout (no auto-reset, so some games may be over)."""
    import torch

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import rollout

    cfg = EnvConfig(board_size=n, batch_size=b)
    g = torch.Generator().manual_seed(seed)
    return rollout(g, batch_init_state(b, n, device="cpu"), plies, cfg).final_states.numpy()


def crafted_state(n, black=(), white=(), white_to_move=False, prev_passed=False, done=False):
    """One int8 ``(6, n, n)`` state with stones at the given (row, col) cells;
    the invalid plane marks the occupied cells (and every cell once done)."""
    s = np.zeros((6, n, n), np.int8)
    for r, c in black:
        s[0, r, c] = 1
    for r, c in white:
        s[1, r, c] = 1
    s[2] = white_to_move
    s[3] = (s[0] | s[1]) | done
    s[4] = prev_passed
    s[5] = done
    return s
