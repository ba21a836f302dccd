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
