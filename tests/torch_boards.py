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
