"""Pure geometry for the pyglet GUI (a copy of ``gymgo_tpu.utils.gui_math``):
the mouse->intersection mapping and board layout, unit-testable without a
display.

Mirrors the reference exactly:
- layout constants: the reference's gym_go/envs/go_env.py:181-186
- mouse click -> grid intersection: go_env.py:213-218 (round to the
  nearest intersection, NO bounds clamping — clicks outside the grid
  produce out-of-range coordinates, and the env's step() raises on them,
  exactly like the reference)
- stone (i, j) -> screen (x, y): rendering.py:90,96 — the board row index
  i maps to screen X and column j to screen Y (transposed relative to the
  terminal renderer, SURVEY.md Q11).  The same transposition is applied in
  reverse by the click handler returning (x_coord, y_coord) as the action
  tuple, so click(stone_screen_pos(i, j)) steps at (i, j): the two quirks
  cancel and the GUI is self-consistent.
"""

from __future__ import annotations

from typing import NamedTuple


class BoardLayout(NamedTuple):
    window_width: int
    window_height: int
    lower_grid_coord: float
    board_size: float
    upper_grid_coord: float
    delta: float
    piece_r: float


def board_layout(screen_width: int, screen_height: int, size: int) -> BoardLayout:
    """Window + grid geometry from the screen dims (go_env.py:169-186)."""
    window_width = int(min(screen_width, screen_height) * 2 / 3)
    window_height = int(window_width * 1.2)
    lower_grid_coord = window_width * 0.075
    board_size = window_width * 0.85
    upper_grid_coord = board_size + lower_grid_coord
    delta = board_size / (size - 1)
    piece_r = delta / 3.3
    return BoardLayout(window_width, window_height, lower_grid_coord,
                       board_size, upper_grid_coord, delta, piece_r)


def mouse_to_intersection(x: float, y: float, lower_grid_coord: float,
                          delta: float) -> tuple:
    """Screen click -> (x_coord, y_coord) grid intersection
    (go_env.py:213-218).  The tuple is returned as the user action verbatim
    — the env decodes it as (row, col), which matches because stones are
    drawn transposed (see stone_screen_pos)."""
    x_coord = round((x - lower_grid_coord) / delta)
    y_coord = round((y - lower_grid_coord) / delta)
    return (x_coord, y_coord)


def stone_screen_pos(i: int, j: int, lower_grid_coord: float,
                     delta: float) -> tuple:
    """Board (i, j) -> screen (x, y) center of the stone
    (rendering.py:90,96): row i on screen X, column j on screen Y."""
    return (lower_grid_coord + i * delta, lower_grid_coord + j * delta)


def grid_line_offsets(size: int, lower_grid_coord: float, delta: float):
    """Per-index pixel offset of grid line i (rendering.py:56-66)."""
    return [lower_grid_coord + i * delta for i in range(size)]
