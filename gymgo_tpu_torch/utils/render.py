"""Terminal board renderer, glyph-identical to the reference.

Reproduces the box-drawing layout of the reference's gym_go/gogame.py:407-468
(verified char-for-char in tests): black stones (channel 0) render as '○',
white as '●', edges use double-line glyphs, interior uses single-line glyphs,
and the footer reports turn, game phase and areas.
"""

from __future__ import annotations

import numpy as np

from gymgo_tpu_torch import govars

_BLACK_STONE = "○"
_WHITE_STONE = "●"

# (top, bottom, middle) x (left, right, interior) empty-point glyphs.
_EMPTY = {
    "top": {"left": "╔═", "right": "╗", "mid": "╤═"},
    "bottom": {"left": "╚═", "right": "╝", "mid": "╧═"},
    "middle": {"left": "╟─", "right": "╢", "mid": "┼─"},
}


def board_str(state, *, black_area, white_area, done, passed, turn) -> str:
    state = np.asarray(state)
    size = state.shape[1]
    lines = []

    header = "\t" + "".join("{}".format(j).ljust(2, " ") for j in range(size))
    lines.append(header)

    for i in range(size):
        row_kind = "top" if i == 0 else ("bottom" if i == size - 1 else "middle")
        cells = []
        for j in range(size):
            if state[govars.BLACK, i, j] == 1 or state[govars.WHITE, i, j] == 1:
                stone = (
                    _BLACK_STONE
                    if state[govars.BLACK, i, j] == 1
                    else _WHITE_STONE
                )
                connector = "" if j == size - 1 else ("═" if row_kind != "middle" else "─")
                cells.append(stone + connector)
            else:
                col_kind = "left" if j == 0 else ("right" if j == size - 1 else "mid")
                cells.append(_EMPTY[row_kind][col_kind])
        lines.append("{}\t".format(i) + "".join(cells))

    phase = "END" if done else ("PASSED" if passed else "ONGOING")
    lines.append(
        "\tTurn: {}, Game State (ONGOING|PASSED|END): {}".format(
            "BLACK" if turn == 0 else "WHITE", phase
        )
    )
    lines.append(
        "\tBlack Area: {}, White Area: {}".format(int(black_area), int(white_area))
    )
    return "\n".join(lines) + "\n"
