"""SGF (Smart Game Format) export and import for game records (counterpart
of ``gymgo_tpu.utils.sgf``).

Export turns rollout action sequences into standard .sgf files readable by
any Go client; import parses SGF text (main line) back into engine actions
and can replay them through the port's ``gogame``.  Handles batched rollouts
(one game record per env, split at auto-reset boundaries).  Everything here is
numpy apart from ``setup_state``, ``replay_sgf`` and ``_main``, which step
through ``gogame`` on a keyword-only ``device`` (``cuda`` unless named,
resolved at the call).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

_COORDS = "abcdefghijklmnopqrs"


def _sgf_coord(action: int, board_size: int) -> str:
    if action == board_size * board_size:
        return ""  # pass move: empty coordinate per SGF convention
    r, c = divmod(int(action), board_size)
    return f"{_COORDS[c]}{_COORDS[r]}"


def game_to_sgf(
    actions: Sequence[int],
    board_size: int,
    komi: float = 0.0,
    result: Optional[str] = None,
    black_name: str = "black",
    white_name: str = "white",
) -> str:
    """One game's flat actions (black first, alternating) -> SGF string."""
    header = (
        f"(;GM[1]FF[4]SZ[{board_size}]KM[{komi}]"
        f"PB[{black_name}]PW[{white_name}]AP[gymgo_tpu]"
    )
    if result:
        header += f"RE[{result}]"
    moves = []
    for i, a in enumerate(actions):
        color = "B" if i % 2 == 0 else "W"
        moves.append(f";{color}[{_sgf_coord(a, board_size)}]")
    return header + "".join(moves) + ")"


def result_string(winning_sign: float) -> str:
    if winning_sign > 0:
        return "B+R"
    if winning_sign < 0:
        return "W+R"
    return "0"


def rollout_to_sgf_games(
    actions: np.ndarray,
    dones: np.ndarray,
    board_size: int,
    komi: float = 0.0,
    env_index: int = 0,
) -> List[str]:
    """Split one env's (T,) action/done columns from a batched rollout into
    completed-game SGF strings (auto-reset starts a fresh record)."""
    actions = np.asarray(actions)[:, env_index]
    dones = np.asarray(dones)[:, env_index]
    games: List[str] = []
    current: List[int] = []
    for a, d in zip(actions, dones):
        current.append(int(a))
        if d:
            games.append(game_to_sgf(current, board_size, komi))
            current = []
    return games


def save_sgf(path: str, sgf: str) -> None:
    with open(path, "w") as f:
        f.write(sgf)


def save_sgf_collection(path: str, games: Sequence[str]) -> None:
    """Write several game records as one SGF collection file (the spec's
    multi-gametree form; read back with :func:`parse_sgf_collection`)."""
    with open(path, "w") as f:
        f.write("\n".join(games) + "\n")


# ---------------------------------------------------------------------------
# Import: SGF text -> actions -> replayed states
# ---------------------------------------------------------------------------


class SGFGame(NamedTuple):
    board_size: int
    komi: float
    moves: List[tuple]  # [("B"|"W", action_int), ...] main line, in order
    result: Optional[str]
    setup_black: tuple = ()  # root AB handicap/setup stones (flat actions)
    setup_white: tuple = ()  # root AW setup stones (flat actions)
    handicap: int = 0  # HA property (informational)
    first_to_move: str = "B"  # color to move from the setup position
    has_variations: bool = False  # record held variation subtrees; the
    # moves list is the MAIN line (first branch at every fork)


class SGFError(ValueError):
    pass


def _parse_forest(text: str) -> List[tuple]:
    """Minimal SGF recursive-descent parse of a file, which per the spec
    is a COLLECTION of one or more top-level gametrees.  Returns
    ``[(nodes, has_variations), ...]`` — one entry per game, where
    ``nodes`` is the MAIN LINE (first branch at every variation point) as
    {prop: [values]} dicts.  Handles '\\]' escapes inside property
    values.  Trailing non-whitespace after the last gametree is an
    error (truncated/concatenated-garbage records fail loudly)."""
    i = 0
    n = len(text)

    def skip_ws(j):
        while j < n and text[j].isspace():
            j += 1
        return j

    i = skip_ws(i)
    if i >= n or text[i] != "(":
        raise SGFError("SGF must start with '('")

    nodes: List[dict] = []
    saw_variation = [False]

    def parse_value(j):
        # at '[': scan to unescaped ']'
        j += 1
        buf = []
        while j < n:
            ch = text[j]
            if ch == "\\" and j + 1 < n:
                buf.append(text[j + 1])
                j += 2
                continue
            if ch == "]":
                return "".join(buf), j + 1
            buf.append(ch)
            j += 1
        raise SGFError("unterminated property value")

    def parse_sequence(j, keep):
        """Parse a '(' ... ')' gametree starting after '('; record nodes on
        the main line iff keep.  Returns index after the closing ')'."""
        j = skip_ws(j)
        first_subtree = True
        while j < n:
            ch = text[j]
            if ch == ";":
                node: dict = {}
                if keep:
                    nodes.append(node)
                j = skip_ws(j + 1)
                while j < n and text[j].isalpha():
                    p0 = j
                    while j < n and text[j].isalpha():
                        j += 1
                    # FF[3] long identifiers ("AddBlack", "White") carry the
                    # FF[4] short name in their uppercase letters; FF[4]
                    # identifiers are all-uppercase already
                    ident = text[p0:j]
                    prop = "".join(c for c in ident if c.isupper()) or \
                        ident.upper()
                    j = skip_ws(j)
                    vals = []
                    while j < n and text[j] == "[":
                        v, j = parse_value(j)
                        vals.append(v)
                        j = skip_ws(j)
                    node[prop] = vals
            elif ch == "(":
                if not first_subtree:
                    # second+ subtree of this node sequence = a variation
                    saw_variation[0] = True
                j = parse_sequence(j + 1, keep and first_subtree)
                first_subtree = False
            elif ch == ")":
                return j + 1
            elif ch.isspace():
                j += 1
            else:
                raise SGFError(f"unexpected character {ch!r} at {j}")
        raise SGFError("unterminated gametree")

    forest: List[tuple] = []
    while i < n and text[i] == "(":
        nodes = []
        saw_variation[0] = False
        i = parse_sequence(i + 1, True)
        if not nodes:
            raise SGFError("empty SGF gametree")
        forest.append((nodes, saw_variation[0]))
        i = skip_ws(i)
    if i < n:
        raise SGFError(
            f"trailing content after gametree at offset {i}: {text[i:i+20]!r}"
        )
    return forest


def _coord_to_action(value: str, board_size: int) -> int:
    if value == "" or (value == "tt" and board_size <= 19):
        return board_size * board_size  # pass
    if len(value) != 2:
        raise SGFError(f"bad coordinate {value!r}")
    c = _COORDS.index(value[0])
    r = _COORDS.index(value[1])
    if not (0 <= r < board_size and 0 <= c < board_size):
        raise SGFError(f"coordinate {value!r} outside {board_size}x{board_size}")
    return r * board_size + c


def _expand_points(values: Sequence[str], board_size: int) -> tuple:
    """Expand an AB/AW point list, including FF[4] compressed rectangles
    (``[aa:cc]`` = the 3x3 block), into flat actions."""
    out = []
    for v in values:
        if ":" in v:
            lo, hi = v.split(":", 1)
            a0, a1 = _coord_to_action(lo, board_size), _coord_to_action(
                hi, board_size)
            r0, c0 = divmod(a0, board_size)
            r1, c1 = divmod(a1, board_size)
            for r in range(min(r0, r1), max(r0, r1) + 1):
                for c in range(min(c0, c1), max(c0, c1) + 1):
                    out.append(r * board_size + c)
        else:
            a = _coord_to_action(v, board_size)
            if a == board_size * board_size:
                raise SGFError("setup stone with empty/pass coordinate")
            out.append(a)
    return tuple(out)


def parse_sgf(text: str) -> SGFGame:
    """Parse SGF text into (board_size, komi, main-line moves, result,
    setup stones).

    Supported: FF[3]/FF[4] single- or multi-node records (incl. FF[3] long
    property names), variations (main line taken, flagged on
    ``SGFGame.has_variations``), escaped values and comments, pass as
    ``[]`` or ``[tt]``, ROOT-node handicap/setup stones AB/AW (incl.
    compressed point lists) with the HA property.  Rejected with a clear
    error: rectangular/oversized boards, AE erasure, mid-game setup
    stones (the engine replays legal games only), and multi-game
    collections — use :func:`parse_sgf_collection` for those.
    """
    forest = _parse_forest(text)
    if len(forest) > 1:
        raise SGFError(
            f"SGF holds a collection of {len(forest)} games; use "
            f"parse_sgf_collection() to read them all"
        )
    return _game_from_nodes(*forest[0])


def parse_sgf_collection(text: str) -> List[SGFGame]:
    """Parse a multi-game SGF collection file -> list of SGFGame (the
    SGF spec allows any number of top-level gametrees per file)."""
    return [_game_from_nodes(nodes, has_var)
            for nodes, has_var in _parse_forest(text)]


def _game_from_nodes(nodes: List[dict], has_variations: bool) -> SGFGame:
    root = nodes[0]
    raw_sz = root.get("SZ", ["19"])[0] or "19"
    if ":" in raw_sz:
        raise SGFError(f"rectangular boards unsupported (SZ[{raw_sz}])")
    try:
        size = int(raw_sz)
    except ValueError:
        raise SGFError(f"bad board size SZ[{raw_sz}]")
    if not (2 <= size <= 19):
        raise SGFError(f"board size {size} outside the supported 2..19")
    if any(p in node for node in nodes for p in ("AB", "AW", "AE")
           if node is not root):
        raise SGFError("mid-game setup stones (AB/AW/AE) are not supported")
    if "AE" in root:
        raise SGFError("setup erasure (AE) is not supported")
    setup_black = _expand_points(root.get("AB", []), size)
    setup_white = _expand_points(root.get("AW", []), size)
    overlap = set(setup_black) & set(setup_white)
    if overlap:
        raise SGFError(f"AB/AW overlap at flat actions {sorted(overlap)}")
    try:
        handicap = int(root.get("HA", ["0"])[0] or 0)
    except ValueError:
        handicap = 0
    try:
        komi = float(root.get("KM", ["0"])[0] or 0.0)
    except ValueError:
        komi = 0.0
    result = root.get("RE", [None])[0]
    moves: List[tuple] = []
    for node in nodes:
        for color in ("B", "W"):
            if color in node:
                moves.append((color, _coord_to_action(node[color][0], size)))
    if moves:
        first = moves[0][0]
    else:
        # after handicap placement white moves first
        first = "W" if setup_black and not setup_white else "B"
    return SGFGame(board_size=size, komi=komi, moves=moves, result=result,
                   setup_black=setup_black, setup_white=setup_white,
                   handicap=handicap, first_to_move=first,
                   has_variations=has_variations)


def setup_state(game: SGFGame, *, device=None, next_state=None):
    """Initial engine state for a parsed game: setup stones placed and the
    invalid-move plane recomputed BY THE ENGINE (a pass is replayed through
    the engine from a pre-flipped-turn board, which re-derives occupied and
    suicide masks; the pass flag is then cleared).  Returns a float64
    (6, N, N) state with ``first_to_move`` to move.

    The pass goes through ``gogame.next_state`` on ``device``, or through
    ``next_state(state, action) -> state`` when given (the GTP engine's native
    stepping)."""
    from gymgo_tpu_torch import gogame, govars

    n = game.board_size
    if not game.setup_black and not game.setup_white \
            and game.first_to_move == "B":
        return gogame.init_state(n)
    raw = np.zeros((govars.NUM_CHNLS, n, n), np.float64)
    for a in game.setup_black:
        raw[govars.BLACK, a // n, a % n] = 1
    for a in game.setup_white:
        raw[govars.WHITE, a // n, a % n] = 1
    # pre-pass turn = opponent of the first mover; the pass flips it
    raw[govars.TURN_CHNL] = 0.0 if game.first_to_move == "W" else 1.0
    if _has_dead_group(raw[govars.BLACK] > 0, raw[govars.WHITE] > 0):
        raise SGFError("setup stones form zero-liberty (dead) groups")
    if next_state is None:
        state = gogame.next_state(raw, n * n, device=device)
    else:
        state = np.asarray(next_state(raw, n * n), np.float64)
    state[govars.PASS_CHNL] = 0.0
    return state


def _has_dead_group(black, white) -> bool:
    """Host-side BFS: any same-color group with zero liberties?  (A pass
    through the engine does not run capture resolution — in legal play a
    pass cannot capture — so dead SETUP stones must be caught here.)"""
    import numpy as np

    n = black.shape[0]
    occupied = black | white
    for plane in (black, white):
        seen = np.zeros_like(plane, dtype=bool)
        for r0, c0 in zip(*np.nonzero(plane & ~seen)):
            if seen[r0, c0]:
                continue
            stack, group = [(int(r0), int(c0))], []
            seen[r0, c0] = True
            has_lib = False
            while stack:
                r, c = stack.pop()
                group.append((r, c))
                for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                    if not (0 <= rr < n and 0 <= cc < n):
                        continue
                    if not occupied[rr, cc]:
                        has_lib = True
                    elif plane[rr, cc] and not seen[rr, cc]:
                        seen[rr, cc] = True
                        stack.append((rr, cc))
            if not has_lib:
                return True
    return False


def replay_sgf(text: str, *, device=None):
    """Parse and replay an SGF game through the port's ``gogame`` on
    ``device``.

    Returns (SGFGame, states) where states is the list of (6, N, N) float64
    states after each move (states[0] = the setup position).  Raises SGFError
    on color-order violations and AssertionError on illegal moves: a strict
    legality checker for external records.
    """
    from gymgo_tpu_torch import gogame

    game = parse_sgf(text)
    state = setup_state(game, device=device)  # handicap stones + first mover, engine-checked
    states = [state]
    for i, (color, action) in enumerate(game.moves):
        expect = "B" if gogame.turn(state) == 0 else "W"
        if color != expect:
            raise SGFError(
                f"move {i}: {color} plays out of turn (expected {expect})"
            )
        state = gogame.next_state(state, action, device=device)
        states.append(state)
    return game, states


def _main(argv=None):  # pragma: no cover - exercised via CLI
    """Replay an SGF record and print the final position + verdict.

    Usage: python -m gymgo_tpu_torch.utils.sgf game.sgf [--cpu]
    Doubles as a strict legality checker for external records.
    """
    import argparse

    from gymgo_tpu_torch import gogame

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("path", help="SGF file to replay")
    ap.add_argument("--cpu", action="store_true", help="replay on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    with open(args.path) as f:
        text = f.read()
    game, states = replay_sgf(text, device=device)
    print(gogame.str(states[-1], device=device))
    black, white = gogame.areas(states[-1], device=device)
    print(
        f"moves={len(game.moves)} komi={game.komi} "
        f"areas B={black} W={white} recorded_result={game.result}"
    )


if __name__ == "__main__":
    _main()
