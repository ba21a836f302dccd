"""GTP (Go Text Protocol) engine front-end (counterpart of
``gymgo_tpu.utils.gtp``).

Exposes the engine as a standard GTP engine so it can play inside any Go GUI
or match harness (gogui, twogtp, ...) and against other engines.  Protocol per
the GTP v2 spec: line-oriented commands over stdin/stdout, responses prefixed
``=`` (success) / ``?`` (failure), optional numeric command ids echoed.

Stepping follows ``GoEnv``'s ``backend``: ``"native"`` steps with the port's
C++ engine (microseconds a move), ``"torch"`` with the port's ``gogame`` on
``device`` (``cuda`` unless named: the bundle kernel on the card), and
``"auto"`` (default) picks native when it builds, else torch on ``device``.
``genmove`` plays uniformly at random by default; with a trained checkpoint
(``make_net_genmove``) it plays the net's masked policy (greedy), Gumbel MCTS
or PUCT with subtree reuse, the search running on ``device``.

Usage: python -m gymgo_tpu_torch.utils.gtp [--boardsize 19] [--komi 7.5]
       [--checkpoint ck.npz --channels 64 --blocks 3 --simulations 32] [--cpu]
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import numpy as np

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.utils import tracing

__all__ = ["GTPEngine", "fixed_handicap_points", "PUCTMover", "GumbelMover", "make_net_genmove", "main"]

_COLS = "ABCDEFGHJKLMNOPQRST"  # GTP column letters (no I)


def _vertex_to_action(vertex: str, n: int) -> Optional[int]:
    v = vertex.strip().upper()
    if v == "PASS":
        return n * n
    if len(v) < 2 or v[0] not in _COLS[:n]:
        return None
    col = _COLS.index(v[0])
    try:
        row_1based = int(v[1:])
    except ValueError:
        return None
    if not (1 <= row_1based <= n):
        return None
    # GTP rows count from the bottom; our row 0 is the top.
    r = n - row_1based
    return r * n + col


def _action_to_vertex(action: int, n: int) -> str:
    if action == n * n:
        return "pass"
    r, c = divmod(int(action), n)
    return f"{_COLS[c]}{n - r}"


class GTPEngine:
    """Stateful GTP command processor (one game at a time)."""

    def __init__(self, board_size: int = 19, komi: float = 7.5,
                 genmove_fn: Optional[Callable] = None, seed: int = 0,
                 match_pass_rule: bool = False, backend: str = "auto",
                 device=None):
        if backend not in ("auto", "native", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.komi = komi
        self._genmove_fn = genmove_fn
        self._rng = np.random.default_rng(seed)
        # Match-play pass discipline (rl.evaluate.with_pass_to_win's rule):
        # pass ONLY when it immediately ends the game as a win, or when no
        # board move is legal.  Self-play-trained nets otherwise "pass when
        # ahead", ceding a free move per pass to opponents who keep playing.
        # Off by default so embedders' genmove_fn decisions are never
        # silently overridden (the replacement move comes from this engine's
        # rng, not the caller's policy); the CLI and the match drivers turn
        # it on explicitly (--raw-pass disables it there).
        self._match_pass_rule = match_pass_rule
        self._backend = backend
        self._device = device
        self._set_boardsize(board_size)

    # -- state helpers ------------------------------------------------------

    def _set_boardsize(self, n: int):
        if not (2 <= n <= 19):
            raise ValueError("unacceptable size")
        self.n = n
        self._native = None
        self.device = None
        backend = self._backend
        if backend in ("auto", "native"):
            from gymgo_tpu_torch.native import NativeGoEngine, NativeUnavailable

            try:
                self._native = NativeGoEngine(n)
                backend = "native"
            except (NativeUnavailable, OSError, ValueError):
                if backend == "native":
                    raise
                backend = "torch"
        if backend == "torch":
            from gymgo_tpu_torch.core.state import resolve_device

            self.device = resolve_device(self._device)
        self.backend = backend
        self._clear()

    def _clear(self):
        self.state = np.zeros((6, self.n, self.n), np.int8)
        self.history: List[np.ndarray] = []
        self.moves: List[int] = []
        self._notify_reset()

    def _turn(self) -> int:
        return int(self.state[govars.TURN_CHNL, 0, 0])

    def _next_state(self, state, action: int):
        """(new int8 state, ok) from this engine's backend; ``ok`` False
        leaves the caller's state as it was."""
        if self._native is not None:
            new, status = self._native.next_state(state, action)
            return new, status == 0
        from gymgo_tpu_torch import gogame

        try:
            new = gogame.next_state(np.asarray(state, np.float64), action, device=self.device)
        except AssertionError:  # gogame's invalid move
            return state, False
        return new.astype(np.int8), True

    def _step(self, action: int) -> bool:
        """Apply a move; False if illegal/finished (state unchanged)."""
        new, ok = self._next_state(self.state, action)
        if ok:
            self.history.append(self.state)
            self.moves.append(action)
            self.state = np.asarray(new, dtype=np.int8)
            self._notify_move(action)
        return ok

    def _areas(self):
        if self._native is not None:
            return self._native.areas(self.state)
        from gymgo_tpu_torch import gogame

        return gogame.areas(self.state.astype(np.float64), device=self.device)

    def _setup_state(self, game):
        """``sgf.setup_state`` stepped by this engine's backend."""
        from gymgo_tpu_torch.utils import sgf as _sgf

        if self._native is not None:
            from gymgo_tpu_torch.native import NativeGoEngine

            engine = NativeGoEngine(game.board_size)  # the record's size, which may not be the board's yet
            return _sgf.setup_state(game, next_state=lambda s, a: engine.next_state(s, a)[0])
        return _sgf.setup_state(game, device=self.device)

    # -- mover notifications (cross-move search-tree reuse) ------------------

    def _notify_move(self, action: int):
        cb = getattr(self._genmove_fn, "on_move", None)
        if cb is not None:
            cb(int(action))

    def _notify_reset(self):
        cb = getattr(self._genmove_fn, "on_reset", None)
        if cb is not None:
            cb()

    def _legal_actions(self) -> np.ndarray:
        invd = self.state[govars.INVD_CHNL].reshape(-1)
        acts = np.flatnonzero(invd == 0)
        return np.concatenate([acts, [self.n * self.n]])

    def _genmove(self) -> int:
        if self._genmove_fn is not None:
            action = int(self._genmove_fn(self.state))
        else:
            action = int(self._rng.choice(self._legal_actions()))
        if self._match_pass_rule:
            action = self._apply_pass_rule(action)
        return action

    def _apply_pass_rule(self, action: int) -> int:
        pass_idx = self.n * self.n
        board_moves = self._legal_actions()[:-1]
        prev_passed = bool(self.state[govars.PASS_CHNL, 0, 0])
        black_area, white_area = self._areas()
        lead = float(black_area - white_area - self.komi)
        if self._turn() == 1:
            lead = -lead
        win_by_pass = prev_passed and lead > 0
        if win_by_pass:
            return pass_idx
        if action == pass_idx and len(board_moves):
            return int(self._rng.choice(board_moves))
        return action

    # -- command dispatch ---------------------------------------------------

    COMMANDS = (
        "protocol_version", "name", "version", "known_command",
        "list_commands", "quit", "boardsize", "clear_board", "komi",
        "play", "genmove", "undo", "showboard", "final_score", "loadsgf",
        "fixed_handicap", "set_free_handicap",
    )

    def handle(self, line: str):
        """Process one GTP line -> (response_text, is_error, should_quit),
        under the span ``gtp.handle``."""
        with tracing.span("gtp.handle"):
            return self._handle(line)

    def _handle(self, line: str):
        line = line.split("#", 1)[0].strip()
        if not line:
            return None, False, False
        parts = line.split()
        cmd_id = ""
        if parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
            if not parts:
                return self._fmt(cmd_id, "unknown command", True), True, False
        cmd, args = parts[0].lower(), parts[1:]

        try:
            if cmd == "protocol_version":
                return self._fmt(cmd_id, "2"), False, False
            if cmd == "name":
                return self._fmt(cmd_id, "gymgo_tpu"), False, False
            if cmd == "version":
                return self._fmt(cmd_id, "1.0"), False, False
            if cmd == "known_command":
                known = bool(args) and args[0].lower() in self.COMMANDS
                return self._fmt(cmd_id, "true" if known else "false"), False, False
            if cmd == "list_commands":
                return self._fmt(cmd_id, "\n".join(self.COMMANDS)), False, False
            if cmd == "quit":
                return self._fmt(cmd_id, ""), False, True
            if cmd == "boardsize":
                self._set_boardsize(int(args[0]))
                return self._fmt(cmd_id, ""), False, False
            if cmd == "clear_board":
                self._clear()
                return self._fmt(cmd_id, ""), False, False
            if cmd == "komi":
                self.komi = float(args[0])
                return self._fmt(cmd_id, ""), False, False
            if cmd == "play":
                return self._cmd_play(cmd_id, args)
            if cmd == "genmove":
                return self._cmd_genmove(cmd_id, args)
            if cmd == "undo":
                if not self.history:
                    return self._fmt(cmd_id, "cannot undo", True), True, False
                self.state = self.history.pop()
                self.moves.pop()
                self._notify_reset()  # trees cannot descend backwards
                return self._fmt(cmd_id, ""), False, False
            if cmd == "showboard":
                return self._fmt(cmd_id, "\n" + self._board_str()), False, False
            if cmd == "final_score":
                return self._fmt(cmd_id, self._score_string()), False, False
            if cmd == "loadsgf":
                return self._cmd_loadsgf(cmd_id, args)
            if cmd == "fixed_handicap":
                return self._cmd_fixed_handicap(cmd_id, args)
            if cmd == "set_free_handicap":
                return self._cmd_set_free_handicap(cmd_id, args)
        except (ValueError, IndexError) as e:
            return self._fmt(cmd_id, f"syntax error: {e}", True), True, False
        return self._fmt(cmd_id, "unknown command", True), True, False

    def _board_str(self) -> str:
        from gymgo_tpu_torch import gogame
        from gymgo_tpu_torch.utils import render as _render

        s = self.state.astype(np.float64)
        black, white = self._areas()
        return _render.board_str(s, black_area=int(black), white_area=int(white),
                                 done=bool(gogame.game_ended(s)), passed=bool(gogame.prev_player_passed(s)),
                                 turn=gogame.turn(s))

    def _cmd_play(self, cmd_id, args):
        if len(args) < 2:
            return self._fmt(cmd_id, "syntax error", True), True, False
        color = args[0].lower()[0]
        want = 1 if color == "w" else 0
        if color not in ("b", "w"):
            return self._fmt(cmd_id, "syntax error", True), True, False
        if want != self._turn():
            # strict alternation: the engine state is Markov in the move
            # sequence; out-of-turn play (handicap-style setup) unsupported
            return self._fmt(cmd_id, "illegal move: out of turn", True), True, False
        action = _vertex_to_action(args[1], self.n)
        if action is None:
            return self._fmt(cmd_id, "invalid vertex", True), True, False
        if not self._step(action):
            return self._fmt(cmd_id, "illegal move", True), True, False
        return self._fmt(cmd_id, ""), False, False

    def _cmd_loadsgf(self, cmd_id, args):
        """GTP ``loadsgf filename [move_number]``: replace the board with
        the SGF's position (handicap setup included) after playing the
        moves BEFORE move_number (all moves if omitted), per the GTP v2
        spec.  Board size and komi follow the file."""
        if not args:
            return self._fmt(cmd_id, "syntax error", True), True, False
        upto = None
        if len(args) > 1:
            try:
                upto = max(int(args[1]) - 1, 0)
            except ValueError:
                return self._fmt(cmd_id, "syntax error", True), True, False
        from gymgo_tpu_torch.utils import sgf as _sgf

        try:
            with open(args[0]) as f:
                # collection files: GTP has one board, load the first game
                game = _sgf.parse_sgf_collection(f.read())[0]
            start = self._setup_state(game)
        except (OSError, _sgf.SGFError):
            return self._fmt(cmd_id, "cannot load file", True), True, False
        if game.board_size != self.n:
            self._set_boardsize(game.board_size)
        else:
            self._clear()
        self.komi = game.komi
        self.state = np.asarray(start, dtype=np.int8)
        moves = game.moves if upto is None else game.moves[:upto]
        for i, (color, action) in enumerate(moves):
            expect = "w" if self._turn() == 1 else "b"
            if color.lower() != expect or not self._step(action):
                return self._fmt(
                    cmd_id, f"illegal move {i} in sgf", True), True, False
        return self._fmt(cmd_id, ""), False, False

    def _place_handicap(self, actions):
        """Place black setup stones on the empty board via the engine-side
        setup path (invalid-move plane recomputed, white to move)."""
        from gymgo_tpu_torch.utils import sgf as _sgf

        game = _sgf.SGFGame(
            board_size=self.n, komi=self.komi, moves=[], result=None,
            setup_black=tuple(int(a) for a in actions), setup_white=(),
            handicap=len(actions), first_to_move="W",
        )
        self.state = np.asarray(self._setup_state(game), dtype=np.int8)
        self.history = []
        self.moves = []
        self._notify_reset()

    def _cmd_fixed_handicap(self, cmd_id, args):
        """GTP ``fixed_handicap <n>``: standard hoshi placement (2-9
        stones), empty board only; responds with the vertex list and
        leaves white to move."""
        if self.state[:2].any() or self.moves:
            return self._fmt(cmd_id, "board not empty", True), True, False
        try:
            k = int(args[0])
        except (ValueError, IndexError):
            return self._fmt(cmd_id, "syntax error", True), True, False
        pts = fixed_handicap_points(self.n, k)
        if pts is None:
            return self._fmt(
                cmd_id, "invalid number of stones", True), True, False
        acts = [r * self.n + c for r, c in pts]
        self._place_handicap(acts)
        verts = " ".join(_action_to_vertex(a, self.n) for a in acts)
        return self._fmt(cmd_id, verts), False, False

    def _cmd_set_free_handicap(self, cmd_id, args):
        """GTP ``set_free_handicap <vertex>...``: caller-chosen handicap
        stones, empty board only."""
        if self.state[:2].any() or self.moves:
            return self._fmt(cmd_id, "board not empty", True), True, False
        if len(args) < 2:
            return self._fmt(cmd_id, "bad vertex list", True), True, False
        acts = []
        for v in args:
            a = _vertex_to_action(v, self.n)
            if a is None or a == self.n * self.n or a in acts:
                return self._fmt(cmd_id, "bad vertex list", True), True, False
            acts.append(a)
        self._place_handicap(acts)
        return self._fmt(cmd_id, ""), False, False

    def _cmd_genmove(self, cmd_id, args):
        with tracing.span("gtp.genmove"):
            return self._genmove_reply(cmd_id, args)

    def _genmove_reply(self, cmd_id, args):
        if not args or args[0].lower()[0] not in ("b", "w"):
            return self._fmt(cmd_id, "syntax error", True), True, False
        want = 1 if args[0].lower()[0] == "w" else 0
        done = self.state[govars.DONE_CHNL, 0, 0] != 0
        if done:  # game over: keep answering pass for either color
            return self._fmt(cmd_id, "pass"), False, False
        if want != self._turn():
            return self._fmt(cmd_id, "illegal move: out of turn", True), True, False
        action = self._genmove()
        if not self._step(action):  # safety: fall back to pass
            action = self.n * self.n
            self._step(action)
        return self._fmt(cmd_id, _action_to_vertex(action, self.n)), False, False

    def _score_string(self) -> str:
        black, white = self._areas()
        diff = float(black) - float(white) - self.komi
        if diff > 0:
            return f"B+{diff:g}"
        if diff < 0:
            return f"W+{-diff:g}"
        return "0"

    @staticmethod
    def _fmt(cmd_id: str, text: str, error: bool = False) -> str:
        prefix = ("?" if error else "=") + (cmd_id if cmd_id else "")
        return f"{prefix} {text}".rstrip() + "\n\n"


def fixed_handicap_points(n: int, k: int):
    """Standard hoshi handicap vertices as (row, col) pairs, or None if
    the request is invalid (GTP v2 fixed_handicap semantics: 2-9 stones,
    board big enough, center-using counts need an odd board)."""
    if not (2 <= k <= 9) or n < 7:
        return None
    d = 3 if n >= 13 else 2
    if k >= 5 and k % 2 == 1 and n % 2 == 0:
        return None  # 5/7/9 use the center point
    c = n // 2
    lo, hi = d, n - 1 - d
    corners = [(hi, lo), (lo, hi), (lo, lo), (hi, hi)]
    sides_lr = [(c, lo), (c, hi)]
    sides_tb = [(lo, c), (hi, c)]
    pts = corners[:k] if k <= 4 else list(corners)
    if k == 5:
        pts += [(c, c)]
    elif k == 6:
        pts += sides_lr
    elif k == 7:
        pts += sides_lr + [(c, c)]
    elif k == 8:
        pts += sides_lr + sides_tb
    elif k == 9:
        pts += sides_lr + sides_tb + [(c, c)]
    return pts


def _batch_of_one(state, device):
    import torch

    return torch.from_numpy(np.asarray(state, np.int8)[None].copy()).to(device)


class PUCTMover:
    """genmove via PUCT MCTS with CROSS-MOVE subtree reuse.

    The GTP engine notifies every applied move (``on_move``) — ours and the
    opponent's — so the stored search tree descends ply by ply
    (``rl.mcts.compact_subtree``) and each ``genmove`` warm-starts from the
    surviving subtree (``rl.mcts.run_mcts`` ``warm_tree``).  ``clear_board``
    / ``boardsize`` / ``undo`` invalidate it (``on_reset``).  Match play: no
    root Dirichlet noise, move = argmax of root visit counts (first of equals),
    so the move draws nothing from the generator.
    """

    def __init__(self, net, simulations: int, komi: float, seed: int = 0,
                 num_parallel: int = 1, reuse_cap: Optional[int] = None):
        import torch

        self._net = net
        self._device = next(net.parameters()).device
        self._simulations = simulations
        self._komi = komi
        self._num_parallel = num_parallel
        self._cap = reuse_cap if reuse_cap is not None else simulations
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        self._tree = None
        self._empty = None  # built lazily from the first state's shape

    def on_move(self, action: int):
        import torch

        from gymgo_tpu_torch.rl.mcts import compact_subtree

        if self._tree is not None:
            actions = torch.tensor([int(action)], device=self._device)
            self._tree = compact_subtree(self._tree, actions, self._cap)

    def on_reset(self):
        self._tree = None

    def __call__(self, state):
        with tracing.span("mover"):
            return self._move(state)

    def _move(self, state):
        from gymgo_tpu_torch.rl.mcts import empty_tree, run_mcts

        st = _batch_of_one(state, self._device)
        shape = tuple(st.shape[1:])
        if self._empty is None or tuple(self._empty.node_states.shape[2:]) != shape:
            self._empty = empty_tree(1, self._cap, shape[-1] * shape[-1] + 1, shape, st.dtype, self._device)
            self._tree = None
        warm = self._tree if self._tree is not None else self._empty
        res, tree = run_mcts(
            self._generator, st, self._net, num_simulations=self._simulations, komi=self._komi,
            num_parallel=self._num_parallel, dirichlet_fraction=0.0, warm_tree=warm, return_tree=True,
        )
        self._tree = tree  # pre-move tree; the engine's on_move descends it
        with tracing.sync("mover"):
            return int(res.root_visits[0].argmax())


class GumbelMover:
    """genmove via stateless Gumbel MCTS (sequential halving) at batch 1.

    The root noise is drawn from a ``torch.Generator`` seeded from ``seed``;
    ``gumbel_source() -> float32 (1, N*N+1)``, when given, supplies it instead
    (a test hands over the JAX package's per-move draws)."""

    def __init__(self, net, simulations: int, komi: float, seed: int = 0,
                 gumbel_source: Optional[Callable] = None):
        import torch

        self._net = net
        self._device = next(net.parameters()).device
        self._simulations = simulations
        self._komi = komi
        self._generator = torch.Generator(device=self._device).manual_seed(seed)
        self._gumbel_source = gumbel_source

    def __call__(self, state):
        from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts

        with tracing.span("mover"):
            gumbel = None if self._gumbel_source is None else self._gumbel_source().to(self._device)
            res = run_gumbel_mcts(self._generator, _batch_of_one(state, self._device), self._net,
                                  num_simulations=self._simulations, komi=self._komi, gumbel=gumbel)
            with tracing.sync("mover"):
                return int(res.actions[0])


def make_net_genmove(checkpoint: str, board_size: int, channels: int,
                     blocks: int, simulations: int = 0,
                     komi: float = 7.5, seed: int = 0,
                     search: str = "gumbel", num_parallel: int = 1,
                     device=None, dtype=None, gumbel_source: Optional[Callable] = None) -> Callable:
    """Mover from a trained AZNet checkpoint on ``device`` (``cuda`` unless
    named): greedy masked policy, or — when ``simulations`` > 0 — Gumbel MCTS
    (``search='gumbel'``, stateless sequential halving) or PUCT with
    cross-move subtree reuse (``search='puct'``).

    ``checkpoint`` is a JAX artifact, a JAX ``train.py`` checkpoint or this
    port's trainer checkpoint (``convert.load_aznet_checkpoint``); a net of
    another size, width or depth raises ``ValueError``.  ``dtype`` is the
    net's compute type, bfloat16 unless given (the tests ask for float32).
    ``gumbel_source`` feeds the Gumbel mover's root noise (``GumbelMover``).

    On the card each mover replays CUDA graphs, as JAX jits them: the Gumbel
    and PUCT movers through ``run_gumbel_mcts``, ``run_mcts`` and
    ``compact_subtree`` (their shapes are the same at every move, the PUCT
    mover's empty tree included), the greedy one its forward and masked
    argmax.  Boards over the route's kernels' size (22x22 on the bundle
    route, 181x181 on the minmax route) run eagerly."""
    import torch

    from gymgo_tpu_torch.convert import load_aznet_checkpoint
    from gymgo_tpu_torch.core import actions as _actions
    from gymgo_tpu_torch.core import transform as _transform
    from gymgo_tpu_torch.utils.graphs import capturable_states, compiled

    if search not in ("gumbel", "puct"):
        raise ValueError(f"unknown search {search!r}")
    net = load_aznet_checkpoint(checkpoint, device=device, dtype=dtype or torch.bfloat16,
                                expect=(board_size, channels, blocks))
    dev = next(net.parameters()).device

    if simulations > 0 and search == "puct":
        return PUCTMover(net, simulations, komi, seed=seed, num_parallel=num_parallel)
    if simulations > 0:
        return GumbelMover(net, simulations, komi, seed=seed, gumbel_source=gumbel_source)

    @torch.no_grad()
    def masked_argmax(states):
        logits, _ = net(_transform.batch_canonical_form(states))
        valid = _actions.batch_valid_moves(states) > 0
        return torch.where(valid, logits, -torch.inf).argmax(dim=-1)

    # a CUDA graph on the card, as JAX jits its greedy mover
    greedy = compiled(masked_argmax, when=capturable_states)

    def pick(state):
        with tracing.span("mover"):
            chosen = greedy(_batch_of_one(state, dev))
            with tracing.sync("mover"):
                return int(chosen[0])

    return pick


def main(argv=None):  # pragma: no cover - exercised via CLI/pipe tests
    import argparse

    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.utils.gtp", description="gymgo_tpu_torch GTP engine")
    ap.add_argument("--boardsize", type=int, default=19)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="AZNet .npz checkpoint for genmove (else random): a JAX artifact, a JAX train.py "
                         "checkpoint or this port's trainer checkpoint")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--simulations", type=int, default=0,
                    help=">0: genmove via search with this budget "
                         "(requires --checkpoint)")
    ap.add_argument("--search", choices=["gumbel", "puct"], default="gumbel",
                    help="search for genmove: stateless Gumbel sequential "
                         "halving, or PUCT with cross-move tree reuse")
    ap.add_argument("--mcts-par", type=int, default=1,
                    help="PUCT leaf-parallel virtual-loss wave width")
    ap.add_argument("--raw-pass", action="store_true",
                    help="disable the match-play pass rule (pass only when "
                         "it immediately wins, or nothing else is legal)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the net (and the board, where the native engine does not build) on the CPU "
                         "instead of the CUDA card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    genmove_fn = None
    if args.checkpoint:
        genmove_fn = make_net_genmove(
            args.checkpoint, args.boardsize, args.channels, args.blocks,
            simulations=args.simulations, komi=args.komi, seed=args.seed,
            search=args.search, num_parallel=args.mcts_par, device=device,
        )
    eng = GTPEngine(args.boardsize, args.komi, genmove_fn, args.seed,
                    match_pass_rule=not args.raw_pass, device=device)
    for line in sys.stdin:
        resp, _err, should_quit = eng.handle(line)
        if resp is not None:
            sys.stdout.write(resp)
            sys.stdout.flush()
        if should_quit:
            break


if __name__ == "__main__":
    main()
