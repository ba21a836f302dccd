"""GTP games at batch 1: ``GTPEngine`` (torch stepping on the card) with a
``GumbelMover`` over the network, sent ``genmove b`` and ``genmove w`` in
turn in a closed loop (the next command goes when the reply has come) until
two passes in a row or ``max_moves`` moves, then ``clear_board``.  Each
``genmove`` is timed from the front end's call to its reply.

The mover's root noise is drawn by the benchmark from the seed
(``gumbel_source``).  To judge the search behind each reply, the benchmark
keeps what ``rl.gumbel_mcts.run_gumbel_mcts`` returned to the mover (its
root, its noise, its result) by a wrapper around it that copies nothing.
Set-up plays ``genmove b`` and ``genmove w`` (the first captures the
search's graph and the board stepping's), goes on playing for ``settle_s``
seconds (``Context.settle``), then sends ``clear_board``, so the window
starts from the empty board.  The traffic's parameters: ``simulations``,
``c_visit`` and ``c_scale`` (the mover's, which takes its search's defaults
for them and 16 root moves considered), ``komi``, ``max_moves``,
``settle_s``, ``trace_genmoves`` and ``net_roots`` (the genmoves at which the
reference evaluates the network).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.drivers.batched_search import gumbel
from portbench.harness import Outcome
from portbench.lib import trace as _trace
from portbench.lib import weights as _weights
from portbench.reference import go, judge

_COLS = "ABCDEFGHJKLMNOPQRST"


def vertex_action(reply: str, n: int) -> int:
    """The flat action of a GTP reply's vertex (``= D4``, ``= pass``); -1 for
    an error reply."""
    text = reply.strip()
    if not text.startswith("="):
        return -1
    v = text[1:].strip().upper()
    if v == "PASS":
        return n * n
    return (n - int(v[1:])) * n + _COLS.index(v[0])


@contextlib.contextmanager
def kept_searches(module, kept: list):
    """Within the block, every call of ``module.run_gumbel_mcts`` appends its
    ``(states, gumbel, result)`` to ``kept``."""
    search = module.run_gumbel_mcts

    def keeping(generator, states, net, *args, **kwargs):
        res = search(generator, states, net, *args, **kwargs)
        kept.append((states, kwargs.get("gumbel"), res))
        return res

    module.run_gumbel_mcts = keeping
    try:
        yield
    finally:
        module.run_gumbel_mcts = search


def run(ctx) -> Outcome:
    from gymgo_tpu_torch.rl import gumbel_mcts
    from gymgo_tpu_torch.utils.gtp import GTPEngine, GumbelMover

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n = cfg["board_size"]
    net, weights = _weights.program_net(cfg, ctx.seed, dev)
    gen_noise = ctx.generator("noise")
    mover = GumbelMover(net, simulations=tr["simulations"], komi=tr["komi"], seed=ctx.seed % (1 << 63),
                        gumbel_source=lambda: gumbel(gen_noise, (1, n * n + 1), dev))
    engine = GTPEngine(board_size=n, komi=tr["komi"], genmove_fn=mover, seed=ctx.seed % (1 << 32),
                       backend="torch", device=dev)
    searches = []
    games, game = [], []
    latencies = []
    state = {"passes": 0, "colour": 0, "errors": 0}

    def new_game():
        engine.handle("clear_board")
        games.append(list(game))
        game.clear()
        state.update(passes=0, colour=0)

    def genmove(timed: bool):
        colour = "bw"[state["colour"]]
        before = len(searches)
        t0 = time.perf_counter()
        with _trace.span("genmove"):
            reply = engine.handle(f"genmove {colour}")[0]
        dt = time.perf_counter() - t0
        if timed:
            latencies.append(dt)
        action = vertex_action(reply, n)
        state["errors"] += action < 0
        game.append((reply, action, searches[before:]))
        state["passes"] = state["passes"] + 1 if action == n * n else 0
        state["colour"] ^= 1
        if state["passes"] >= 2 or len(game) >= tr["max_moves"] or action < 0:
            new_game()

    ctx.note("net and engine made")
    with kept_searches(gumbel_mcts, searches):
        genmove(False)
        ctx.note("first genmove captured")
        genmove(False)
        ctx.settle(lambda: genmove(False))
        new_game()
        state["errors"] = 0
        ctx.setup_done()

        t0 = time.perf_counter()
        while True:
            genmove(True)
            elapsed = time.perf_counter() - t0
            if elapsed >= ctx.seconds:
                break
        host = {"genmove_s": list(latencies), "window_s": elapsed}
        ctx.spread("genmoves", latencies)
        traced = None
        if ctx.trace:
            with _trace.traced(dev) as holder:
                for _ in range(tr["trace_genmoves"]):
                    genmove(False)
                holder["units"] = tr["trace_genmoves"]
            traced = holder["trace"]
    games.append(list(game))
    peak = ctx.window_closed()
    attempted = len(latencies) + (tr["trace_genmoves"] if ctx.trace else 0)
    judged = [_moves(g) for g in games if g]
    segments = [(go.Boards.empty(1, n), moves) for moves, _ in judged if moves]
    del net, engine, mover, searches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge.judge_moves(segments, weights, tr, tr["komi"], go.REAL, ctx.rng("judge"))
    readings["mismatches"] += sum(unjudged for _, unjudged in judged)
    return Outcome(host, attempted, state["errors"], peak, readings, traced)


def _moves(game):
    """The judge's moves of one game, each reply with the search the mover
    ran for it, and the number of replies that cannot be judged: from the
    first reply with no single search behind it (an error, or a move the
    mover did not make) to the end of the game."""
    out = []
    for i, (reply, action, found) in enumerate(game):
        if len(found) != 1 or action < 0:
            return out, len(game) - i
        states, g, res = found[0]
        out.append({"root": states.cpu().numpy(), "gumbel": g.cpu().numpy(), "actions": res.actions.cpu().numpy(),
                    "policy": res.improved_policy.cpu().numpy(), "visits": res.root_visits.cpu().numpy(),
                    "reply": np.array([action])})
    return out, 0
