"""Head-to-head match between two GTP engines, driven through the GTP
protocol itself (counterpart of the JAX package's ``scripts/gtp_match.py``):
genmove/play text commands, exactly what a tournament controller like
gogui-twogtp does, without the external dependency.

Players are specified as engine specs:
  random                      uniform-random legal mover
  net:<ckpt.npz>[:sims]       AZNet checkpoint, greedy policy or search
                              (sims > 0 -> Gumbel MCTS genmove)

Example (a trained net against random, colors alternating):
  python -m gymgo_tpu_torch.scripts.gtp_match --boardsize 9 --games 20 \\
      --channels 64 --blocks 3 --a net:artifacts/az9_r5_iter100_params.npz:32 --b random

Counts wins by Trump-Taylor area (the engines' own final_score).  Colors
alternate between games to cancel first-move advantage.  The nets run on the
CUDA card unless ``--cpu`` is given; the boards step on the native engine.
"""

from __future__ import annotations

import argparse

__all__ = ["build_engine", "ok", "play_game", "main"]


def build_engine(spec: str, boardsize: int, komi: float, seed: int,
                 channels: int, blocks: int, device=None):
    from gymgo_tpu_torch.utils.gtp import GTPEngine, make_net_genmove

    if spec == "random":
        return GTPEngine(boardsize, komi, None, seed, match_pass_rule=True, device=device)
    if spec.startswith("net:"):
        parts = spec.split(":")
        ckpt = parts[1]
        sims = int(parts[2]) if len(parts) > 2 else 0
        fn = make_net_genmove(ckpt, boardsize, channels, blocks,
                              simulations=sims, komi=komi, seed=seed, device=device)
        return GTPEngine(boardsize, komi, fn, seed, match_pass_rule=True, device=device)
    raise SystemExit(f"unknown engine spec: {spec}")


def ok(resp: str) -> str:
    assert resp.startswith("="), resp
    return resp[1:].strip()


def play_game(black, white, boardsize: int, max_moves: int) -> tuple:
    """Returns ``(result, finished)``: the signed result for BLACK
    (+1 win, -1 loss, 0 tie) and whether the game actually reached a
    double-pass end.  Truncated games (max_moves without a DONE plane) are
    reported so callers can bucket them separately instead of silently
    scoring a mid-game area count as a decisive result."""
    for eng in (black, white):
        ok(eng.handle("clear_board")[0])
    engines = {"b": black, "w": white}
    color = "b"
    finished = False
    for _ in range(max_moves):
        mover = engines[color]
        vertex = ok(mover.handle(f"genmove {color}")[0])
        other = engines["w" if color == "b" else "b"]
        ok(other.handle(f"play {color} {vertex}")[0])
        if mover.state[5, 0, 0]:  # DONE plane
            finished = True
            break
        color = "w" if color == "b" else "b"
    score = ok(black.handle("final_score")[0])  # e.g. "B+3.0", "W+1.5", "0"
    if score.startswith("B+"):
        return 1.0, finished
    if score.startswith("W+"):
        return -1.0, finished
    return 0.0, finished


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.gtp_match")
    ap.add_argument("--boardsize", type=int, default=7)
    ap.add_argument("--komi", type=float, default=0.0)
    ap.add_argument("--games", type=int, default=10)
    ap.add_argument("--a", default="random", help="engine A spec")
    ap.add_argument("--b", default="random", help="engine B spec")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run the nets on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    eng_a = build_engine(args.a, args.boardsize, args.komi, args.seed,
                         args.channels, args.blocks, device)
    eng_b = build_engine(args.b, args.boardsize, args.komi, args.seed + 1,
                         args.channels, args.blocks, device)
    max_moves = 3 * args.boardsize * args.boardsize

    a_wins = b_wins = ties = unfinished = 0
    for g in range(args.games):
        a_is_black = g % 2 == 0
        black, white = (eng_a, eng_b) if a_is_black else (eng_b, eng_a)
        r, finished = play_game(black, white, args.boardsize, max_moves)
        if not finished:
            # hit max_moves without a double pass: the mid-game area count
            # is not a result — bucket separately instead of inflating wins
            unfinished += 1
            print(f"game {g}: A as {'B' if a_is_black else 'W'} -> unfinished",
                  flush=True)
            continue
        a_signed = r if a_is_black else -r
        if a_signed > 0:
            a_wins += 1
        elif a_signed < 0:
            b_wins += 1
        else:
            ties += 1
        print(f"game {g}: A as {'B' if a_is_black else 'W'} -> "
              f"{'A' if a_signed > 0 else 'B' if a_signed < 0 else 'tie'}",
              flush=True)
    total = max(a_wins + b_wins + ties, 1)
    print(f"A: {a_wins}W {b_wins}L {ties}T  winrate={a_wins / total:.3f}"
          + (f"  ({unfinished} unfinished, excluded)" if unfinished else ""))


if __name__ == "__main__":
    main()
