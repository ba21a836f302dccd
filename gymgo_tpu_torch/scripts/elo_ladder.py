"""Round-robin Elo ladder over checkpoint engines (counterpart of the JAX
package's ``scripts/elo_ladder.py``).

Plays every pairing of the given players (colors alternating) through the GTP
stack (``gtp_match.play_game``), or, with ``--batched``, as lockstep batched
matches on the device (``rl.evaluate.play_match``), then fits Bradley-Terry
strengths by the standard minorization-maximization iteration and reports
them on the Elo scale anchored at the first player (use ``random`` first for
an absolute anchor).  Ties and truncated games count as half a win each; a
half virtual draw against every opponent regularizes perfect scores to finite
ratings.

Usage:
  python -m gymgo_tpu_torch.scripts.elo_ladder --boardsize 7 --games 8 \\
      --player random --player iter120=net:ck/iter120.npz:32 \\
      --player iter240=net:ck/iter240.npz:32

Output: a markdown ladder table and the pairwise win matrix.  The nets run on
the CUDA card unless ``--cpu`` is given.  ``--batched`` with ``--retries`` > 0
runs supervised: this process imports no torch, runs itself as a child with a
per-chunk JSONL ledger and relaunches it after a crash; each chunk's generator
is seeded from ``(--seed, chunk key)`` alone, so a redone chunk replays the
same games.
"""

from __future__ import annotations

import argparse
import math
import sys

from gymgo_tpu_torch.scripts import gtp_match

__all__ = ["fit_elo", "main"]


def fit_elo(names, wins, games, anchor=0.0):
    """Bradley-Terry MM fit.  ``wins[i][j]`` = i's win count vs j (ties
    pre-split as 0.5 each side); ``games[i][j]`` = games between i and j.
    Returns Elo ratings with player 0 pinned to ``anchor``."""
    k = len(names)
    # half a virtual draw vs every opponent: keeps 100% scores finite.
    w = [[wins[i][j] + (0.25 if i != j else 0.0) for j in range(k)] for i in range(k)]
    n = [[games[i][j] + (0.5 if i != j else 0.0) for j in range(k)] for i in range(k)]
    p = [1.0] * k
    for _ in range(2000):
        newp = []
        for i in range(k):
            wi = sum(w[i][j] for j in range(k) if j != i)
            denom = sum(
                n[i][j] / (p[i] + p[j]) for j in range(k) if j != i and n[i][j] > 0
            )
            newp.append(wi / denom if denom > 0 else p[i])
        scale = sum(newp) / k
        newp = [x / scale for x in newp]
        delta = max(abs(a - b) for a, b in zip(newp, p))
        p = newp
        if delta < 1e-12:
            break
    elo = [400.0 / math.log(10.0) * math.log(x) for x in p]
    shift = anchor - elo[0]
    return [e + shift for e in elo]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.elo_ladder")
    ap.add_argument("--boardsize", type=int, default=7)
    ap.add_argument("--komi", type=float, default=0.0)
    ap.add_argument("--games", type=int, default=8,
                    help="total games per pair, colors alternating")
    ap.add_argument("--player", action="append", required=True,
                    help="NAME=SPEC or bare SPEC (spec syntax of gtp_match)")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--gumbel-m", type=int, default=16)
    ap.add_argument("--batched", action="store_true",
                    help="play each pairing as batched matches on the device "
                         "(rl.evaluate.play_match: --games lockstep games, "
                         "colors alternating by game index) instead of "
                         "sequential GTP games; truncated games are "
                         "adjudicated by area at the move cap")
    ap.add_argument("--opening-moves", type=int, default=0,
                    help=">0 (--batched only): force the first k plies to "
                         "random board moves shared within each "
                         "color-swapped pair, so the ladder measures "
                         "strength, not empty-board style lock")
    ap.add_argument("--chunk", type=int, default=128,
                    help="--batched: max games per device batch; larger "
                         "--games totals run as aggregated chunks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    ap.add_argument("--retries", type=int, default=2,
                    help="--batched: max child relaunches after a worker "
                         "crash (supervised per-chunk ledger, as in "
                         "eval_ckpt); 0 = bare single process")
    ap.add_argument("--state-file", default="",
                    help="JSONL chunk ledger; auto-derived under logs/ "
                         "when --retries > 0 and unset")
    ap.add_argument("--child-timeout", type=float, default=5400.0)
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)

    names, specs = [], []
    for entry in args.player:
        if "=" in entry and not entry.split("=")[0].startswith("net:"):
            name, spec = entry.split("=", 1)
        else:
            name, spec = entry, entry
        names.append(name)
        specs.append(spec)
    k = len(names)
    if k < 2:
        raise SystemExit("need at least two --player entries")

    if args.batched:
        if args.retries > 0:
            _supervise_batched(args, argv, names)
            return
        wins, games, truncated = _batched_round_robin(args, names, specs)
        _report(args, names, wins, games, truncated)
        return

    device = "cpu" if args.cpu else None
    engines = [
        gtp_match.build_engine(spec, args.boardsize, args.komi,
                               args.seed + i, args.channels, args.blocks, device)
        for i, spec in enumerate(specs)
    ]
    max_moves = 3 * args.boardsize * args.boardsize

    wins = [[0.0] * k for _ in range(k)]
    games = [[0] * k for _ in range(k)]
    truncated = 0
    for i in range(k):
        for j in range(i + 1, k):
            for g in range(args.games):
                i_is_black = g % 2 == 0
                black, white = (engines[i], engines[j]) if i_is_black else (
                    engines[j], engines[i])
                r, finished = gtp_match.play_game(
                    black, white, args.boardsize, max_moves)
                if not finished:
                    truncated += 1
                    r = 0.0  # score a truncation as a tie, not by mid-game area
                i_signed = r if i_is_black else -r
                games[i][j] += 1
                games[j][i] += 1
                if i_signed > 0:
                    wins[i][j] += 1.0
                elif i_signed < 0:
                    wins[j][i] += 1.0
                else:
                    wins[i][j] += 0.5
                    wins[j][i] += 0.5
                print(f"{names[i]} vs {names[j]} game {g}: "
                      f"{'+' if i_signed > 0 else '-' if i_signed < 0 else '='}"
                      f"{' (truncated)' if not finished else ''}", flush=True)

    _report(args, names, wins, games, truncated)


def _chunking(args):
    chunk = min(args.chunk, args.games)
    return chunk, max(1, -(-args.games // chunk))


def _batched_round_robin(args, names, specs):
    """All pairings as batched matches on the device, each chunk with a
    generator seeded from ``(seed, chunk key)``."""
    import torch

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_checkpoint
    from gymgo_tpu_torch.core.actions import uniform_random_actions
    from gymgo_tpu_torch.core.state import resolve_device
    from gymgo_tpu_torch.rl import make_gumbel_mcts_policy, play_match, with_pass_to_win
    from gymgo_tpu_torch.utils import faulttol

    device = resolve_device("cpu" if args.cpu else None)

    def parse(spec):
        """-> (net, sims); sims=0 marks the uniform-random player."""
        if spec == "random":
            return None, 0
        if not spec.startswith("net:"):
            raise SystemExit(f"--batched supports specs random / "
                             f"net:CKPT[:SIMS], got {spec!r}")
        parts = spec.split(":")
        sims = int(parts[2]) if len(parts) > 2 else 32
        net = load_aznet_checkpoint(parts[1], device=device,
                                    expect=(args.boardsize, args.channels, args.blocks))
        return net, sims

    def policy(net, sims):
        if sims == 0:
            return uniform_random_actions
        return with_pass_to_win(make_gumbel_mcts_policy(
            net, num_simulations=sims, max_considered=args.gumbel_m,
            komi=args.komi, pass_min_stones=1 << 20), komi=args.komi)

    players = [parse(s) for s in specs]
    chunk, n_chunks = _chunking(args)
    cfg = EnvConfig(board_size=args.boardsize, batch_size=chunk,
                    komi=args.komi, auto_reset=False)
    max_moves = 3 * args.boardsize * args.boardsize

    ledger = faulttol.load_ledger(args.state_file)
    k = len(names)
    wins = [[0.0] * k for _ in range(k)]
    games = [[0] * k for _ in range(k)]
    truncated = 0
    for i in range(k):
        for j in range(i + 1, k):
            pol_a, pol_b = policy(*players[i]), policy(*players[j])
            aw = bw = tie = trunc = 0
            for ci in range(n_chunks):
                ck = f"i{i}-j{j}-c{ci}"
                rec = ledger.get(ck)
                if rec is None:
                    gen = torch.Generator(device=device).manual_seed(faulttol.chunk_seed(args.seed, ck))
                    res = play_match(gen, pol_a, pol_b, cfg, num_games=chunk, max_steps=max_moves,
                                     opening_moves=args.opening_moves, device=device)
                    # truncated games are adjudicated by Trump-Taylor area
                    # at the move cap (rl/evaluate.py scored tallies)
                    rec = {"aw": int(res.a_scored_wins),
                           "bw": int(res.b_scored_wins),
                           "tie": int(res.scored_ties),
                           "trunc": int(res.unfinished)}
                    if args.state_file:
                        faulttol.append_chunk(args.state_file, ck, rec)
                aw += rec["aw"]
                bw += rec["bw"]
                tie += rec["tie"]
                trunc += rec["trunc"]
            truncated += trunc
            total = aw + bw + tie
            wins[i][j] += aw + 0.5 * tie
            wins[j][i] += bw + 0.5 * tie
            games[i][j] += total
            games[j][i] += total
            print(f"{names[i]} vs {names[j]}: {aw}W/{bw}L/{tie}T "
                  f"({trunc} truncated)", flush=True)
    return wins, games, truncated


def _supervise_batched(args, argv, names):
    """Supervised --batched ladder (see eval_ckpt): per-chunk JSONL ledger
    and relaunch after a crash.  No torch import in this process."""
    from gymgo_tpu_torch.utils import faulttol

    state_file = args.state_file or faulttol.default_state_file("ladderstate", argv)
    prior = faulttol.load_ledger(state_file)
    if prior:
        print(f"[ladder] resuming: {len(prior)} completed chunk(s) in "
              f"{state_file}", flush=True)

    k = len(names)
    _, n_chunks = _chunking(args)
    expected = [f"i{i}-j{j}-c{ci}"
                for i in range(k) for j in range(i + 1, k)
                for ci in range(n_chunks)]
    ledger = faulttol.supervise(
        faulttol.child_argv("gymgo_tpu_torch.scripts.elo_ladder", argv, state_file), state_file, expected_chunks=expected,
        max_retries=args.retries, child_timeout_s=args.child_timeout,
        cpu_probe=args.cpu,
    )
    wins = [[0.0] * k for _ in range(k)]
    games = [[0] * k for _ in range(k)]
    truncated = 0
    for i in range(k):
        for j in range(i + 1, k):
            recs = [ledger[f"i{i}-j{j}-c{ci}"] for ci in range(n_chunks)]
            aw, bw, tie = (sum(r[f] for r in recs) for f in ("aw", "bw", "tie"))
            truncated += sum(r["trunc"] for r in recs)
            total = aw + bw + tie
            wins[i][j] += aw + 0.5 * tie
            wins[j][i] += bw + 0.5 * tie
            games[i][j] += total
            games[j][i] += total
    _report(args, names, wins, games, truncated)


def _report(args, names, wins, games, truncated):
    k = len(names)
    elo = fit_elo(names, wins, games)
    order = sorted(range(k), key=lambda i: -elo[i])
    print("\n| player | games | score | Elo |")
    print("|---|---|---|---|")
    for i in order:
        tot = sum(games[i][j] for j in range(k))
        sc = sum(wins[i][j] for j in range(k))
        print(f"| {names[i]} | {tot} | {sc:.1f} | {elo[i]:+.0f} |")
    print("\npairwise wins (row beats column):")
    header = " | ".join(f"{nm:>10}" for nm in names)
    print(f"{'':>10} | {header}")
    for i in range(k):
        row = " | ".join(
            f"{wins[i][j]:>10.1f}" if j != i else f"{'-':>10}" for j in range(k)
        )
        print(f"{names[i]:>10} | {row}")
    if truncated:
        # batched path: adjudicated by area at the cap (rl/evaluate.py
        # scored tallies); GTP path: counted as ties
        print(f"\ntruncated games (area-adjudicated in batched mode): "
              f"{truncated}")


if __name__ == "__main__":
    main()
