"""Evaluate a trained checkpoint against uniform-random (or another
checkpoint) with its full training-time search: the strength yardstick
(counterpart of the JAX package's ``scripts/eval_ckpt.py``).

The checkpoint plays batched matches (``rl.evaluate.play_match``) with the
Gumbel MCTS policy under the pass-to-win match rule.  A checkpoint is a JAX
artifact, a JAX ``train.py`` checkpoint or this port's trainer checkpoint;
one of another size, width or depth than the flags name raises.

Usage:
  python -m gymgo_tpu_torch.scripts.eval_ckpt --ckpt artifacts/az9_r5_iter100_params.npz \\
      --board 9 --channels 64 --blocks 3 --sims 32 --games 128
  # head-to-head between two checkpoints:
  python -m gymgo_tpu_torch.scripts.eval_ckpt --ckpt A.npz --opp-ckpt B.npz ...

Runs on the CUDA card unless ``--cpu`` is given.  Fault tolerance
(``--retries N``, default 2): this process becomes a light supervisor that
imports no torch; it runs itself as a child with a per-chunk JSONL ledger
(``--state-file``), and when the child dies it probes the device in a fresh
process and relaunches: completed chunks are never replayed, so one crash
costs one chunk.  A chunk's generator is seeded from ``(--seed, chunk
index)`` alone, so a redone chunk plays the same games.  ``--retries 0`` is
the bare single-process path.
"""

from __future__ import annotations

import argparse
import math
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.eval_ckpt")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--opp-ckpt", default="",
                    help="opponent checkpoint; empty = uniform-random")
    ap.add_argument("--board", type=int, default=13)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--opp-channels", type=int, default=0,
                    help="opponent net width (0 = same as --channels); "
                         "lets a grown net play its smaller parent")
    ap.add_argument("--opp-blocks", type=int, default=0,
                    help="opponent net depth (0 = same as --blocks)")
    ap.add_argument("--sims", type=int, default=32)
    ap.add_argument("--gumbel-m", type=int, default=8)
    ap.add_argument("--games", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=128,
                    help="games per device batch; requests larger than "
                         "this run as multiple chunks aggregated on the host")
    ap.add_argument("--opening-moves", type=int, default=0,
                    help=">0: force the first k plies to random board "
                         "moves shared within each color-swapped game "
                         "pair, so head-to-heads measure strength, not "
                         "empty-board style lock")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="0 = auto (2.5 * board^2)")
    ap.add_argument("--komi", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    ap.add_argument("--retries", type=int, default=2,
                    help="max child relaunches after a worker crash; "
                         "0 = run bare in this process (child mode)")
    ap.add_argument("--state-file", default="",
                    help="JSONL chunk ledger; auto-derived under logs/ "
                         "when --retries > 0 and unset")
    ap.add_argument("--child-timeout", type=float, default=5400.0,
                    help="supervisor kills a child attempt after this "
                         "many seconds (hang protection)")
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    n_chunks = max(1, math.ceil(args.games / min(args.chunk, args.games)))

    if args.retries > 0:
        _supervise(args, argv, n_chunks)
        return

    import torch

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_checkpoint
    from gymgo_tpu_torch.core.actions import uniform_random_actions
    from gymgo_tpu_torch.core.state import resolve_device
    from gymgo_tpu_torch.rl import make_gumbel_mcts_policy, play_match, with_pass_to_win
    from gymgo_tpu_torch.utils import faulttol

    device = resolve_device("cpu" if args.cpu else None)

    def search_policy(path, channels, blocks):
        net = load_aznet_checkpoint(path, device=device, expect=(args.board, channels, blocks))
        # pass suppressed inside the search; the wrapper adds only the
        # game-sealing pass
        return with_pass_to_win(make_gumbel_mcts_policy(
            net, num_simulations=args.sims, max_considered=args.gumbel_m,
            komi=args.komi, pass_min_stones=1 << 20), komi=args.komi)

    policy_a = search_policy(args.ckpt, args.channels, args.blocks)
    if args.opp_ckpt:
        policy_b = search_policy(args.opp_ckpt, args.opp_channels or args.channels,
                                 args.opp_blocks or args.blocks)
        b_name = args.opp_ckpt
    else:
        policy_b = uniform_random_actions
        b_name = "uniform-random"

    chunk = min(args.chunk, args.games)
    cfg = EnvConfig(board_size=args.board, batch_size=chunk,
                    komi=args.komi, auto_reset=False)
    max_steps = args.max_steps or int(2.5 * args.board * args.board)

    ledger = faulttol.load_ledger(args.state_file)
    wins = losses = ties = unfinished = 0
    swins = slosses = 0
    for ci in range(n_chunks):
        rec = ledger.get(str(ci))
        if rec is None:
            gen = torch.Generator(device=device).manual_seed(faulttol.chunk_seed(args.seed, str(ci)))
            res = play_match(gen, policy_a, policy_b, cfg, num_games=chunk, max_steps=max_steps,
                             opening_moves=args.opening_moves, device=device)
            rec = {"wins": int(res.policy_a_wins),
                   "losses": int(res.policy_b_wins),
                   "ties": int(res.ties),
                   "unfinished": int(res.unfinished),
                   "scored_wins": int(res.a_scored_wins),
                   "scored_losses": int(res.b_scored_wins)}
            if args.state_file:
                faulttol.append_chunk(args.state_file, str(ci), rec)
        wins += rec["wins"]
        losses += rec["losses"]
        ties += rec["ties"]
        unfinished += rec["unfinished"]
        swins += rec["scored_wins"]
        slosses += rec["scored_losses"]
        if n_chunks > 1:
            print(f"  chunk {ci + 1}/{n_chunks}: cumulative "
                  f"{wins}W/{losses}L/{ties}T "
                  f"({unfinished} unfinished)", flush=True)
    _report(args, b_name, wins, losses, ties, unfinished, swins, slosses)


def _report(args, b_name, wins, losses, ties, unfinished,
            scored_wins=None, scored_losses=None):
    finished = max(wins + losses + ties, 1)
    line = (f"{args.ckpt} (gumbel-{args.sims}"
            + (f", open-{args.opening_moves}" if args.opening_moves else "")
            + f") vs {b_name}: {wins}W/{losses}L/{ties}T, "
            f"{unfinished} unfinished, winrate={wins / finished:.3f}")
    if unfinished and scored_wins is not None:
        # unfinished games adjudicated by Trump-Taylor area at the cap
        total = wins + losses + ties + unfinished
        line += (f"; area-adjudicated {scored_wins}W/{scored_losses}L, "
                 f"winrate={scored_wins / max(total, 1):.3f}")
    print(line)


def _supervise(args, argv, n_chunks):
    """Run this module as a supervised child (see the module docstring).
    Imports no torch here: a wedged device must not be able to hang the
    supervisor."""
    from gymgo_tpu_torch.utils import faulttol

    state_file = args.state_file or faulttol.default_state_file("evalstate", argv)
    prior = faulttol.load_ledger(state_file)
    if prior:
        print(f"[eval] resuming: {len(prior)} completed chunk(s) in "
              f"{state_file}", flush=True)

    ledger = faulttol.supervise(
        faulttol.child_argv("gymgo_tpu_torch.scripts.eval_ckpt", argv, state_file), state_file,
        expected_chunks=[str(i) for i in range(n_chunks)],
        max_retries=args.retries,
        child_timeout_s=args.child_timeout,
        cpu_probe=args.cpu,
    )
    recs = [ledger[str(i)] for i in range(n_chunks)]
    total = {f: sum(r[f] for r in recs)
             for f in ("wins", "losses", "ties", "unfinished", "scored_wins", "scored_losses")}
    _report(args, args.opp_ckpt or "uniform-random", total["wins"], total["losses"], total["ties"],
            total["unfinished"], total["scored_wins"], total["scored_losses"])


if __name__ == "__main__":
    main()
