"""Search throughput on one card: batched root decisions per second
(counterpart of the JAX package's ``benchmarks/mcts_bench.py``).

Times complete searches of ``rl.mcts.run_mcts`` (PUCT over the exact env
step) and ``rl.gumbel_mcts.run_gumbel_mcts`` (sequential halving) from
mid-game boards (2 x 64 uniform-random rollout steps), with a fresh
``init_params`` net in float32; each search ends on a scalar fetch, which
waits for the card.  On the card a search replays its CUDA graph
(``utils.graphs.compiled``): the warm-up search runs eagerly and captures it,
the timed ones replay it.  ``--batch-sweep`` runs this module once per batch size
and prints a decisions/s-against-batch table from the ``BENCHJSON`` line each
run prints.

    python -m gymgo_tpu_torch.benchmarks.mcts_bench [--board 19 --batch 256
        --sims 32 --par 8 --channels 64 --blocks 3] [--search puct|gumbel|both]
        [--batch-sweep 128,256,512] [--cpu]

Runs on the card unless ``--cpu`` is given, and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.benchmarks.mcts_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=32)
    ap.add_argument("--par", type=int, default=8)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--search", choices=["puct", "gumbel", "both"], default="both")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--batch-sweep", default="",
                    help="comma-separated batch sizes; runs the selected search at each and prints a "
                         "decisions/s-against-batch table with the per-env cost against the smallest")
    ap.add_argument("--cpu", action="store_true")
    return ap


def sweep(args) -> None:
    """Run this module once per batch size and print the table."""
    if args.search not in ("puct", "gumbel"):
        raise SystemExit("--batch-sweep needs one search (--search puct or gumbel)")
    rows = []
    for bsz in (int(x) for x in args.batch_sweep.split(",")):
        cmd = [sys.executable, "-m", "gymgo_tpu_torch.benchmarks.mcts_bench", "--board", str(args.board), "--batch", str(bsz),
               "--sims", str(args.sims), "--par", str(args.par), "--channels", str(args.channels),
               "--blocks", str(args.blocks), "--search", args.search, "--repeats", str(args.repeats)]
        out = subprocess.run(cmd + (["--cpu"] if args.cpu else []), capture_output=True, text=True,
                             timeout=3600, cwd=_ROOT)
        jline = [ln for ln in out.stdout.splitlines() if ln.startswith("BENCHJSON ")]
        if not jline:
            log(f"B={bsz} FAILED (no BENCHJSON line):\n{out.stderr[-2000:]}")
            continue
        rec = json.loads(jline[0][len("BENCHJSON "):])
        ms = float(rec["ms_per_search"])
        rows.append((bsz, ms))
        log(f"B={bsz}: {ms:.1f} ms/search, {rec['decisions_per_s']:,.0f} decisions/s")
    if rows:
        b0, ms0 = rows[0]
        print(f"{args.search} {args.board}x{args.board} {args.sims} sims ({args.channels}ch x {args.blocks}): "
              f"batch sweep")
        print(f"| B | ms/search | decisions/s | ms/env | degradation vs B={b0} |")
        print("|---|---|---|---|---|")
        for bsz, ms in rows:
            print(f"| {bsz} | {ms:.1f} | {bsz / ms * 1e3:,.0f} | {ms / bsz:.3f} | "
                  f"{ms / bsz / (ms0 / b0):.2f}x |")


def run(args) -> None:
    """Time the selected searches at one batch size."""
    import torch

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts
    from gymgo_tpu_torch.rl.mcts import run_mcts

    dev = resolve_device("cpu" if args.cpu else None)
    n, b = args.board, args.batch
    net = init_params(torch.Generator(device=dev).manual_seed(0),
                      AZNetConfig(board_size=n, channels=args.channels, blocks=args.blocks, dtype=torch.float32))
    cfg = EnvConfig(board_size=n, batch_size=b, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    # mid-game boards (searches over empty boards overstate throughput)
    states = batch_init_state(b, n, device=dev)
    for _ in range(2):
        states = rollout(gen, states, 64, cfg).final_states
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device={name} boards warmed (mean stones {states[:, :2].sum().item() / b:.0f})")

    searches = {
        "puct": lambda g: run_mcts(g, states, net, num_simulations=args.sims, num_parallel=args.par),
        "gumbel": lambda g: run_gumbel_mcts(g, states, net, num_simulations=args.sims),
    }
    results = {}
    for kind in ("puct", "gumbel"):
        if args.search not in (kind, "both"):
            continue
        search = searches[kind]
        search(gen).root_visits.sum().item()  # warm up: cuDNN picks its algorithms
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            search(gen).root_visits.sum().item()
            best = min(best, time.perf_counter() - t0)
        results[kind] = best

    for kind, dt in results.items():
        print(f"{kind}: {b / dt:,.0f} root decisions/s  ({b * args.sims / dt:,.0f} sims/s; {dt * 1e3:.1f} ms per "
              f"{b}-env search, {args.sims} sims" + (f", par={args.par}" if kind == "puct" else "") + ")")
        # the machine-readable line --batch-sweep reads
        print("BENCHJSON " + json.dumps({"search": kind, "batch": b, "sims": args.sims, "ms_per_search": dt * 1e3,
                                         "decisions_per_s": b / dt, "device": name}))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch_sweep:
        sweep(args)
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
