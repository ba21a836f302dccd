"""Batched 19x19 env-steps/s of the PyTorch port on one card (counterpart of
``bench.py``).

Protocol (``bench.py``'s): 19x19 board, 12288 lockstep envs by default
(``BASELINE.json`` configs[2]; ``--batch`` picks another), heuristic reward
(Trump-Taylor area scoring every step), auto-reset, uniform-random legal
policy.  ``gymgo_tpu_torch.env.batch_env.rollout`` first plays a warmup of
``--warmup-steps`` so the timed windows start from a steady-state population
(flood work reflects mid- and late-game boards, not empty ones); then
``--repeats`` windows of ``--steps`` steps, each from those boards and each
ending on a scalar checksum fetch, which waits for the card.

    python3 bench_torch.py [--batch 12288] [--cpu]

Prints exactly one JSON line on stdout (diagnostics go to stderr):
``bench.py``'s keys, ``value`` the best window's rate as there, beside the
rate of every window, their median, the device's name and, on a card, its
name and power limit from ``nvidia-smi``.  Without ``--cpu`` it runs on the
card and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--batch", type=int, default=12288)
    ap.add_argument("--steps", type=int, default=64, help="timed rollout length")
    ap.add_argument("--warmup-steps", type=int, default=768, help="steady-state warmup rollout length")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--reward", default="heuristic")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions of the kernels)")
    args = ap.parse_args(argv)

    import torch

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.ops.bundle_flood import BUNDLE_FLOOD

    dev = resolve_device("cpu" if args.cpu else None)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    smi = nvidia_smi() if on_card else None
    log(f"device={name} nvidia-smi={smi}")
    cfg = EnvConfig(board_size=args.board, batch_size=args.batch, reward_method=args.reward, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def window(states, steps):
        r = rollout(gen, states, steps, cfg)
        checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
        return r.final_states, checksum

    t0 = time.perf_counter()
    states, _ = window(batch_init_state(args.batch, args.board, device=dev), args.warmup_steps)
    stones = states[:, :2].to(torch.int32).sum().item()
    log(f"warmup {args.warmup_steps} steps in {time.perf_counter() - t0:.1f}s; "
        f"mean stones/board={stones / args.batch:.1f}")

    rates = []
    launches = BUNDLE_FLOOD.launches
    for i in range(args.repeats):
        t0 = time.perf_counter()
        window(states, args.steps)
        dt = time.perf_counter() - t0
        rates.append(args.batch * args.steps / dt)
        log(f"run {i}: {dt:.4f}s  ({rates[-1]:,.0f} steps/s)")
    best = max(rates)
    print(json.dumps({
        "metric": f"env_steps_per_sec_per_chip_{args.board}x{args.board}",
        "value": round(best, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(best / 1_000_000, 4),
        "runs": [round(x, 1) for x in rates],
        "median": round(statistics.median(rates), 1),
        "batch": args.batch,
        "device": name,
        "nvidia_smi": smi,
        "kernel_launches": BUNDLE_FLOOD.launches - launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
