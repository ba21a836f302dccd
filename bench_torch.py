"""Batched 19x19 env-steps/s of the PyTorch port on one card (counterpart of
``bench.py``).

Protocol (``bench.py``'s): 19x19 board, 12288 lockstep envs by default
(``BASELINE.json`` configs[2]; ``--batch`` picks another), heuristic reward
(Trump-Taylor area scoring every step), auto-reset, uniform-random legal
policy.  The timed program is ``BatchGoEnv.rollout``'s compiled window of
``--steps`` steps (one CUDA graph on the card, as ``bench.py`` times its
jitted ``lax.scan``): its first call runs eagerly and captures the graph
(timed apart), and the warmup to a steady-state population iterates the same
window until ``--warmup-steps`` are played (flood work then reflects mid- and
late-game boards, not empty ones).  Then ``--repeats`` windows of the
compiled rollout and as many of the eager ``rollout``, in turns, each from
those boards and each ending on a scalar checksum fetch, which waits for the
card.  Rates follow the host: compare the two only within one run.

    python3 bench_torch.py [--batch 12288] [--cpu]

Prints exactly one JSON line on stdout (diagnostics go to stderr):
``bench.py``'s keys, ``value`` the best compiled window's rate as there,
beside the rate of every window of both forms, their medians, the bundle
kernel's launches in each form's timed windows, the device's name and, on a
card, its name and power limit from ``nvidia-smi``.  Without ``--cpu`` it
runs on the card and raises when there is none (on the CPU both forms are
the eager function).
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
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
    from gymgo_tpu_torch.ops.bundle_flood import BUNDLE_FLOOD

    dev = resolve_device("cpu" if args.cpu else None)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    smi = nvidia_smi() if on_card else None
    log(f"device={name} nvidia-smi={smi}")
    cfg = EnvConfig(board_size=args.board, batch_size=args.batch, reward_method=args.reward, auto_reset=True)
    env = BatchGoEnv(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    forms = {"compiled": lambda s: env.rollout(gen, s, args.steps), "eager": lambda s: rollout(gen, s, args.steps, cfg)}

    def window(form, states):
        r = forms[form](states)
        checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
        return r.final_states, checksum

    t0 = time.perf_counter()
    states, _ = window("compiled", batch_init_state(args.batch, args.board, device=dev))
    log(f"compile+first run: {time.perf_counter() - t0:.1f}s (compiled: {env.compiled})")
    chunks = max(0, (args.warmup_steps - args.steps) // args.steps)
    t0 = time.perf_counter()
    for _ in range(chunks):
        states, _ = window("compiled", states)
    stones = states[:, :2].to(torch.int32).sum().item()
    log(f"warmup {chunks} x {args.steps} steps in {time.perf_counter() - t0:.1f}s; "
        f"mean stones/board={stones / args.batch:.1f}")

    rates = {form: [] for form in forms}
    launches = dict.fromkeys(forms, 0)
    for i in range(args.repeats):
        for form in forms:
            before = BUNDLE_FLOOD.launches
            t0 = time.perf_counter()
            window(form, states)
            dt = time.perf_counter() - t0
            launches[form] += BUNDLE_FLOOD.launches - before
            rates[form].append(args.batch * args.steps / dt)
            log(f"run {i} {form}: {dt:.4f}s  ({rates[form][-1]:,.0f} steps/s)")
    best = max(rates["compiled"])
    print(json.dumps({
        "metric": f"env_steps_per_sec_per_chip_{args.board}x{args.board}",
        "value": round(best, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(best / 1_000_000, 4),
        "runs": [round(x, 1) for x in rates["compiled"]],
        "median": round(statistics.median(rates["compiled"]), 1),
        "eager_runs": [round(x, 1) for x in rates["eager"]],
        "eager_median": round(statistics.median(rates["eager"]), 1),
        "compiled": env.compiled,
        "batch": args.batch,
        "device": name,
        "nvidia_smi": smi,
        "kernel_launches": launches["compiled"],
        "eager_kernel_launches": launches["eager"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
