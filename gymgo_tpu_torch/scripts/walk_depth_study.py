"""Depth of the search's selection walk against the batch size (counterpart of
the JAX package's ``scripts/walk_depth_study.py``).

The JAX package's selection walk (``rl.treewalk.walk_paths``) runs one
iteration per depth until the deepest path of the batch ends, so its trip
count is the batch-max depth of the simulation: per-env depths follow one
distribution, but their maximum over B grows about as log B, and the walk's
cost per env grows with the batch though every other stage is linear (the
port's walk runs a fixed ``sim + 1`` iterations at simulation ``sim``, which
no path exceeds).  This measures the distribution directly, per simulation:
the per-env mean, p99 and batch-max depth at several batch sizes on the same
mid-game boards (a 96-step uniform rollout), by wrapping ``walk_paths`` (the
eager search, ``run_gumbel_mcts.fn``, looks it up on the module at every
simulation) and recording each call's ``depth_b``.  Depths are a property of
the search, not of the device.

    python -m gymgo_tpu_torch.scripts.walk_depth_study [--board 13 --sims 32
        --gumbel-m 16 --channels 8 --blocks 1 --batches 64,256,1024
        --searches 4] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without one.
Prints a markdown table, then one JSON object with its rows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

__all__ = ["recording_walk", "search_depths", "main"]


@contextlib.contextmanager
def recording_walk():
    """Within the block every ``rl.treewalk.walk_paths`` call appends its
    ``depth_b`` (int32 (B,), on its device) to the yielded list; the original
    function is put back on the way out."""
    from gymgo_tpu_torch.rl import treewalk

    log = []
    original = treewalk.walk_paths

    def recording(*args, **kw):
        depth_b, path_n, path_a = original(*args, **kw)
        log.append(depth_b.clone())
        return depth_b, path_n, path_a

    treewalk.walk_paths = recording
    try:
        yield log
    finally:
        treewalk.walk_paths = original


def search_depths(boards, net, num_simulations, max_considered, generator=None, gumbel=None):
    """One eager ``run_gumbel_mcts`` over ``boards`` (a captured graph would
    record its capture's depths only): the selection walk's per-env depths,
    one int numpy array (B,) per simulation."""
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts

    with recording_walk() as log:
        run_gumbel_mcts.fn(generator, boards, net, num_simulations=num_simulations,
                           max_considered=max_considered, gumbel=gumbel)
    return [d.cpu().numpy() for d in log]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.walk_depth_study",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=13)
    ap.add_argument("--sims", type=int, default=32)
    ap.add_argument("--gumbel-m", type=int, default=16)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--batches", default="64,256,1024")
    ap.add_argument("--searches", type=int, default=4, help="independent searches per batch size")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params

    dev = resolve_device(args.device)
    n = args.board
    batches = [int(x) for x in args.batches.split(",")]
    net = init_params(torch.Generator(device=dev).manual_seed(0),
                      AZNetConfig(board_size=n, channels=args.channels, blocks=args.blocks))
    max_b = max(batches)
    boards = rollout(torch.Generator(device=dev).manual_seed(1), batch_init_state(max_b, n, device=dev), 96,
                     EnvConfig(board_size=n, batch_size=max_b, auto_reset=True)).final_states

    print(f"| B | per-env mean depth | p99 | mean batch-max | walk-trip ratio vs B={batches[0]} |")
    print("|---|---|---|---|---|")
    rows, base_max = [], None
    for bs in batches:
        gen = torch.Generator(device=dev).manual_seed(2)
        log = []
        for _ in range(args.searches):
            log += search_depths(boards[:bs], net, args.sims, args.gumbel_m, generator=gen)
        d = np.concatenate(log)
        mean_max = float(np.mean([x.max() for x in log]))
        base_max = mean_max if base_max is None else base_max
        rows.append({"batch": bs, "mean_depth": float(d.mean()), "p99": float(np.percentile(d, 99)),
                     "mean_batch_max": mean_max, "ratio": mean_max / base_max})
        print(f"| {bs} | {d.mean():.2f} | {np.percentile(d, 99):.0f} | {mean_max:.2f} | "
              f"{mean_max / base_max:.2f}x |", flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"board": n, "sims": args.sims, "gumbel_m": args.gumbel_m, "channels": args.channels,
                      "blocks": args.blocks, "searches": args.searches, "device": name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
