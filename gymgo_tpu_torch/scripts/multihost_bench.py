"""Multi-process scaling bench: envs sharded one shard per rank, per-rank and
aggregate env-steps/s (counterpart of the JAX package's
``scripts/multihost_bench.py``).

Run the same command once per rank (or under a cluster launcher); with no
``--coordinator`` it runs one process on its own.  The step makes no
collective, so the ranks only meet at each window's end, where the checksum is
all-reduced.

    python -m gymgo_tpu_torch.scripts.multihost_bench --coordinator <host0>:8476 \\
        --num-processes 4 --process-id $ID --board 19 --envs-per-host 8192

Across machines, give each rank ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` (its
machine's rank count and its place there, as ``torchrun`` sets them): with a
card for each of a machine's ranks the group runs NCCL, else gloo
(``parallel.mesh.initialize_distributed``).

``--envs-per-host`` is the rows each rank steps.  After a ``--warmup-steps``
rollout, ``--repeats`` windows of ``--steps`` steps are timed on the host
clock, each ending on the all-reduced checksum (which waits for the card).
Rank 0 prints one JSON line: every window's rate per rank and in aggregate
(the global env-steps over the slowest rank's window time), the aggregate
median, the device's name and, on a card, its name and power limit from
``nvidia-smi``.  Without ``--device cpu`` it runs on the card and raises
when there is none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

__all__ = ["main", "nvidia_smi"]


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.multihost_bench")
    ap.add_argument("--coordinator", default="", help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--envs-per-host", type=int, default=8192, help="rows per rank")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warmup-steps", type=int, default=768)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core.state import resolve_device
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh
    from gymgo_tpu_torch.parallel.mesh import all_gather_rows, initialize_distributed

    if args.coordinator:
        initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        global_envs = args.envs_per_host * world
        cfg = EnvConfig(board_size=args.board, batch_size=global_envs, reward_method=HEURISTIC, auto_reset=True)
        env = ShardedGoEnv(cfg, make_mesh(devices=[dev] * world))
        gen = torch.Generator(device=dev).manual_seed(0)
        states = env.reset()  # each rank makes only its own rows
        r = env.rollout(gen, states, args.warmup_steps)
        env.checksums(r)
        states = r.final_states
        seconds = []
        for _ in range(args.repeats):
            if world > 1:
                dist.barrier()
            t0 = time.perf_counter()
            r = env.rollout(gen, states, args.steps)
            env.checksums(r)
            seconds.append(time.perf_counter() - t0)
            states = r.final_states
        dts = torch.tensor([seconds], dtype=torch.float64)  # (ranks, windows)
        if world > 1:
            dts = all_gather_rows(dts)
        per_rank = (args.envs_per_host * args.steps / dts).tolist()
        aggregate = (global_envs * args.steps / dts.max(dim=0).values).tolist()
        if args.process_id == 0:
            record = {
                "hosts": world,
                "board": args.board,
                "envs": global_envs,
                "envs_per_host": args.envs_per_host,
                "steps": args.steps,
                "per_rank_env_steps_per_sec": per_rank,
                "aggregate_env_steps_per_sec": aggregate,
                "aggregate_median": statistics.median(aggregate),
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            }
            if dev.type == "cuda":
                record["nvidia_smi"] = nvidia_smi()
            print(f"hosts={world} envs={global_envs} aggregate env-steps/s median "
                  f"{record['aggregate_median']:,.0f}", file=sys.stderr)
            print(json.dumps(record), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
