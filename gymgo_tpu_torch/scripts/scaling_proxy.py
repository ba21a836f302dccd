"""Scaling proxies on one machine (counterpart of the JAX package's
``scripts/scaling_proxy.py``).

Host scaling proper needs several machines.  What one machine can measure are
the two overheads that could break linearity, with the total device and the
total envs held fixed:

  1. ``--mode mesh``: one process, a fixed total batch, the env axis over 1,
     2, 4 and 8 logical shards of one device.  It measures the per-shard cost
     of the collective-free step (on a card: k launches of each kernel per
     step on one stream instead of one).
  2. ``--mode procs``: the same global rollout (same total envs, 4 logical
     shards in all) run by 1 process against 2 processes owning 2 shards
     each, joined through ``torch.distributed``: process start-up, the
     process group, and the all-reduced checksum that ends each window.  Two
     processes on one card share it by time slices.

Each rate is the best of ``--repeats`` windows of ``--steps`` steps after a
``--warmup``, each window ending on the checksum (which waits for the
device); every window's rate is printed beside it.  The last line is one JSON
object with the efficiency table.  Without ``--device cpu`` it runs on the
card and raises when there is none.

    python -m gymgo_tpu_torch.scripts.scaling_proxy --mode mesh
    python -m gymgo_tpu_torch.scripts.scaling_proxy --mode procs
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["main"]

DEFAULTS = dict(board=9, envs=512, steps=32, warmup=96, repeats=3)
SHARDS = 4  # logical shards of the procs mode, split over the processes
WORKER_TIMEOUT_S = 1200
ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device(name: str):
    import torch

    from gymgo_tpu_torch.core.state import resolve_device

    dev = resolve_device(name)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev


def _timed_rollout(env, args):
    """Every window's aggregate env-steps/s of a global rollout."""
    import torch

    dev = env.mesh.local_shards()[0][1]
    gen = torch.Generator(device=dev).manual_seed(0)
    states = env.reset()
    done_warm = 0
    while done_warm < args.warmup:
        r = env.rollout(gen, states, args.steps)
        states = r.final_states
        done_warm += args.steps
    env.checksums(r)
    rates = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        r = env.rollout(gen, states, args.steps)
        env.checksums(r)
        rates.append(args.envs * args.steps / (time.perf_counter() - t0))
        states = r.final_states
    return rates


def _config(args):
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig

    return EnvConfig(board_size=args.board, batch_size=args.envs, reward_method=HEURISTIC, auto_reset=True)


def run_mesh_mode(args):
    """One process; the env axis over 1/2/4/8 logical shards, total envs fixed."""
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh

    dev = _device(args.device)
    rows = []
    for d in (1, 2, 4, 8):
        rates = _timed_rollout(ShardedGoEnv(_config(args), make_mesh(devices=[dev] * d)), args)
        rows.append({"devices": d, "env_steps_per_sec": max(rates), "windows": rates})
        print(f"devices={d}: {max(rates):,.0f} env-steps/s", file=sys.stderr)
    base = rows[0]["env_steps_per_sec"]
    for r in rows:
        r["efficiency_vs_1dev"] = r["env_steps_per_sec"] / base
    print(json.dumps({"mode": "mesh", "board": args.board, "total_envs": args.envs,
                      "device": _device_name(dev), "rows": rows}))


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_procs_mode(args):
    """The same global rollout by 1 process and by 2 over 4 logical shards."""
    results = {}
    for n_proc in (1, 2):
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gymgo_tpu_torch.scripts.scaling_proxy", "--role", "worker",
             "--coordinator", f"localhost:{port}", "--num-processes", str(n_proc), "--process-id", str(pid),
             "--device", args.device] + [a for k in DEFAULTS for a in (f"--{k}", str(getattr(args, k)))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True,
        ) for pid in range(n_proc)]
        try:
            outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"{n_proc}-process run: worker exit codes {[p.returncode for p in procs]}")
        results[n_proc] = json.loads(outs[0].strip().splitlines()[-1])
        print(f"{n_proc} process(es): {results[n_proc]['env_steps_per_sec']:,.0f} env-steps/s", file=sys.stderr)
    eff = results[2]["env_steps_per_sec"] / results[1]["env_steps_per_sec"]
    print(json.dumps({"mode": "procs", "board": args.board, "total_envs": args.envs, "total_devices": SHARDS,
                      "device": results[1]["device"], "rows": [results[1], results[2]],
                      "efficiency_2proc_vs_1proc": eff}))


def run_worker(args):
    import torch.distributed as dist

    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh
    from gymgo_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    try:
        dev = _device(args.device)
        rates = _timed_rollout(ShardedGoEnv(_config(args), make_mesh(devices=[dev] * SHARDS)), args)
        if args.process_id == 0:
            print(json.dumps({"processes": args.num_processes, "env_steps_per_sec": max(rates),
                              "windows": rates, "device": _device_name(dev)}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.scaling_proxy")
    ap.add_argument("--mode", choices=["mesh", "procs"], default="mesh")
    ap.add_argument("--role", choices=["main", "worker"], default="main")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    args = ap.parse_args(argv)
    if args.role == "worker":
        run_worker(args)
    elif args.mode == "mesh":
        run_mesh_mode(args)
    else:
        run_procs_mode(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
