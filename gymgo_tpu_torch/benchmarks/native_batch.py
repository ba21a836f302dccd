"""Native C++ engine batch throughput: the host CPU-farm path (counterpart
of the JAX package's ``benchmarks/native_batch.py``, over the port's own
``native`` engine).

Measures the OpenMP batch-parallel engine for deployments that step many
games on plain CPU hosts.  Envs are independent, so scaling is expected
~linear in cores until memory-bandwidth bound.  Touches no device.

Usage: python -m gymgo_tpu_torch.benchmarks.native_batch [--board 19]
       [--batch 4096] [--steps 30] [--threads K]
Prints one JSON line: {"metric": "native_env_steps_per_sec_NxN", ...}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from gymgo_tpu_torch.native import NativeGoEngine, load

__all__ = ["random_legal_actions", "main"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def random_legal_actions(rng, states, n):
    b = states.shape[0]
    invd = states[:, 3].reshape(b, -1)
    acts = np.empty((b,), np.int32)
    for i in range(b):
        valid = np.flatnonzero(invd[i] == 0)
        # pass is always valid (index n*n)
        k = rng.integers(0, valid.size + 1)
        acts[i] = n * n if k == valid.size else valid[k]
    return acts


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.benchmarks.native_batch")
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=60)
    ap.add_argument("--threads", type=int, default=0, help="0 = OpenMP default")
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for a uniform command line: this bench never touches a device")
    args = ap.parse_args(argv)

    if args.threads:
        load().gogo_set_threads(args.threads)
    eng = NativeGoEngine(args.board)
    log(f"threads={NativeGoEngine.max_threads()}")

    rng = np.random.default_rng(0)
    n = args.board
    states = np.zeros((args.batch, 6, n, n), np.int8)
    for t in range(args.warmup):  # reach non-trivial board densities
        acts = random_legal_actions(rng, states, n)
        states, _ = eng.batch_next_states(states, acts)
    log(f"warmup done; mean stones/board="
        f"{states[:, :2].sum() / args.batch:.1f}")

    # Pre-draw actions so the measured window is engine-only.
    action_seq = []
    probe = states.copy()
    for t in range(args.steps):
        acts = random_legal_actions(rng, probe, n)
        probe, _ = eng.batch_next_states(probe, acts)
        action_seq.append(acts)

    t0 = time.perf_counter()
    for acts in action_seq:
        states, _ = eng.batch_next_states(states, acts)
    dt = time.perf_counter() - t0
    sps = args.batch * args.steps / dt
    log(f"{dt:.3f}s for {args.steps} x {args.batch} steps")
    print(json.dumps({
        "metric": f"native_env_steps_per_sec_{n}x{n}",
        "value": round(sps, 1),
        "unit": "env-steps/s/host",
        "threads": NativeGoEngine.max_threads(),
    }))


if __name__ == "__main__":
    main()
