"""Reference-protocol single-env benchmark (counterpart of the JAX package's
``benchmarks/efficiency.py``).

Reproduces the measurement protocol of the reference's
``gym_go/tests/efficiency.py`` (9x9 board, 64 iterations: scripted 79-move
games; a copy+RNG lower bound; random self-play with ``children()`` each step)
so numbers compare across engines:

  --engine torch      the port's GoEnv with backend="torch" on the device
                      (the CUDA card unless --cpu)
  --engine native     the port's GoEnv on its C++ host engine
  --engine default    the port's GoEnv with its out-of-the-box backend="auto"
                      (native where it builds, else torch on the device)

Run: python -m gymgo_tpu_torch.benchmarks.efficiency --engine native
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["make_env", "ordered_trajs", "lower_bound", "rand_trajs_with_children", "main"]


def make_env(engine: str, boardsize: int, device=None):
    from gymgo_tpu_torch.env import GoEnv

    if engine == "default":
        return GoEnv(size=boardsize, reward_method="real", device=device)
    if engine == "native":
        return GoEnv(size=boardsize, reward_method="real", backend="native")
    return GoEnv(size=boardsize, reward_method="real", backend="torch", device=device)


def ordered_trajs(env, boardsize, iterations):
    durs = []
    for _ in range(iterations):
        start = time.time()
        env.reset()
        for a in range(boardsize ** 2 - 2):
            env.step(a)
        durs.append(time.time() - start)
    print(f"Ordered Trajs: {np.mean(durs):.3f} AVG, {np.std(durs):.3f} STD", flush=True)
    return float(np.mean(durs))


def lower_bound(env, boardsize, iterations):
    durs = []
    for _ in range(iterations):
        start = time.time()
        state = env.reset()
        max_steps = boardsize ** 2
        for s in range(max_steps):
            for _ in range(max_steps - s):
                np.copy(state)
            pi = np.ones(boardsize ** 2 + 1) / (boardsize ** 2 + 1)
            np.random.choice(np.arange(boardsize ** 2 + 1), p=pi)
            np.copy(state)
        durs.append(time.time() - start)
    print(f"Lower bound: {np.mean(durs):.3f} AVG, {np.std(durs):.3f} STD", flush=True)
    return float(np.mean(durs))


def rand_trajs_with_children(env, boardsize, iterations):
    durs, num_steps = [], []
    for _ in range(iterations):
        start = time.time()
        env.reset()
        max_steps = 2 * boardsize ** 2
        s = 0
        for s in range(max_steps):
            valid_moves = env.valid_moves()
            env.children(canonical=True)
            if np.sum(valid_moves) > 1:
                valid_moves[-1] = 0
            probs = valid_moves / np.sum(valid_moves)
            a = np.random.choice(np.arange(boardsize ** 2 + 1), p=probs)
            _, _, done, _ = env.step(a)
            if done:
                break
        num_steps.append(s)
        durs.append(time.time() - start)
    print(
        f"Rand Trajs w/ Children: {np.mean(durs):.3f} AVG SEC, "
        f"{np.std(durs):.3f} STD SEC, {np.mean(num_steps):.1f} AVG STEPS",
        flush=True,
    )
    return float(np.mean(durs))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.benchmarks.efficiency")
    ap.add_argument("--engine", choices=["torch", "native", "default"], default="native")
    ap.add_argument("--boardsize", type=int, default=9)
    ap.add_argument("--iterations", type=int, default=64)
    ap.add_argument("--skip-children", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="put the torch engine on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    np.random.seed(0)
    env = make_env(args.engine, args.boardsize, "cpu" if args.cpu else None)
    where = f" device={env.device}" if env.backend == "torch" else ""
    print(f"engine={args.engine} backend={env.backend}{where} boardsize={args.boardsize} iters={args.iterations}")
    ordered_trajs(env, args.boardsize, args.iterations)
    lower_bound(env, args.boardsize, args.iterations)
    if not args.skip_children:
        rand_trajs_with_children(env, args.boardsize, args.iterations)


if __name__ == "__main__":
    main()
