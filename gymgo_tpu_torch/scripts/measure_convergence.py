"""Per-env convergence of the bundle flood at steady state (counterpart of the
JAX package's ``scripts/measure_convergence.py``).

The JAX package's bitpack bundle flood runs one while loop over the whole
batch, so every step pays the batch-max substep count; a kernel that
converges each board (or block of boards) on its own pays only its own.  For
``--measure-steps`` consecutive steady-state steps this records every env's
count of substeps to convergence under JAX's schedule (alternating forward
and reverse substeps of the four directions, ``core.flood.bundle_substep``),
for the whole word and for its stone and claim bits apart, and reports per
block size K the work ratio

    sum_t mean_blocks(max_block count) / sum_t max_batch(count)

the share of the batch-max loop's substep work a per-block-convergent flood
would do (1.0: no gain).  The counts are a property of the boards, not of the
device.  The steps are ``step_planes`` over the carried planes from the
uniform sampler (``uniform_random_actions_planes``), so on the card the bundle
kernel launches once a step; after each step the counted schedule's word at
``--maxk`` substeps is held against the kernel's word (``bundle_flood_cuda``)
on the same board, and a step on which any env's word differs is a failure.

``--warm-study`` simulates a sound warm-started flood instead: each step
starts from ``seed | (F_prev & keep)``, where ``keep`` drops every cell whose
previous fixpoint word could exceed the new fixpoint (``warm_start``), checks
that it reaches the cold fixpoint on every env of every step, and reports the
warm and cold counts.

    python -m gymgo_tpu_torch.scripts.measure_convergence [--board 19
        --batch 4096 --warmup-steps 768 --measure-steps 64 --maxk 96]
        [--warm-study] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without one.
The last line is one JSON object with the numbers; the exit code is 1 when
the kernel's word or the warm fixpoint disagrees on any step.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gymgo_tpu_torch.core.flood import bundle_seed_and_gates, bundle_substep, neighbor_or, shift

__all__ = ["conv_counts", "run_flood", "stale_mask", "warm_start", "main"]

CLAIM_BITS = (1 << 18) | (1 << 19)
BLOCKS = (8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _changed(a: torch.Tensor, b: torch.Tensor):
    """Per env: (any bit, any stone bit, any claim bit) differs."""
    d = (a ^ b).flatten(1)
    return (d != 0).any(1), ((d & ~CLAIM_BITS) != 0).any(1), ((d & CLAIM_BITS) != 0).any(1)


def conv_counts(black: torch.Tensor, white: torch.Tensor, maxk: int):
    """Per-env substeps until the bundle flood of ``(black, white)``
    converges, under the JAX package's schedule (forward, reverse, forward,
    ...).  Returns ``(counts, word)``: int32 ``(3, B)`` counts (the last
    substep that changed the whole word, its stone bits, its claim bits; 0
    when the seed is the fixpoint) and the word after ``maxk // 2`` rounds,
    int32 ``(B, N, N)``.  Rounds past the batch's fixpoint change nothing, so
    the loop stops there (one host check a round)."""
    x, gates = bundle_seed_and_gates(black, white)
    counts = torch.zeros((3, x.shape[0]), dtype=torch.int32, device=x.device)
    for k in range(maxk // 2):
        x1 = bundle_substep(x, gates)
        x2 = bundle_substep(x1, gates, reverse=True)
        for t, (a, b) in ((2 * k + 1, (x, x1)), (2 * k + 2, (x1, x2))):
            for i, changed in enumerate(_changed(a, b)):
                counts[i] = torch.where(changed, t, counts[i])
        if torch.equal(x2, x):
            break
        x = x2
    return counts, x


def run_flood(x0: torch.Tensor, gates, maxk: int):
    """The bundle flood from ``x0`` under JAX's schedule for ``maxk // 2``
    rounds: ``(word, counts)``, counts int32 ``(B,)`` the last substep that
    changed each env's word."""
    x = x0
    counts = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    for k in range(maxk // 2):
        x1 = bundle_substep(x, gates)
        counts = torch.where((x1 != x).flatten(1).any(1), 2 * k + 1, counts)
        x2 = bundle_substep(x1, gates, reverse=True)
        counts = torch.where((x2 != x1).flatten(1).any(1), 2 * k + 2, counts)
        if torch.equal(x2, x):
            break
        x = x2
    return x, counts


def stale_mask(fprev, prev_black, prev_white, new_black, new_white, place, frozen):
    """The warm start's drop rule: cells whose previous fixpoint word
    ``fprev`` could exceed the new fixpoint after a stone at ``place``.

    Dropped: the played cell and the captured cells (their class changed);
    stones whose ``fprev`` word equals that of a stone next to the move
    (groups that lost that liberty, and mover groups that merge there); and
    every empty cell of an env where the move touched empty cells or
    captured (a region may split or lose a touch).  Everything else is at
    most the new fixpoint, so an OR-flood from it reaches the same one.
    """
    b = fprev.shape[0]
    prev_stones = prev_black | prev_white
    new_stones = new_black | new_white
    stale_stone = torch.zeros_like(prev_stones)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        sel = shift(place, dr, dc, False) & prev_stones
        word = torch.where(sel, fprev, 0).view(b, -1).sum(1, dtype=torch.int32)
        hit = sel.view(b, -1).any(1)
        stale_stone |= prev_stones & (fprev == word[:, None, None]) & hit[:, None, None]
    captured = prev_stones & ~new_stones & ~frozen[:, None, None]
    touched_empty = ((place | neighbor_or(place)) & ~prev_stones).view(b, -1).any(1)
    reset_empty = (captured.view(b, -1).any(1) | touched_empty)[:, None, None]
    return stale_stone | place | captured | (~new_stones & reset_empty)


def warm_start(fprev, prev_black, prev_white, new_black, new_white, actions, was_done, invalid):
    """``(x0_warm, seed, gates)`` for the flood of the board after ``actions``:
    frozen envs (finished, invalid action, pass) keep their exact previous
    fixpoint, the others start from ``seed | (fprev & ~stale_mask)``."""
    b, n, _ = new_black.shape
    m = n * n
    actions = actions.to(torch.int64)
    frozen = was_done | invalid | (actions == m)
    place = (torch.zeros((b, m), dtype=torch.bool, device=new_black.device)
             .scatter_(1, actions.clamp(0, m - 1)[:, None], ~frozen[:, None]).view(b, n, n))
    drop = stale_mask(fprev, prev_black, prev_white, new_black, new_white, place, frozen)
    seed, gates = bundle_seed_and_gates(new_black, new_white)
    x0 = torch.where(frozen[:, None, None], fprev, seed | torch.where(drop, 0, fprev))
    return x0, seed, gates


def _steady_states(args, dev, gen):
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import rollout

    cfg = EnvConfig(board_size=args.board, batch_size=args.batch, reward_method=HEURISTIC, auto_reset=True)
    t0 = time.perf_counter()
    states = rollout(gen, batch_init_state(args.batch, args.board, device=dev), args.warmup_steps, cfg).final_states
    log(f"warmup {args.warmup_steps} steps {time.perf_counter() - t0:.1f}s")
    return states


def _stats(c):
    return {"mean": float(c.mean()), "p50": float(np.percentile(c, 50)), "p90": float(np.percentile(c, 90)),
            "p99": float(np.percentile(c, 99)), "max": int(c.max())}


def measure(args, dev) -> dict:
    """The per-env count study; the kernel's word checked on the card."""
    from gymgo_tpu_torch.core import actions as _actions
    from gymgo_tpu_torch.core import step as _step
    from gymgo_tpu_torch.ops import bundle_flood as _bundle
    from gymgo_tpu_torch.ops.env_step import labellings

    gen = torch.Generator(device=dev).manual_seed(0)
    states = _steady_states(args, dev, gen)
    on_card = dev.type == "cuda"
    launches0 = labellings()
    ps = _step.seed_planes(states)  # the rollout's carried planes: the kernel seeds atari once
    counts, stones, mismatch, check_launches = [], [], 0, 0
    t0 = time.perf_counter()
    for _ in range(args.measure_steps):
        _step.reset_finished(ps)
        ps, _info = _step.step_planes(ps, _actions.uniform_random_actions_planes(gen, ps))
        # the post-step board is the frozen-resolved post-capture board this step flooded
        c, word = conv_counts(ps.black, ps.white, args.maxk)
        counts.append(c)
        stones.append((ps.black | ps.white).sum())
        if on_card:
            before = _bundle.BUNDLE_FLOOD.launches
            mismatch += int(not torch.equal(word, _bundle.bundle_flood_cuda(ps.black.contiguous(),
                                                                            ps.white.contiguous())))
            check_launches += _bundle.BUNDLE_FLOOD.launches - before
    convs3 = torch.stack(counts).cpu().numpy()  # (T, 3, B)
    step_launches = labellings() - launches0 - check_launches
    log(f"measure done {time.perf_counter() - t0:.1f}s shape={convs3[:, 0].shape} max={convs3[:, 0].max()} "
        f"(budget {args.maxk})")
    convs, convs_stone, convs_claim = convs3[:, 0], convs3[:, 1], convs3[:, 2]
    for name, cc in (("stone-bits", convs_stone), ("claim-bits", convs_claim)):
        bm = cc.max(axis=1)
        print(f"{name}: per-env mean={cc.mean():.1f} p99={np.percentile(cc, 99):.0f} "
              f"max={cc.max()}; batch-max mean={bm.mean():.1f}")
    if convs.max() >= args.maxk - 2:
        log("WARNING: budget possibly exceeded; raise --maxk")
    t, b = convs.shape
    batch_max = convs.max(axis=1)
    n = args.board
    print(f"steady-state {n}x{n} B={b}, T={t} steps")
    print(f"per-env conv substeps: mean={convs.mean():.1f} p50={np.percentile(convs, 50):.0f} "
          f"p90={np.percentile(convs, 90):.0f} p99={np.percentile(convs, 99):.0f} max={convs.max()}")
    print(f"batch-max per step: mean={batch_max.mean():.1f} min={batch_max.min()} max={batch_max.max()}")
    work_ratio = {}
    for k in BLOCKS:
        if k > b:
            continue
        blocks = convs[:, : b // k * k].reshape(t, b // k, k).max(axis=2)
        work_ratio[k] = float(blocks.mean(axis=1).sum() / batch_max.sum())
        print(f"block K={k:5d}: mean block-max={blocks.mean():6.1f}  work ratio vs batch-max={work_ratio[k]:.3f}")
    if on_card:
        print(f"kernel word == counted word at maxk={args.maxk}: {t - mismatch} of {t} steps "
              f"({mismatch} steps differ); bundle labellings: steps {step_launches} "
              f"(1 a step, the fused step's, + 1 seed), checks {check_launches}")
    return {"mode": "measure", "board": n, "batch": b, "steps": t, "maxk": args.maxk,
            "mean_stones": float(torch.stack(stones).float().mean()) / b,
            "per_env": _stats(convs), "stone_bits": _stats(convs_stone), "claim_bits": _stats(convs_claim),
            "batch_max": {"mean": float(batch_max.mean()), "min": int(batch_max.min()),
                          "max": int(batch_max.max())},
            "work_ratio": work_ratio,
            "kernel_checked_steps": t if on_card else 0, "kernel_mismatch_steps": mismatch,
            "step_launches": step_launches if on_card else None}


def warm_study(args, dev) -> dict:
    """The warm-start study: warm fixpoint against cold, every step."""
    from gymgo_tpu_torch.core import actions as _actions
    from gymgo_tpu_torch.core import step as _step

    gen = torch.Generator(device=dev).manual_seed(0)
    states = _steady_states(args, dev, gen)
    ps = _step.seed_planes(states)
    seed, gates = bundle_seed_and_gates(ps.black, ps.white)
    fprev, _ = run_flood(seed, gates, args.maxk)
    warm, cold, equal = [], [], []
    for _ in range(args.measure_steps):
        reset = ps.done
        prev_black = ps.black & ~reset[:, None, None]
        prev_white = ps.white & ~reset[:, None, None]
        fprev = fprev.masked_fill(reset[:, None, None], 0)
        _step.reset_finished(ps)
        actions = _actions.uniform_random_actions_planes(gen, ps)
        nps, info = _step.step_planes(ps, actions)
        x0, seed, gates = warm_start(fprev, prev_black, prev_white, nps.black, nps.white, actions,
                                     info.was_done, info.invalid_action)
        fx_warm, conv_w = run_flood(x0, gates, args.maxk)
        fx_cold, conv_c = run_flood(seed, gates, args.maxk)
        equal.append(torch.equal(fx_warm, fx_cold))
        warm.append(conv_w)
        cold.append(conv_c)
        ps, fprev = nps, fx_cold
    cw, cc = torch.stack(warm).cpu().numpy(), torch.stack(cold).cpu().numpy()
    print(f"fixpoint equality every step: {all(equal)}")
    print(f"cold: per-env mean={cc.mean():.1f} batch-max mean={cc.max(1).mean():.1f}")
    print(f"warm: per-env mean={cw.mean():.1f} batch-max mean={cw.max(1).mean():.1f} "
          f"p99 of batch-max={np.percentile(cw.max(1), 99):.0f}")
    return {"mode": "warm-study", "board": args.board, "batch": args.batch, "steps": args.measure_steps,
            "fixpoint_equal_every_step": all(equal), "equal_steps": sum(equal),
            "cold": {"per_env_mean": float(cc.mean()), "batch_max_mean": float(cc.max(1).mean())},
            "warm": {"per_env_mean": float(cw.mean()), "batch_max_mean": float(cw.max(1).mean()),
                     "batch_max_p99": float(np.percentile(cw.max(1), 99))}}


def main(argv=None) -> int:
    from gymgo_tpu_torch.core.state import resolve_device

    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.measure_convergence",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--warmup-steps", type=int, default=768)
    ap.add_argument("--measure-steps", type=int, default=64)
    ap.add_argument("--maxk", type=int, default=96, help="substep budget")
    ap.add_argument("--warm-study", action="store_true")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device={name}")
    with torch.no_grad():
        rec = warm_study(args, dev) if args.warm_study else measure(args, dev)
    rec["device"] = name
    print(json.dumps(rec))
    ok = rec["fixpoint_equal_every_step"] if args.warm_study else rec["kernel_mismatch_steps"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
