"""Drive gymgo_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero.
Phases 3-7 run the default route (the bundle flood, ``GYMGO_FLOOD=bitpack``),
phases 8-11 the minmax route (``GYMGO_FLOOD=unrolled``):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: nvcc builds both flood kernels from ``gymgo_tpu_torch/csrc``, in
     parallel, and prints each one's ptxas line;
  3. kernel vs plain: the bundle kernel's int32 word equals the plain PyTorch
     version's bit for bit, on random boards at N = 5, 9, 19, 22, on serpentine,
     staircase, spiral, comb, one-colour, empty and checkerboard boards, on
     B = 1, B = 17 and a slice whose address is no multiple of 16 at N = 19,
     and on steady-state 19x19 boards from a rollout;
  4. main path: ``rollout`` at 19x19, B = 12288, heuristic reward, auto-reset,
     uniform sampler: a 768-step warmup, then 5 timed windows of 64 steps, each
     ending on a scalar checksum fetch; the kernel's launch count must grow by
     exactly one per step plus one seeding call per rollout, and the minmax
     kernel's must stay 0;
  5. replay: a 19x19, B = 256, 200-step rollout on the card, from steady-state
     boards of phase 4, is replayed with its actions on the CPU plain path;
     states, rewards and dones must agree;
  6. timing: the kernel (200 launches, twice) against the plain version at
     B = 12288 on the steady-state boards of phase 4, with CUDA events, beside
     the byte bound;
  7. profile: torch.profiler over 16 main-path steps: device time by kernel
     and the device's busy share of the wall time;
  8. minmax kernel vs plain: its int16 (mn, mx) equal the plain version's on
     every cell, on random boards at N = 5, 9, 19, 22, 32, on the shaped
     boards and odd batches of phase 3, and on the steady-state boards of
     phase 4;
  9. minmax route: ``rollout`` as in phase 4, from phase 4's final states, 5
     timed windows of 64 steps; the minmax kernel's launch count must grow by
     exactly one per step plus one per rollout call, the bundle kernel's not
     at all;
 10. route equivalence: phase 9's first window replayed with its actions on
     the default route on the card, and a B = 256, 200-step minmax-route
     rollout replayed on the CPU plain path; states, rewards and dones must
     agree;
 11. timing: the minmax kernel against its plain version on the steady-state
     boards of phase 4, with CUDA events, beside the byte bound;
 12. net on the card: ``load_aznet_npz`` of the committed 19x19 128x6 artifact;
     on 512 steady-state states of phase 4, float32 logits and value on the
     card against the same module on the CPU (TF32 off, atol 2e-4), bfloat16
     against float32 on the card, and the forward time at B = 512 in both;
 13. search at full width: ``run_gumbel_mcts``, 32 simulations, 16 considered,
     B = 256 states of phase 4, the 128x6 net in bfloat16: legal actions,
     32 visits per env, policies that sum to 1 and vanish on invalid moves,
     the same result from the same seed; searches/s, ms, kernel launches and
     host syncs per simulation, bundle launches; then B = 32, 16 simulations,
     float32, injected noise, replayed on the CPU plain path;
 14. a match: ``play_match`` on 9x9, the committed ``az9_r5_iter100`` net with
     the full search wrapped in ``with_pass_to_win`` against the uniform
     sampler, 128 games to the move cap of 243, which it must win at 0.85 or
     better by area; then 8 plies of the same at 19x19 with the 128x6 net,
     B = 128, 4 opening moves;
 15. training at full width: ``params_to_ckpt``'s tree of the committed 19x19
     128x6 iter-830 net (fresh AdamW, an empty replay of 65536 rows, 512 fresh
     boards, iteration 830) resumed by ``gymgo_tpu_torch.train.Trainer`` for 2
     iterations of the recipe that trained it (envs 512, Gumbel 32/16,
     augment, value-grounded-only, lr 2e-4, train batch 1024, bfloat16), with
     the window cut from 160 moves to 8 (the one cut, forced by the run's time
     limit).  Checks: no invalid action, 8192 rows stored, every stored policy
     a distribution over its row's valid moves, finite losses, AdamW step 2,
     the parameters moved, and the bundle kernel launched exactly
     2 x (8 moves x (32 simulations + the move) x 2 + 1) = 1058 times: each
     expansion and each move is a stateless ``step_states`` (one launch
     classifies the board before the move, one is the step's flood) and each
     window ends in one ``winning`` of its final states; the min/max kernel
     0 times.  Per iteration: self-play wall time, env-steps/s, ms per
     simulation, host syncs per move, the learner step's ms by CUDA events;
     then peak memory and a torch.profiler top-6 of one more learner step;
 16. the trainer against the CPU and against itself: (a) a B = 32, 4-move
     Gumbel self-play window (8 simulations, 8 considered), float32, TF32
     off, injected noise, on the card and on the CPU plain path; (b) one
     float32 AdamW step at 64 rows of phase 15's replay on the card and on
     the CPU (loss within 2e-5, gradients within 1e-2 of their largest entry,
     parameters within 2 lr: the first AdamW step moves each by about
     lr * sign(g)); (c) a 19x19 128x6, B = 64, 4-move run checkpointed after its
     first iteration and its second iteration run again from the
     checkpoint: env states, replay, actions and targets bit for bit, the
     parameters after the learner step within a stated atol.

 17. ``gogame`` on the card: 200 moves of a 19x19 game drawn by
     ``gogame.random_action`` from ``np.random.seed(0)``, each
     ``next_state(..., device="cuda")`` equal to the same call on the CPU in
     float64, bit for bit; ``children`` of the board reached (362 rows, plain
     and canonical) and ``batch_next_states`` and ``batch_areas`` on 1,024 of
     phase 4's boards, equal to the CPU; the bundle kernel's launches;
 18. ``GoEnv`` on the card: ``GoEnv(19, reward_method="heuristic",
     backend="torch", device="cuda")`` plays 2 games of up to 400 moves with
     its own ``uniform_random_action`` from a seeded ``np.random``, then 8
     9x9 games to their end, every observation, reward, done and info equal
     to ``backend="native"``'s and ``backend="torch", device="cpu"``'s fed
     the same actions; ms per step on the card and native (median, min,
     max); ``backend="auto"`` picks native;
 19. the benches: ``bench_torch.py`` at ``--batch`` 4096, 12288 and 49152,
     and ``python -m gymgo_tpu_torch.benchmarks.mcts_bench --search gumbel
     --channels 128 --blocks 6 --batch-sweep 128,256,512 --repeats 3``, as
     subprocesses, their JSON line and table parsed;
 20. GTP on the card at full width, the committed 19x19 128x6 net, komi 7.5,
     the match pass rule on: (a) ``make_net_genmove(..., simulations=32,
     search="gumbel")`` in ``GTPEngine(19, backend="native")``, 24 genmoves
     answered by seeded random ``play`` replies: every response '=', every
     move legal for the native engine, exactly 2 x 32 bundle launches per
     genmove, ``final_score`` equal to ``gogame.areas(..., device="cuda")``;
     ms per genmove; one more search under the host-sync counter and the
     profiler; (b) PUCT with subtree reuse, 32 simulations, 10
     genmoves: the carried tree survives ``play``, ``undo`` and
     ``clear_board`` drop it; (c) the greedy mover in float32 (TF32 off) on
     the card against the CPU over 40 plies, equal but where the CPU's top
     two masked logits lie within 1e-4; (d) a seeded random 19x19 session
     through ``GTPEngine(backend="torch", device="cuda")`` and native:
     transcripts equal character for character; (e) 21b's Gumbel mover
     (the 9x9 ``az9_r5_iter100`` net, 32 simulations, komi 0) on the card
     against the CPU, given the same root draws, at 8 positions of a seeded
     random game: float32 (TF32 off) equal but at most one position, and the
     bfloat16 mover's agreement with the CPU counted;
 21. the tools as subprocesses: ``efficiency`` (torch on the card and native,
     2 iterations each), then side by side ``eval_ckpt`` (the 9x9
     ``az9_r5_iter100`` net, search 32/16, 32 games in 2 chunks, move cap 120,
     ``--retries 1`` with a worker killed at chunk 1: the ledger and the
     report add up, the net scores >= 0.85 by area), ``gtp_match`` (4 games,
     ``net:az9:32`` against random, through ``tests/torch_pass_rule.py``,
     which counts the passes the match pass rule replaces by random moves)
     and ``value_probe`` (not collapsed).

Phases 12-14 are the play path, 15 the training path, 17-18 the host surface,
20 the GTP front end; the launch counts are set to 0 before the search, each
match, the training run, the ``gogame`` game, the ``GoEnv`` games and phase
20, and read after.  After phase
15, a replay of the recipe's size takes one add of more rows than its
capacity (81,920 into 65,536): every slot must hold one whole row, the last
65,536 in order.
The line before the nvidia-smi line is a JSON object with both kernels'
numbers; the last line is ``{"ok": true, "device": {...}}``.  Needs one card;
exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SEED = 0
ROOT = Path(__file__).resolve().parent
ARTIFACTS = ROOT / "artifacts"
NET_19 = ARTIFACTS / "az19_big128x6_iter830_params.npz"
NET_9 = ARTIFACTS / "az9_r5_iter100_params.npz"


def fail(msg: str):
    raise RuntimeError(msg)


def serpentine(n):
    m = torch.zeros((n, n), dtype=torch.bool)
    m[0::2, :] = True
    for r in range(1, n, 2):
        m[r, n - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def staircase(n):
    m = torch.zeros((n, n), dtype=torch.bool)
    r = c = 0
    while r < n and c < n:
        m[r, c] = True
        if (r + c) % 2 == 0:
            c += 1
        else:
            r += 1
    return m


def spiral(n):
    """A rectangular spiral one cell wide with one cell between its turns:
    the longest path a board holds.  Its complement is a spiral too."""
    m = torch.zeros((n, n), dtype=torch.bool)
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    r = c = d = turns = 0
    m[0, 0] = True
    inside = lambda x, y: 0 <= x < n and 0 <= y < n
    while turns < 2:
        dr, dc = steps[d]
        nr, nc = r + dr, c + dc
        if (inside(nr, nc) and not m[nr, nc]
                and not (inside(nr + dr, nc + dc) and m[nr + dr, nc + dc])):
            r, c, turns = nr, nc, 0
            m[r, c] = True
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def comb(n):
    """One full row with a tooth hanging from every other column."""
    m = torch.zeros((n, n), dtype=torch.bool)
    m[0, :] = True
    m[:, 0::2] = True
    return m


def component_case(dev, n):
    """Boards that try a component labelling: spirals of stones and of empty
    cells, combs, one component of N*N cells, N*N components of one."""
    sp, cb = spiral(n), comb(n)
    none, full = torch.zeros_like(sp), torch.ones_like(sp)
    idx = torch.arange(n)
    checks = (idx[:, None] + idx[None, :]) % 2 == 0
    a = torch.stack([sp, none, ~sp, sp, cb, none, ~cb, none, full, none, checks, checks, none])
    b = torch.stack([none, sp, none, ~sp, none, cb, cb, none, none, full, ~checks, none, ~checks])
    return (f"components N={n}", a.to(dev).contiguous(), b.to(dev).contiguous())


def board_cases(dev, gen, sizes, shaped_sizes):
    """(name, mover, opp) cases: 1237 random boards at each of ``sizes``;
    serpentine, staircase and component boards at each of ``shaped_sizes``;
    and, at N = 19, one board, 17 boards and a contiguous slice whose address
    is no multiple of 16."""
    cases = []
    for n in sizes:
        r = torch.rand((1237, n, n), generator=gen, device=dev)
        dens = torch.rand((1237, 1, 1), generator=gen, device=dev) * 0.9
        a = r < dens / 2
        b = (r >= dens / 2) & (r < dens)
        cases.append((f"random N={n} B=1237", a.contiguous(), b.contiguous()))
    for maker in (serpentine, staircase):
        for n in shaped_sizes:
            mask = maker(n).to(dev)
            none = torch.zeros_like(mask)
            stack = lambda *xs: torch.stack(xs).contiguous()
            cases.append((f"{maker.__name__} N={n}",
                          stack(mask, none, ~mask, mask),
                          stack(none, mask, none, ~mask & (torch.arange(n * n, device=dev).view(n, n) % 3 == 0))))
    cases += [component_case(dev, n) for n in shaped_sizes]
    _, a, b = next(c for c in cases if c[0].startswith("random N=19"))
    if a[3:].data_ptr() % 16 == 0:
        fail("the sliced planes are aligned; the case would not try a misaligned address")
    cases += [("random N=19 B=1", a[:1], b[:1]), ("random N=19 B=17", a[:17], b[:17]),
              ("random N=19 B=1234 misaligned", a[3:], b[3:])]
    return cases


def boards_of(states):
    """(mover, opp) contiguous bool planes of int8 states, by side to move."""
    wtm = states[:, 2, 0, 0].bool()[:, None, None]
    black, white = states[:, 0].bool(), states[:, 1].bool()
    return (torch.where(wtm, white, black).contiguous(),
            torch.where(wtm, black, white).contiguous())


def time_ms(fn, reps):
    """Mean device ms per call of ``fn`` over ``reps`` calls, by CUDA events,
    after ``reps // 4`` calls (one at least) to warm up: the card's clocks fall
    while it waits for a phase that runs on the CPU."""
    for _ in range(max(1, reps // 4)):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def host_syncs():
    """Yields a list that gains one warning per synchronizing CUDA call made
    inside the block (PyTorch's sync debug mode, set to warn)."""
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(previous)


def device_profile(fn):
    """Run ``fn`` under torch.profiler: (wall us, [(device us, launches,
    kernel name)] by device time).  Kernel events only: an aten op's row
    repeats the time of its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    return wall_us, sorted(rows, reverse=True)


def timed_windows(rollout, gen, states, cfg, window, repeats):
    """``repeats`` rollouts of ``window`` steps, each ending on a scalar
    checksum fetch; returns (env-steps/s per window, the Rollouts, the start
    states of each window)."""
    rates, runs, starts = [], [], []
    for _ in range(repeats):
        starts.append(states)
        t0 = time.perf_counter()
        r = rollout(gen, states, window, cfg)
        checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
        dt = time.perf_counter() - t0
        if not math.isfinite(checksum):
            fail(f"checksum not finite: {checksum}")
        rates.append(cfg.batch_size * window / dt)
        runs.append(r)
        states = r.final_states
    return rates, runs, starts


def rates_text(rates):
    return (f"env-steps/s median {statistics.median(rates):.1f} min {min(rates):.1f} "
            f"max {max(rates):.1f} (runs {', '.join(f'{x:.1f}' for x in rates)})")


def masked_argmax(logits, valid):
    return torch.where(valid, logits, -torch.inf).argmax(dim=1)


def play_path(dev, states, bundle_lib, minmax_lib):
    """Phases 12-14: the net, the search and the match on the card, from the
    steady-state 19x19 ``states`` of phase 4.  Returns the launch counts of
    the search and of the two matches, read after each with the counts set
    to 0 before it: ``(of the bundle kernel, of the min/max kernel)``."""
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.actions import batch_valid_moves, gumbel_noise, uniform_random_actions
    from gymgo_tpu_torch.rl.evaluate import play_match, with_pass_to_win
    from gymgo_tpu_torch.rl.gumbel_mcts import make_gumbel_mcts_policy, run_gumbel_mcts

    SIMS, CONSIDERED = 32, 16
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    # 12. the net on the card
    net32 = load_aznet_npz(NET_19, device=dev, dtype=torch.float32)
    net16 = load_aznet_npz(NET_19, device=dev, dtype=torch.bfloat16)
    cfg19 = net16.config
    if (cfg19.board_size, cfg19.channels, cfg19.blocks) != (19, 128, 6):
        fail(f"{NET_19.name} is not the 19x19 128x6 net: {cfg19}")
    x = states[:512]
    valid = batch_valid_moves(x) > 0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logits_cpu, value_cpu = load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)(x.cpu())
        logits32, value32 = net32(x)
        logits16, value16 = net16(x)
        ms32 = time_ms(lambda: net32(x), 20)
        ms16 = time_ms(lambda: net16(x), 20)
    err_logits = float((logits32.cpu() - logits_cpu).abs().max())
    err_value = float((value32.cpu() - value_cpu).abs().max())
    NET_ATOL = 2e-4  # float32 on both sides, TF32 off: only the order of the sums differs
    if not (err_logits <= NET_ATOL and err_value <= NET_ATOL):
        fail(f"float32 net: card and CPU differ by {err_logits} (logits), {err_value} (value)")
    for t in (logits16, value16):
        if t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
            fail("bfloat16 net: output not finite float32")
    agree = float((masked_argmax(logits16, valid) == masked_argmax(logits32, valid)).float().mean())
    print(f"[12 net] {NET_19.name} 19x19 {cfg19.channels}x{cfg19.blocks}, B=512: float32 card vs CPU "
          f"max |diff| logits {err_logits:.3g}, value {err_value:.3g} (TF32 off, atol {NET_ATOL}); "
          f"bfloat16 vs float32 on the card max |diff| logits {float((logits16 - logits32).abs().max()):.4f}, "
          f"value {float((value16 - value32).abs().max()):.4f}, argmax over legal moves agrees on "
          f"{100 * agree:.1f}% of states; forward float32 (TF32 off) {ms32:.3f} ms, bfloat16 {ms16:.3f} ms",
          flush=True)

    # 13. search at full width
    B13 = 256
    roots = states[:B13].clone()
    valid = batch_valid_moves(roots) > 0

    def search(seed, sims=SIMS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return run_gumbel_mcts(gen, roots, net16, num_simulations=sims, max_considered=CONSIDERED)

    search(SEED + 13)  # warm up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    bundle_lib.launches = minmax_lib.launches = 0
    t0 = time.perf_counter()
    res = search(SEED + 13)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    search_launches, search_minmax = bundle_lib.launches, minmax_lib.launches
    again = search(SEED + 13)
    if not all(torch.equal(p, q) for p, q in zip(res, again)):
        fail("the same seed gave two different searches")
    if not bool(valid.gather(1, res.actions.long()[:, None]).all()):
        fail("the search returned an illegal action")
    if not bool((res.root_visits.sum(1) == SIMS).all()):
        fail("root visits do not sum to the simulation count")
    policy_sum = res.improved_policy.sum(1)
    if not (bool(((policy_sum - 1).abs() < 1e-4).all()) and bool((res.improved_policy[~valid] == 0).all())):
        fail("improved policy does not sum to 1 over the valid moves")
    if not bool(torch.isfinite(res.root_value).all()):
        fail("root value not finite")
    if search_launches < SIMS + 1 or search_minmax != 0:
        fail(f"search: {search_launches} bundle launches, {search_minmax} min/max launches")
    with host_syncs() as caught:
        search(SEED + 13)
    syncs = len(caught)
    prof_wall_us, rows = device_profile(lambda: search(SEED + 13))
    busy_us = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:48]} {us / SIMS:.1f} us x{c / SIMS:.1f}" for us, c, k in rows[:6])
    print(f"[13 search] 19x19 128x6 bfloat16, B={B13}, {SIMS} simulations, {CONSIDERED} considered: "
          f"{B13 / wall:.1f} searches/s, {1e3 * wall / SIMS:.3f} ms/simulation, "
          f"{sum(r[1] for r in rows) / SIMS:.1f} kernel launches and {syncs / SIMS:.2f} host syncs per "
          f"simulation, bundle launches {search_launches} (the board before the move and after it, per expansion); "
          f"under the profiler {prof_wall_us / SIMS:.1f} us/simulation wall, device busy "
          f"{busy_us / SIMS:.1f} us/simulation; top: {top}", flush=True)

    B_R, SIMS_R = 32, 16
    noise = gumbel_noise(torch.Generator(device=dev).manual_seed(SEED + 14), (B_R, 19 * 19 + 1), dev)
    on_card = run_gumbel_mcts(None, roots[:B_R], net32, num_simulations=SIMS_R,
                              max_considered=CONSIDERED, gumbel=noise)
    net_cpu = load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)
    on_cpu = run_gumbel_mcts(None, roots[:B_R].cpu(), net_cpu, num_simulations=SIMS_R,
                             max_considered=CONSIDERED, gumbel=noise.cpu())
    differ = int(((on_card.actions.cpu() != on_cpu.actions)
                  | (on_card.root_visits.cpu() != on_cpu.root_visits).any(1)).sum())
    if differ > 1:
        fail(f"search replay: {differ} of {B_R} envs differ between the card and the CPU")
    policy_err = float((on_card.improved_policy.cpu() - on_cpu.improved_policy).abs().max())
    print(f"[13 search replay] B={B_R}, {SIMS_R} simulations, float32 (TF32 off), injected noise: card vs "
          f"CPU plain path: actions and root visits differ on {differ} of {B_R} envs (at most 1 allowed: "
          f"a float near-tie may flip a visit); max |diff| improved policy {policy_err:.3g}", flush=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # 14. a match, end to end
    def searcher(net):
        policy = make_gumbel_mcts_policy(net, num_simulations=SIMS, max_considered=CONSIDERED,
                                         pass_min_stones=1 << 20)
        return with_pass_to_win(policy)

    net9 = load_aznet_npz(NET_9, device=dev, dtype=torch.bfloat16)
    GAMES, CAP = 128, 3 * 9 * 9
    bundle_lib.launches = minmax_lib.launches = 0
    t0 = time.perf_counter()
    m9 = play_match(torch.Generator(device=dev).manual_seed(SEED + 15), searcher(net9), uniform_random_actions,
                    EnvConfig(board_size=9), num_games=GAMES, max_steps=CAP, device=dev)
    tallies = {k: v.item() for k, v in m9._asdict().items()}
    wall9 = time.perf_counter() - t0
    match9_launches, match9_minmax = bundle_lib.launches, minmax_lib.launches
    if tallies["a_scored_wins"] + tallies["b_scored_wins"] + tallies["scored_ties"] != GAMES:
        fail(f"9x9 match: tallies do not add up: {tallies}")
    if not tallies["a_scored_winrate"] >= 0.85:
        fail(f"9x9 match: the net won {tallies['a_scored_winrate']:.3f} of the games against random")
    print(f"[14 match] 9x9 {NET_9.name} bfloat16, search {SIMS}/{CONSIDERED} with pass-to-win vs uniform "
          f"random, {GAMES} games, cap {CAP}: {json.dumps(tallies)}; {wall9:.1f} s, "
          f"bundle launches {match9_launches}", flush=True)

    PLIES, B14 = 8, 128
    bundle_lib.launches = minmax_lib.launches = 0
    t0 = time.perf_counter()
    m19, final = play_match(torch.Generator(device=dev).manual_seed(SEED + 16), searcher(net16),
                            uniform_random_actions, EnvConfig(board_size=19), num_games=B14,
                            max_steps=PLIES, opening_moves=4, with_states=True, device=dev)
    stones = final[:, :2].to(torch.int32).sum().item() / B14
    wall19 = time.perf_counter() - t0
    match19_launches, match19_minmax = bundle_lib.launches, minmax_lib.launches
    if not PLIES - 0.5 < stones <= PLIES:  # the random side may pass, rarely
        fail(f"19x19 match: {stones} stones a board after {PLIES} plies")
    if match19_launches < PLIES * (SIMS + 1):
        fail(f"19x19 match: {match19_launches} bundle launches in {PLIES} plies")
    print(f"[14 match] 19x19 128x6 bfloat16, B={B14}, 4 opening moves, {PLIES} plies: {PLIES / wall19:.2f} "
          f"plies/s ({B14 * PLIES / wall19:.1f} moves/s, of which the net searches every other one), "
          f"{stones:.2f} stones a board, {m19.unfinished.item()} games unfinished; "
          f"bundle launches {match19_launches}", flush=True)
    minmax_counts = {"search": search_minmax, "match_9x9": match9_minmax, "match_19x19": match19_minmax}
    if any(minmax_counts.values()):
        fail(f"the play path launched the min/max kernel on the default route: {minmax_counts}")
    return ({"search": search_launches, "match_9x9": match9_launches, "match_19x19": match19_launches},
            minmax_counts)


def train_path(dev, states, bundle_lib, minmax_lib, workdir):
    """Phases 15-16: the trainer at full width from the committed 19x19 net,
    then against the CPU and against its own checkpoint.  ``states`` are
    phase 4's steady-state boards.  Returns the training run's launch counts
    ``(of the bundle kernel, of the min/max kernel)``."""
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.actions import gumbel_noise
    from gymgo_tpu_torch.models.az_net import AZNet
    from gymgo_tpu_torch.params_to_ckpt import tree_from_params
    from gymgo_tpu_torch.rl.learner import make_train_state, train_step
    from gymgo_tpu_torch.rl.selfplay import selfplay_gumbel_rollout
    from gymgo_tpu_torch.train import Trainer, build_parser
    from gymgo_tpu_torch.utils import checkpoint as ckpt

    N19, CH, BL = 19, 128, 6
    ENVS, STEPS, SIMS, CONSIDERED, BATCH, CAP, ITERS = 512, 8, 32, 16, 1024, 65536, 2
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def recipe(envs, steps, capacity, *extra):
        return build_parser().parse_args([
            "--board", str(N19), "--channels", str(CH), "--blocks", str(BL), "--envs", str(envs), "--rollout-steps",
            str(steps), "--gumbel-sims", str(SIMS), "--gumbel-m", str(CONSIDERED), "--augment",
            "--value-grounded-only", "--lr", "2e-4", "--train-batch", str(BATCH), "--replay-capacity",
            str(capacity), "--seed", str(SEED), *extra])

    def log(*args, **kw):
        print("[15 train]", *args, flush=True)

    # 15. training at full width
    t0 = time.perf_counter()
    tree = tree_from_params(NET_19, N19, ENVS, CH, BL, 830, lr=2e-4, replay_capacity=CAP, seed=SEED, device=dev)
    path = workdir / "az19_iter830.npz"
    ckpt.save_npz(path, tree)
    trainer = Trainer(recipe(ENVS, STEPS, CAP, "--iters", str(830 + ITERS), "--resume", str(path)),
                      device=dev, log=log)
    setup_s = time.perf_counter() - t0
    start_params = {k: v.detach().cpu().clone() for k, v in tree["params"].items()}
    records = []
    selfplay, learn = trainer.selfplay, trainer.learn

    def timed_selfplay():
        torch.cuda.synchronize()
        t = time.perf_counter()
        with host_syncs() as caught:
            batch = selfplay()
        torch.cuda.synchronize()
        records.append({"selfplay_s": time.perf_counter() - t, "syncs": len(caught),
                        "invalid": int(batch.invalid.sum()), "games": int(batch.done.sum())})
        return batch

    def timed_learn():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = learn()
        end.record()
        torch.cuda.synchronize()
        records[-1]["learner_ms"] = start.elapsed_time(end)
        records[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
        return metrics

    trainer.selfplay, trainer.learn = timed_selfplay, timed_learn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bundle_lib.launches = minmax_lib.launches = 0
    trainer.run()
    torch.cuda.synchronize()
    train_launches, train_minmax = bundle_lib.launches, minmax_lib.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = ITERS * (STEPS * (SIMS + 1) * 2 + 1)
    buf = trainer.buf_state
    rows = ITERS * ENVS * STEPS
    if any(r["invalid"] for r in records):
        fail(f"training: invalid actions in self-play: {[r['invalid'] for r in records]}")
    if int(buf.filled) != rows or int(buf.cursor) != rows:
        fail(f"training: replay filled {int(buf.filled)}, cursor {int(buf.cursor)}, expected {rows}")
    obs, pi = buf.obs[:rows], buf.policy[:rows]
    valid = torch.cat([obs[:, 3].reshape(rows, -1) == 0, torch.ones((rows, 1), dtype=torch.bool, device=dev)], 1)
    if not (bool(((pi.sum(1) - 1).abs() < 1e-4).all()) and bool((pi[~valid] == 0).all())):
        fail("training: a stored policy is not a distribution over its row's valid moves")
    if not all(math.isfinite(x) for r in records for x in r["metrics"].values()):
        fail(f"training: a loss is not finite: {[r['metrics'] for r in records]}")
    opt_steps = {float(st["step"]) for st in trainer.train_state.optimizer.state.values()}
    if trainer.train_state.step != ITERS or opt_steps != {float(ITERS)} or trainer.iteration != 830 + ITERS:
        fail(f"training: step {trainer.train_state.step}, AdamW steps {opt_steps}, iteration {trainer.iteration}")
    moved = max(float((p.detach().cpu() - start_params[k]).abs().max()) for k, p in trainer.net.named_parameters())
    if not moved > 0:
        fail("training: the parameters did not move")
    if train_launches != expected or train_minmax != 0:
        fail(f"training: {train_launches} bundle launches (expected {expected}), {train_minmax} min/max launches")
    for i, r in enumerate(records):
        print(f"[15 train] iteration {830 + i}: self-play {r['selfplay_s']:.3f} s, "
              f"{ENVS * STEPS / r['selfplay_s']:.1f} env-steps/s, {1e3 * r['selfplay_s'] / (STEPS * SIMS):.3f} ms "
              f"per simulation at B={ENVS}, {r['syncs'] / STEPS:.2f} host syncs per move, {r['games']} games ended; "
              f"learner step {r['learner_ms']:.3f} ms (CUDA events: sample, forward, backward, AdamW at {BATCH} "
              f"rows, bfloat16 compute, and the acting copy's refresh); {json.dumps(r['metrics'])}", flush=True)
    prof_wall_us, prof_rows = device_profile(learn)
    print(f"[15 train] {N19}x{N19} {CH}x{BL}, {ITERS} iterations of envs {ENVS}, {STEPS} moves, Gumbel {SIMS}/{CONSIDERED}: "
          f"set-up {setup_s:.2f} s; replay {rows} rows; max |param change| {moved:.3g}; bundle launches "
          f"{train_launches} (= {ITERS} x ({STEPS} x ({SIMS} + 1) x 2 + 1)), min/max {train_minmax}; "
          f"max_memory_allocated {peak_gb:.2f} GiB; one more learner step under the profiler: "
          f"{prof_wall_us / 1e3:.3f} ms wall, device {sum(r[0] for r in prof_rows) / 1e3:.3f} ms in "
          f"{sum(r[1] for r in prof_rows)} launches; top: "
          f"{'; '.join(f'{name[:48]} {us:.1f} us x{c:.1f}' for us, c, name in prof_rows[:6])}", flush=True)

    replay_overflow(dev, N19, ENVS * 160, CAP)

    # 16a. a self-play window on the card and on the CPU
    B_A, STEPS_A, SIMS_A = 32, 4, 8
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    net_card = load_aznet_npz(NET_19, device=dev, dtype=torch.float32)
    net_cpu = load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)
    cfg = EnvConfig(board_size=N19, batch_size=B_A, auto_reset=True)
    noise = gumbel_noise(torch.Generator(device=dev).manual_seed(SEED + 16), (STEPS_A, B_A, N19 * N19 + 1), dev)
    start = states[:B_A].clone()
    kw = dict(num_simulations=SIMS_A, max_considered=SIMS_A, pass_min_stones=N19 * N19 // 2)
    f_card, b_card = selfplay_gumbel_rollout(None, start, net_card, STEPS_A, cfg, gumbel=noise, **kw)
    f_cpu, b_cpu = selfplay_gumbel_rollout(None, start.cpu(), net_cpu, STEPS_A, cfg, gumbel=noise.cpu(), **kw)
    env_differs = (f_card.cpu() != f_cpu).flatten(1).any(1)
    for name in ("actions", "obs", "done", "value_target", "grounded", "mask"):
        x, y = getattr(b_card, name).cpu(), getattr(b_cpu, name)
        env_differs |= (x != y).reshape(STEPS_A, B_A, -1).any(-1).any(0)
    differ = int(env_differs.sum())
    if differ > 1:
        fail(f"self-play window: {differ} of {B_A} envs differ between the card and the CPU")
    same = ~env_differs
    pi_err = float((b_card.policy_target.cpu()[:, same] - b_cpu.policy_target[:, same]).abs().max())
    print(f"[16 card vs CPU] self-play window B={B_A}, {STEPS_A} moves, Gumbel {SIMS_A}/{SIMS_A}, float32 (TF32 "
          f"off), injected noise: actions, obs, done, value targets and final states differ on {differ} of {B_A} "
          f"envs (at most 1 allowed: a float near-tie); max |diff| policy target {pi_err:.3g} on the others; "
          f"{int(b_card.done.sum())} games ended", flush=True)

    # 16b. one float32 learner step on the card and on the CPU.  The gradients
    # agree to rounding, each tensor's relative to its largest entry (1.34e-3
    # seen on the H100; the worst tensor is named).  AdamW's
    # first step moves a parameter by about lr * sign(g), so where a gradient
    # is near 0 rounding can move the card's and the CPU's copy up to 2 lr
    # apart: the parameters are held to 2 lr, and the entries over 2e-5 are
    # counted.
    ROWS_B, LR_B, LOSS_ATOL, GRAD_RTOL = 64, 2e-4, 2e-5, 1e-2
    idx = torch.arange(ROWS_B, device=dev) * 97 % rows
    batch = [t[idx] for t in (buf.obs, buf.policy, buf.value, buf.mask, buf.vmask)]
    sd = {k: torch.as_tensor(v) for k, v in tree["params"].items()}
    steps_b = []
    for device in (dev, torch.device("cpu")):
        net = AZNet(net_card.config, torch.float32)
        net.load_state_dict(sd)
        ts, m = train_step(make_train_state(net.to(device), learning_rate=LR_B), [t.to(device) for t in batch])
        steps_b.append((list(ts.net.parameters()), float(m["loss"])))
    (p_card, loss_card), (p_cpu, loss_cpu) = steps_b
    pairs = [(p.detach().cpu(), q.detach()) for p, q in zip(p_card, p_cpu)]
    names = [name for name, _ in net.named_parameters()]
    grad_errs = {name: float((p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max().clamp_min(1e-30))
                 for name, p, q in zip(names, p_card, p_cpu)}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    param_err = max(float((p - q).abs().max()) for p, q in pairs)
    over = sum(int(((p - q).abs() > 2e-5).sum()) for p, q in pairs)
    entries = sum(q.numel() for _, q in pairs)
    print(f"[16 card vs CPU] one AdamW step (lr {LR_B}), {ROWS_B} rows, float32 (TF32 off): loss {loss_card:.7f} "
          f"card, {loss_cpu:.7f} CPU; gradients max |diff| / max |g| per tensor {grad_err:.3g} ({worst}); "
          f"parameters max "
          f"|diff| {param_err:.3g}, {over} of {entries} entries over 2e-05", flush=True)
    if abs(loss_card - loss_cpu) > LOSS_ATOL or grad_err > GRAD_RTOL or param_err > 2 * LR_B:
        fail(f"learner step: card and CPU differ by {abs(loss_card - loss_cpu):.3g} (loss; atol {LOSS_ATOL}), "
             f"{grad_err:.3g} (gradients; relative {GRAD_RTOL}), {param_err:.3g} (parameters; atol {2 * LR_B})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # 16c. a checkpoint after the first iteration, the second run again from it
    ENVS_C, STEPS_C, CAP_C = 64, 4, 4096
    base = workdir / "small830.npz"
    ckpt.save_npz(base, tree_from_params(NET_19, N19, ENVS_C, CH, BL, 830, lr=2e-4, replay_capacity=CAP_C,
                                         seed=SEED, device=dev))
    cut = workdir / "small831.npz"

    def second_iteration(trainer):
        """Run iteration 831; returns its self-play window."""
        windows = []
        selfplay = trainer.selfplay

        def recorded():
            windows.append(selfplay())
            return windows[-1]

        trainer.selfplay = recorded
        trainer.run_iteration(831)
        return windows[0]

    quiet = lambda *a, **k: None
    whole = Trainer(recipe(ENVS_C, STEPS_C, CAP_C, "--iters", "832", "--resume", str(base)), device=dev, log=quiet)
    whole.run_iteration(830)
    ckpt.save_npz(cut, whole.tree())
    win_a = second_iteration(whole)
    again = Trainer(recipe(ENVS_C, STEPS_C, CAP_C, "--iters", "832", "--resume", str(cut)), device=dev, log=quiet)
    win_b = second_iteration(again)
    exact = {"env states": torch.equal(whole.states, again.states),
             "replay": all(torch.equal(x, y) for x, y in zip(whole.buf_state, again.buf_state)),
             "generator": torch.equal(whole.generator.get_state(), again.generator.get_state())}
    for name in ("actions", "obs", "policy_target", "value_target", "mask", "grounded"):
        exact[name] = torch.equal(getattr(win_a, name), getattr(win_b, name))
    param_diff = max(float((p - q).detach().abs().max()) for p, q in zip(whole.net.parameters(), again.net.parameters()))
    RESUME_ATOL = 1e-6  # cuDNN may pick backward algorithms that add in another order
    print(f"[16 resume] {N19}x{N19} {CH}x{BL}, B={ENVS_C}, {STEPS_C} moves: the second iteration again from the checkpoint "
          f"of the first: bit for bit {json.dumps(exact)}; parameters after its learner step max |diff| "
          f"{param_diff:.3g} ({'bit for bit' if param_diff == 0 else f'within atol {RESUME_ATOL}'})", flush=True)
    if not all(exact.values()) or param_diff > RESUME_ATOL:
        fail(f"resume: {exact}, parameters {param_diff}")
    return train_launches, train_minmax


def replay_overflow(dev, n, rows, capacity):
    """One add of ``rows`` > ``capacity`` rows into an empty replay on the
    card (the recipe's 512 envs x 160 moves into 65,536): every slot must hold
    one whole row, its obs, policy, value and masks all of one row id, and
    the rows must be the last ``capacity``, each at the slot it reached."""
    from gymgo_tpu_torch.rl.replay import ReplayBuffer

    ids = torch.arange(rows, device=dev)
    obs = torch.zeros((rows, 6 * n * n), dtype=torch.int8, device=dev)
    obs[:, :17] = ((ids[:, None] >> torch.arange(17, device=dev)) & 1).to(torch.int8)
    policy = torch.zeros((rows, n * n + 1), device=dev)
    policy[:, 0] = ids.to(torch.float32)
    buf = ReplayBuffer(capacity, n, device=dev)
    st = buf.add(buf.init(), obs.view(rows, 6, n, n), policy, ids.to(torch.float32), ids % 2 == 0, ids % 3 == 0)
    row = st.value.to(torch.int64)
    from_obs = (st.obs.view(capacity, -1)[:, :17].to(torch.int64) << torch.arange(17, device=dev)).sum(1)
    whole = (torch.equal(st.policy[:, 0].to(torch.int64), row) and torch.equal(from_obs, row)
             and torch.equal(st.mask, row % 2 == 0) and torch.equal(st.vmask, row % 3 == 0))
    last = torch.equal(row[torch.arange(rows - capacity, rows, device=dev) % capacity],
                       torch.arange(rows - capacity, rows, device=dev))
    if not (whole and last and int(st.cursor) == rows % capacity and int(st.filled) == capacity):
        fail(f"replay overflow: whole rows {whole}, the last {capacity} rows in place {last}, "
             f"cursor {int(st.cursor)}, filled {int(st.filled)}")
    print(f"[15 replay overflow] {rows} rows into a {capacity}-row replay on the card: every slot holds one "
          f"whole row (obs, policy, value, masks), the last {capacity} rows each at the slot it reached", flush=True)


def spread(ms):
    return f"median {statistics.median(ms):.3f} min {min(ms):.3f} max {max(ms):.3f} ms"


def gogame_path(dev, states, bundle_lib, minmax_lib):
    """Phase 17: the numpy ``gogame`` on the card against the CPU, from a
    19x19 game and phase 4's steady-state ``states``.  Returns the game's
    launch counts ``(of the bundle kernel, of the min/max kernel)``."""
    from gymgo_tpu_torch import gogame

    MOVES = 200
    t_phase = time.perf_counter()
    np.random.seed(SEED)
    state = gogame.init_state(19)
    card_ms, cpu_ms = [], []
    torch.cuda.synchronize()
    bundle_lib.launches = minmax_lib.launches = 0
    for t in range(MOVES):
        a = gogame.random_action(state)
        t0 = time.perf_counter()
        card = gogame.next_state(state, a, device=dev)
        card_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        cpu = gogame.next_state(state, a, device="cpu")
        cpu_ms.append(1e3 * (time.perf_counter() - t0))
        if not (card.dtype == cpu.dtype == np.float64 and np.array_equal(card, cpu)):
            fail(f"gogame.next_state: the card and the CPU differ at move {t} (action {a})")
        state = card
        if gogame.game_ended(state):
            fail(f"the 19x19 game ended at move {t}")
    launches, minmax = bundle_lib.launches, minmax_lib.launches
    if not launches > 0 or minmax != 0:
        fail(f"gogame: {launches} bundle launches, {minmax} min/max launches in {MOVES} moves")
    for canonical in (False, True):
        kids = gogame.children(state, canonical, device=dev)
        if kids.shape != (362, 6, 19, 19) or not np.array_equal(kids, gogame.children(state, canonical, device="cpu")):
            fail(f"gogame.children (canonical={canonical}): the card and the CPU differ")
    boards = states[:1024].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(SEED)
    actions = np.array([rng.choice(np.flatnonzero(v)) for v in gogame.batch_valid_moves(boards)])
    batch = gogame.batch_next_states(boards, actions, device=dev)
    if not np.array_equal(batch, gogame.batch_next_states(boards, actions, device="cpu")):
        fail("gogame.batch_next_states: the card and the CPU differ on phase 4's boards")
    for got, want in zip(gogame.batch_areas(batch, device=dev), gogame.batch_areas(batch, device="cpu")):
        if not np.array_equal(got, want):
            fail("gogame.batch_areas: the card and the CPU differ")
    print(f"[17 gogame] 19x19, {MOVES} moves of gogame.random_action (np.random.seed({SEED})): next_state on the "
          f"card == CPU in float64 at every move; children (362 rows, plain and canonical) and batch_next_states "
          f"+ batch_areas on 1024 of phase 4's boards == CPU; next_state {spread(card_ms)} on the card, "
          f"{spread(cpu_ms)} on the CPU; bundle launches in the game {launches} ({launches / MOVES:.1f} per move), "
          f"min/max {minmax}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, minmax


def go_env_path(dev, bundle_lib, minmax_lib):
    """Phase 18: ``GoEnv`` with the torch backend on the card against the
    native engine and the torch backend on the CPU, fed the same actions.
    Returns the games' launch counts ``(of the bundle kernel, of the min/max
    kernel)``."""
    from gymgo_tpu_torch.env import GoEnv

    t_phase = time.perf_counter()
    if GoEnv(19).backend != "native":
        fail("GoEnv's auto backend did not pick the native engine")

    def play(size, games, cap, must_end):
        envs = [GoEnv(size, reward_method="heuristic", backend="torch", device=dev),
                GoEnv(size, reward_method="heuristic", backend="native"),
                GoEnv(size, reward_method="heuristic", backend="torch", device="cpu")]
        if [e.backend for e in envs] != ["torch", "native", "torch"] or envs[0].device.type != "cuda":
            fail(f"GoEnv backends: {[(e.backend, e.device) for e in envs]}")
        ms = ([], [], [])
        moves = ended = 0
        for _ in range(games):
            for e in envs:
                e.reset()
            for t in range(cap):
                a = envs[0].uniform_random_action()
                out = []
                for e, times in zip(envs, ms):
                    t0 = time.perf_counter()
                    out.append(e.step(a))
                    times.append(1e3 * (time.perf_counter() - t0))
                (obs, reward, done, info), *others = out
                for o, r, d, i in others:
                    if not (np.array_equal(o, obs) and type(r) is type(reward) and r == reward and d == done
                            and i["turn"] == info["turn"] and i["prev_player_passed"] == info["prev_player_passed"]
                            and np.array_equal(i["invalid_moves"], info["invalid_moves"])):
                        fail(f"GoEnv {size}x{size}: the backends differ at move {t} (action {a})")
                moves += 1
                if done:
                    ended += 1
                    break
        if must_end and ended != games:
            fail(f"GoEnv {size}x{size}: {games - ended} of {games} games did not end in {cap} moves")
        return ms, moves, ended

    np.random.seed(SEED)
    torch.cuda.synchronize()
    bundle_lib.launches = minmax_lib.launches = 0
    ms19, moves19, ended19 = play(19, 2, 400, False)
    ms9, moves9, ended9 = play(9, 8, 2000, True)
    launches, minmax = bundle_lib.launches, minmax_lib.launches
    if launches < 2 * (moves19 + moves9) or minmax != 0:
        fail(f"GoEnv: {launches} bundle launches, {minmax} min/max launches in {moves19 + moves9} moves")
    for size, (card, native, cpu), moves, ended in ((19, ms19, moves19, ended19), (9, ms9, moves9, ended9)):
        print(f"[18 GoEnv] {size}x{size} heuristic: {moves} moves ({ended} games ended), torch on the card == "
              f"native == torch on the CPU at every step (observation, reward, done, info); ms per step: torch "
              f"on the card {spread(card)}, native {spread(native)}, torch on the CPU {spread(cpu)}", flush=True)
    print(f"[18 GoEnv] backend='auto' picks native; bundle launches {launches} "
          f"({launches / (moves19 + moves9):.2f} per move on the card), min/max {minmax}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, minmax


def benches():
    """Phase 19: ``bench_torch.py`` at three batch sizes and the search
    bench's Gumbel sweep, as subprocesses; returns the rollout benches' JSON
    records."""
    t_phase = time.perf_counter()
    records = []
    for batch in (4096, 12288, 49152):
        out = subprocess.run([sys.executable, "bench_torch.py", "--batch", str(batch)], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"bench_torch.py --batch {batch} failed:\n{out.stderr[-2000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        if rec["batch"] != batch or not rec["value"] > 0 or rec["kernel_launches"] != 5 * 65:
            fail(f"bench_torch.py --batch {batch}: {rec}")
        records.append(rec)
        print(f"[19 bench_torch] {json.dumps(rec)}", flush=True)
    cmd = [sys.executable, "-m", "gymgo_tpu_torch.benchmarks.mcts_bench", "--search", "gumbel", "--channels", "128",
           "--blocks", "6", "--batch-sweep", "128,256,512", "--repeats", "3"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    rows = [ln for ln in out.stdout.splitlines() if ln.startswith("| ") and ln[2].isdigit()]
    if out.returncode != 0 or [int(r.split("|")[1]) for r in rows] != [128, 256, 512]:
        fail(f"mcts_bench sweep failed:\n{out.stdout[-2000:]}{out.stderr[-2000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"[19 mcts_bench] {line}", flush=True)
    print(f"[19 benches] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


def gtp_path(dev, bundle_lib, minmax_lib):
    """Phase 20: GTP ``genmove`` on the card at full width, with the committed
    19x19 128x6 net.  Returns the phase's launch counts ``(of the bundle
    kernel, of the min/max kernel)``, set to 0 before (a) and read after
    (d)."""
    from gymgo_tpu_torch import gogame
    from gymgo_tpu_torch.convert import aznet_config_from_flax, load_aznet_npz, read_flax_npz
    from gymgo_tpu_torch.core import actions as tactions
    from gymgo_tpu_torch.core import transform as ttransform
    from gymgo_tpu_torch.native import NativeGoEngine
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts
    from gymgo_tpu_torch.utils.gtp import GTPEngine, _action_to_vertex, _vertex_to_action, make_net_genmove

    N19, CH, BL, KOMI, SIMS = 19, 128, 6, 7.5, 32
    t_phase = time.perf_counter()
    referee = NativeGoEngine(N19)

    def random_reply(eng, rng):
        """A uniformly random legal board move for the side to move (no pass
        while a board move exists), as a ``play`` line."""
        moves = np.flatnonzero(eng.state[3].reshape(-1) == 0)
        a = int(rng.choice(moves)) if moves.size else N19 * N19
        return f"play {'w' if eng.state[2, 0, 0] else 'b'} {_action_to_vertex(a, N19)}"

    def session(eng, genmoves, rng, tag, check_tree=None):
        """``genmoves`` genmoves for black, each answered by ``random_reply``
        for white; every response must start with '=', every move must be
        legal for the native engine.  Returns (ms per genmove, launches per
        genmove)."""
        state = np.zeros((6, N19, N19), np.int8)
        ms, per_move = [], []
        for i in range(genmoves):
            before = bundle_lib.launches
            t0 = time.perf_counter()
            resp, err, _ = eng.handle("genmove b")
            ms.append(1e3 * (time.perf_counter() - t0))
            per_move.append(bundle_lib.launches - before)
            if err or not resp.startswith("= "):
                fail(f"20{tag}: genmove {i} answered {resp!r}")
            state, status = referee.next_state(state, _vertex_to_action(resp[2:].strip(), N19))
            if status != 0:
                fail(f"20{tag}: genmove {i} played {resp[2:].strip()}, illegal for the native engine")
            line = random_reply(eng, rng)
            resp, err, _ = eng.handle(line)
            if err or not resp.startswith("="):
                fail(f"20{tag}: {line} answered {resp!r}")
            state, status = referee.next_state(state, _vertex_to_action(line.split()[-1], N19))
            if status != 0 or not np.array_equal(state, eng.state):
                fail(f"20{tag}: the engine and the native referee disagree after move {i}")
            if check_tree is not None:
                check_tree()
        return ms, per_move

    torch.cuda.synchronize()
    bundle_lib.launches = minmax_lib.launches = 0

    # (a) Gumbel search, 32 simulations, 24 genmoves
    GENMOVES = 24
    mover = make_net_genmove(str(NET_19), N19, CH, BL, simulations=SIMS, komi=KOMI, seed=SEED, search="gumbel",
                             device=dev)
    if next(mover._net.parameters()).dtype != torch.bfloat16:
        fail("20a: the GTP net is not bfloat16 on the card")
    eng = GTPEngine(N19, KOMI, mover, seed=SEED, match_pass_rule=True, backend="native")
    ms_a, per_a = session(eng, GENMOVES, np.random.default_rng(SEED), "a")
    expected = 2 * SIMS  # one stateless step_states per simulation: the board classified before the move, then the flood
    if any(k != expected for k in per_a):
        fail(f"20a: bundle launches per genmove {per_a}, expected {expected}")
    score = eng.handle("final_score")[0][2:].strip()
    black, white = gogame.areas(eng.state.astype(np.float64), device=dev)
    diff = black - white - KOMI
    want = f"B+{diff:g}" if diff > 0 else f"W+{-diff:g}" if diff < 0 else "0"
    if score != want:
        fail(f"20a: final_score {score} but gogame.areas on the card gives {want}")
    print(f"[20a GTP gumbel] 19x19 128x6 bfloat16, {SIMS} simulations, {GENMOVES} genmoves against seeded random "
          f"replies, komi {KOMI}, pass rule on: all '=' and legal; ms per genmove {spread(ms_a)} (the first "
          f"{ms_a[0]:.1f}); bundle launches per genmove {per_a[0]} (= 2 x {SIMS}, "
          f"every genmove); final_score {score} == gogame.areas(device='cuda')", flush=True)
    with host_syncs() as caught:
        mover(eng.state)
    prof_wall_us, rows = device_profile(lambda: mover(eng.state))
    busy_us = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:48]} {us / 1e3:.2f} ms x{c}" for us, c, k in rows[:5])
    print(f"[20a GTP gumbel] one more search of the final position: {len(caught)} host syncs; under the profiler "
          f"{prof_wall_us / 1e3:.1f} ms wall, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / prof_wall_us:.1f}%) in {sum(r[1] for r in rows)} launches; top: {top}", flush=True)

    # (b) PUCT with subtree reuse, 32 simulations, 10 genmoves
    PUCT_MOVES = 10
    puct = make_net_genmove(str(NET_19), N19, CH, BL, simulations=SIMS, komi=KOMI, seed=SEED, search="puct",
                            device=dev)
    eng = GTPEngine(N19, KOMI, puct, seed=SEED, match_pass_rule=True, backend="native")

    def tree_carried():
        if puct._tree is None:
            fail("20b: the carried tree did not survive play")

    ms_b, per_b = session(eng, PUCT_MOVES, np.random.default_rng(SEED + 1), "b", tree_carried)
    if any(k != expected for k in per_b):
        fail(f"20b: bundle launches per genmove {per_b}, expected {expected}")
    eng.handle("undo")
    if puct._tree is not None:
        fail("20b: undo did not clear the carried tree")
    if not eng.handle("genmove w")[0].startswith("= ") or puct._tree is None:
        fail("20b: genmove after undo")
    eng.handle("clear_board")
    if puct._tree is not None:
        fail("20b: clear_board did not clear the carried tree")
    print(f"[20b GTP puct] 19x19 128x6 bfloat16, {SIMS} simulations, subtree reuse, {PUCT_MOVES} genmoves: all "
          f"legal, the tree carried through every play, undo and clear_board drop it; ms per genmove "
          f"{spread(ms_b)}; bundle launches per genmove {per_b[0]} (= 2 x {SIMS}, every genmove)", flush=True)

    # (c) the greedy mover in float32 on the card against the CPU, 40 plies
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = make_net_genmove(str(NET_19), N19, CH, BL, device=dev, dtype=torch.float32)
    cpu = make_net_genmove(str(NET_19), N19, CH, BL, device="cpu", dtype=torch.float32)
    cpu_net = load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)
    state, near_ties, differ, plies = np.zeros((6, N19, N19), np.int8), [], [], 40
    for ply in range(plies):
        a_card, a_cpu = card(state), cpu(state)
        if a_card != a_cpu:
            st = torch.from_numpy(state[None])
            with torch.no_grad():
                logits = cpu_net(ttransform.batch_canonical_form(st))[0]
            masked = torch.where(tactions.batch_valid_moves(st) > 0, logits, -torch.inf)[0]
            top2 = masked.topk(2).values
            gap = float(top2[0] - top2[1])
            differ.append((ply, a_card, a_cpu, gap))
            if gap > 1e-4:
                fail(f"20c: ply {ply}: the card plays {a_card}, the CPU {a_cpu}, top-two gap {gap:.3g} > 1e-4")
        state, status = referee.next_state(state, a_cpu)
        if status != 0:
            fail(f"20c: the greedy move {a_cpu} at ply {ply} is illegal")
        if state[5, 0, 0]:
            plies = ply + 1
            break
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[20c GTP greedy] float32, TF32 off: {plies} plies, the card's move == the CPU's at every ply but "
          f"{len(differ)} near-tie(s) {differ} (top-two CPU logits within 1e-4 allowed)", flush=True)

    # (d) the engine itself on the card against native, a seeded random session
    session_d = (["fixed_handicap 4", "showboard"] + [f"genmove {'w' if i % 2 == 0 else 'b'}" for i in range(120)]
                 + ["showboard", "final_score", "undo", "genmove w", "play b pass", "final_score", "showboard"])
    engines = (GTPEngine(N19, KOMI, seed=SEED, match_pass_rule=True, backend="torch", device=dev),
               GTPEngine(N19, KOMI, seed=SEED, match_pass_rule=True, backend="native"))
    if engines[0].backend != "torch" or engines[0].device.type != "cuda" or engines[1].backend != "native":
        fail("20d: the engines' backends")
    before = bundle_lib.launches
    ms_d = ([], [])
    transcripts = ([], [])
    for line in session_d:
        for eng, times, out in zip(engines, ms_d, transcripts):
            t0 = time.perf_counter()
            out.append(eng.handle(line)[0])
            times.append(1e3 * (time.perf_counter() - t0))
    text = ["".join(t) for t in transcripts]
    if text[0] != text[1]:
        first = next(i for i, (x, y) in enumerate(zip(*transcripts)) if x != y)
        fail(f"20d: the card's transcript differs from native at {session_d[first]!r}: {transcripts[0][first]!r} "
             f"vs {transcripts[1][first]!r}")
    card_launches = bundle_lib.launches - before
    print(f"[20d GTP engine] 19x19 seeded random session of {len(session_d)} commands (4 handicap stones, 121 "
          f"genmoves, pass rule on): backend='torch' on the card == native, {len(text[0])} characters; ms per "
          f"command {spread(ms_d[0])} on the card, {spread(ms_d[1])} native; bundle launches {card_launches}", flush=True)

    # (e) 21b's Gumbel mover (the 9x9 net, komi 0) on the card against the CPU, given the same root draws, at
    # every other ply of a seeded random game: float32 (TF32 off) equal but at most one position, as in
    # phase 13's replay; bfloat16 on the card, as GTP runs it, counted against the CPU
    N9, POS9 = 9, 8
    cfg9 = aznet_config_from_flax(read_flax_npz(NET_9))
    draws = {}
    movers = {name: make_net_genmove(str(NET_9), N9, cfg9.channels, cfg9.blocks, simulations=SIMS, komi=0.0,
                                     seed=SEED, device=d, dtype=dt, gumbel_source=lambda d=d: draws["g"].to(d))
              for name, d, dt in (("cpu", "cpu", torch.float32), ("card32", dev, torch.float32),
                                  ("card16", dev, torch.bfloat16))}
    cpu_net9 = load_aznet_npz(NET_9, device="cpu", dtype=torch.float32)
    referee9, rng = NativeGoEngine(N9), np.random.default_rng(SEED + 20)
    state, differ, bf16_equal = np.zeros((6, N9, N9), np.int8), [], 0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for pos in range(POS9):
        draws["g"] = torch.from_numpy(rng.gumbel(size=(1, N9 * N9 + 1)).astype(np.float32))
        moves = {name: mover(state) for name, mover in movers.items()}
        bf16_equal += moves["card16"] == moves["cpu"]
        if moves["card32"] != moves["cpu"]:
            res = run_gumbel_mcts(None, torch.from_numpy(state[None]), cpu_net9, num_simulations=SIMS, komi=0.0,
                                  gumbel=draws["g"])
            cand = res.sampled_actions[0].long()
            visited = cand[res.root_visits[0, cand] > 0]
            top2 = (draws["g"][0, visited] + res.improved_policy[0, visited].log()).topk(2).values
            differ.append((2 * pos, moves["card32"], moves["cpu"], float(top2[0] - top2[1])))
        for _ in range(2):
            legal = np.flatnonzero(state[3].reshape(-1) == 0)
            state, status = referee9.next_state(state, int(rng.choice(legal)) if legal.size else N9 * N9)
            if status != 0:
                fail(f"20e: a random move at position {pos} is illegal")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if len(differ) > 1:
        fail(f"20e: the card's float32 Gumbel mover differs from the CPU's at {differ} (ply, card, CPU, final gap)")
    print(f"[20e GTP gumbel 9x9] {NET_9.name}, {SIMS} simulations, komi 0, the same root draws, {POS9} positions "
          f"of a random game: float32 (TF32 off) on the card == the CPU but {differ} (ply, card, CPU, the CPU's "
          f"final score gap); bfloat16 on the card == the CPU's float32 move at {bf16_equal} of {POS9}", flush=True)
    launches, minmax = bundle_lib.launches, minmax_lib.launches
    if minmax != 0:
        fail(f"phase 20 launched the min/max kernel {minmax} times")
    print(f"[20 GTP] bundle launches in phase 20 {launches}, min/max {minmax}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, minmax


def tools(workdir):
    """Phase 21: the tools as subprocesses, on the card: ``efficiency`` (torch
    on the card, then native), then ``eval_ckpt`` through an injected crash,
    ``gtp_match`` and ``value_probe`` side by side (each is host-bound and
    single-threaded)."""
    from gymgo_tpu_torch.convert import aznet_config_from_flax, read_flax_npz
    from gymgo_tpu_torch.utils import faulttol

    t_phase = time.perf_counter()
    cfg9 = aznet_config_from_flax(read_flax_npz(NET_9))
    width = ["--channels", str(cfg9.channels), "--blocks", str(cfg9.blocks)]
    net9 = str(NET_9.relative_to(ROOT))  # the subprocesses run from the root

    def run(args, env=None):
        head = [sys.executable] if args[0].endswith(".py") else [sys.executable, "-m"]
        return subprocess.Popen([*head, *args], cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    def wait(proc, name, timeout):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"21 {name}: timed out after {timeout} s")
        if proc.returncode != 0:
            fail(f"21 {name} failed (rc {proc.returncode}):\n{out[-2000:]}{err[-2000:]}")
        return out

    # (d) efficiency: the reference protocol at 9x9
    for engine, iters in (("torch", 2), ("native", 2)):  # the protocol's 64 cut to the run's time limit
        t0 = time.perf_counter()
        out = wait(run(["gymgo_tpu_torch.benchmarks.efficiency", "--engine", engine, "--iterations", str(iters)]),
                   f"efficiency --engine {engine}", 300)
        lines = out.strip().splitlines()
        if not (lines[0].startswith(f"engine={engine} backend={engine}") and len(lines) == 4
                and lines[-1].startswith("Rand Trajs w/ Children:")):
            fail(f"21d efficiency --engine {engine}: {out[-1000:]}")
        where = "on the card" if engine == "torch" else "native"
        print(f"[21d efficiency] --engine {engine} ({where}), 9x9, --iterations {iters}: "
              f"{' | '.join(lines[1:])}; {time.perf_counter() - t0:.1f} s", flush=True)

    # (a) eval_ckpt through an injected crash, (b) gtp_match, (c) value_probe, side by side
    GAMES, CHUNK, MAX_STEPS, GTP_GAMES = 32, 16, 120, 4
    ledger, marker = workdir / "eval.jsonl", workdir / "crash.marker"
    env = dict(os.environ, GYMGO_EVAL_CRASH_AT_CHUNK="1", GYMGO_EVAL_CRASH_MARKER=str(marker))
    t0 = time.perf_counter()
    procs = {
        "eval_ckpt": run(["gymgo_tpu_torch.scripts.eval_ckpt", "--ckpt", net9, "--board", "9", *width,
                          "--sims", "32", "--gumbel-m", "16", "--games", str(GAMES), "--chunk", str(CHUNK),
                          "--max-steps", str(MAX_STEPS), "--retries", "1", "--state-file", str(ledger)], env=env),
        # gtp_match's CLI with the match pass rule's replacements counted
        "gtp_match": run(["tests/torch_pass_rule.py", "port", "--boardsize", "9", "--games", str(GTP_GAMES), *width,
                          "--a", f"net:{net9}:32", "--b", "random"]),
        "value_probe": run(["gymgo_tpu_torch.scripts.value_probe", "--ckpt", net9, "--board", "9", *width]),
    }
    outs = {name: wait(proc, name, 600) for name, proc in procs.items()}
    wall = time.perf_counter() - t0

    out = outs["eval_ckpt"]
    if not marker.exists() or "child died (rc=137)" not in out:
        fail(f"21a eval_ckpt: the injected crash did not happen:\n{out[-1500:]}")
    recs = list(faulttol.load_ledger(str(ledger)).values())
    tally = {k: sum(r[k] for r in recs) for k in ("wins", "losses", "ties", "unfinished", "scored_wins",
                                                  "scored_losses")}
    line = out.strip().splitlines()[-1]
    m = re.search(r"vs uniform-random: (\d+)W/(\d+)L/(\d+)T, (\d+) unfinished, winrate=([0-9.]+)", line)
    if (len(recs) != 2 or m is None or [int(x) for x in m.groups()[:4]]
            != [tally[k] for k in ("wins", "losses", "ties", "unfinished")]
            or tally["wins"] + tally["losses"] + tally["ties"] + tally["unfinished"] != GAMES):
        fail(f"21a eval_ckpt: the report does not add up: {line!r}, ledger {tally}")
    score = tally["scored_wins"] / GAMES
    if not score >= 0.85:
        fail(f"21a eval_ckpt: the net scored {score:.3f} against random")
    print(f"[21a eval_ckpt] 9x9 {NET_9.name} (channels {cfg9.channels}, blocks {cfg9.blocks}), search 32/16 with "
          f"pass-to-win vs uniform random, {GAMES} games in {GAMES // CHUNK} chunks, --max-steps {MAX_STEPS}, "
          f"--retries 1, a worker killed at chunk 1 and relaunched: {line!r}; area-adjudicated score {score:.3f} "
          f"(>= 0.85)", flush=True)

    out = outs["gtp_match"]
    last = out.strip().splitlines()[-1]
    games = [l for l in out.splitlines() if l.startswith("game ")]
    counts = [l.strip() for l in out.splitlines() if l.startswith("  pass rule: ")]
    if re.match(r"A: (\d+)W (\d+)L (\d+)T", last) is None or len(games) != GTP_GAMES or len(counts) != GTP_GAMES:
        fail(f"21b gtp_match: {out[-1000:]}")
    print(f"[21b gtp_match] 9x9 net:{NET_9.name}:32 vs random, komi 0, {GTP_GAMES} games over GTP: "
          f"{' | '.join(g + ' (' + c + ')' for g, c in zip(games, counts))} | {last}", flush=True)

    out = outs["value_probe"]
    if "VERDICT:" not in out or "COLLAPSED" in out:
        fail(f"21c value_probe: {out[-1000:]}")
    print(f"[21c value_probe] 9x9 {NET_9.name}, 256 random games to their ends: "
          f"{' | '.join(out.strip().splitlines()[-2:])}", flush=True)
    print(f"[21 tools] (a)-(c) side by side {wall:.1f} s; phase {time.perf_counter() - t_phase:.1f} s", flush=True)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1

    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core import flood as tflood
    from gymgo_tpu_torch.core.flood import bundle_flood_plain, minmax_flood_plain
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.ops import bundle_flood as bf
    from gymgo_tpu_torch.ops import minmax_flood as mf

    tflood.set_flood_route("bitpack")  # phases 3-7 run the default route

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[1 device] torch: {kind} (count {count}); nvidia-smi: {smi}", flush=True)

    # 2. build: one nvcc per source, started together
    libs = (bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.function(), libs))
    build_s = time.perf_counter() - t0
    for lib in libs:
        ptxas = " | ".join(l.split(":", 1)[-1].strip() for l in lib.build_log.splitlines()
                           if "spill" in l or ("ptxas info" in l and "Used" in l))
        if re.search(r"[1-9][0-9]* bytes spill", ptxas):
            fail(f"{lib.source.name} spills registers: {ptxas}")
        print(f"[2 build] {lib.source.name} built and loaded in {lib.build_seconds:.2f} s "
              f"(both: {build_s:.2f} s); {ptxas}", flush=True)

    # 3. kernel against its plain version, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = board_cases(dev, gen, (5, 9, 19, 22), (19, 22))
    cfg_small = EnvConfig(board_size=19, batch_size=1531, reward_method=HEURISTIC, auto_reset=True)
    r = rollout(gen, batch_init_state(1531, 19, device=dev), 300, cfg_small)
    cases.append(("steady 19x19 B=1531", *boards_of(r.final_states)))
    max_err = 0
    for name, a, b in cases:
        k = bf.bundle_flood_cuda(a, b)
        p = bundle_flood_plain(a, b)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(k, p):
            fail(f"kernel != plain on {name}: {int((k != p).sum())} cells differ")
    print(f"[3 kernel vs plain] {len(cases)} cases bit-exact (max |diff| {max_err})", flush=True)

    # 4. the main path
    B, N, WARMUP, WINDOW, REPEATS = 12288, 19, 768, 64, 5
    cfg = EnvConfig(board_size=N, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = batch_init_state(B, N, device=dev)
    torch.cuda.synchronize()
    bf.BUNDLE_FLOOD.launches = mf.MINMAX_FLOOD.launches = 0
    t0 = time.perf_counter()
    r = rollout(gen, states, WARMUP, cfg)
    states = r.final_states
    n_invalid = r.invalid.sum()
    n_games = r.dones.sum()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rates, runs, _ = timed_windows(rollout, gen, states, cfg, WINDOW, REPEATS)
    launches, minmax_on_default = bf.BUNDLE_FLOOD.launches, mf.MINMAX_FLOOD.launches
    states = runs[-1].final_states
    n_invalid = n_invalid + sum(x.invalid.sum() for x in runs)
    n_games = n_games + sum(x.dones.sum() for x in runs)
    expected = (WARMUP + 1) + REPEATS * (WINDOW + 1)
    if launches != expected:
        fail(f"bundle flood launched {launches} times on the main path, expected {expected}")
    if minmax_on_default != 0:
        fail(f"minmax flood launched {minmax_on_default} times on the default route")
    if int(n_invalid) != 0:
        fail(f"{int(n_invalid)} steps flagged an invalid action on the main path")
    stones = states[:, :2].to(torch.int32).sum().item() / B
    print(f"[4 main path] 19x19 B={B}: warmup {WARMUP} steps {warm_s:.2f} s; "
          f"{rates_text(rates)}; games finished {int(n_games)}; "
          f"mean stones/board {stones:.1f}; kernel launches {launches}", flush=True)

    # 5. card against CPU replay
    cfg_r = EnvConfig(board_size=19, batch_size=256, reward_method=HEURISTIC, auto_reset=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    start = states[:256].clone()
    rc = rollout(g, start, 200, cfg_r)
    acts = iter(rc.actions.cpu())
    rh = rollout(torch.Generator().manual_seed(0), start.cpu(), 200,
                 cfg_r, policy_fn=lambda _g, _s: next(acts))
    for field in ("final_states", "rewards", "dones"):
        if not torch.equal(getattr(rc, field).cpu(), getattr(rh, field)):
            fail(f"card and CPU replay disagree on {field}")
    print(f"[5 replay] 19x19 B=256 200 steps: card == CPU on final states, rewards, dones "
          f"({int(rc.dones.sum())} games finished)", flush=True)

    # 6. kernel time against the plain version's, on the steady-state boards
    a, b = boards_of(states)
    launches_before = bf.BUNDLE_FLOOD.launches
    kernel_ms = time_ms(lambda: bf.bundle_flood_cuda(a, b), 200)
    plain_ms = time_ms(lambda: bundle_flood_plain(a, b), 5)
    kernel_ms_2 = time_ms(lambda: bf.bundle_flood_cuda(a, b), 200)
    bf.BUNDLE_FLOOD.launches = launches_before
    if not torch.equal(bf.bundle_flood_cuda(a, b), bundle_flood_plain(a, b)):
        fail("kernel != plain on the main path's steady-state boards")
    bound_ms = (2 + 4) * B * N * N / H100_BYTES_PER_S * 1e3
    print(f"[6 timing] bundle flood 19x19 B={B} steady state: kernel {kernel_ms:.4f} ms "
          f"(again {kernel_ms_2:.4f}), plain {plain_ms:.4f} ms, byte bound {bound_ms:.4f} ms "
          f"({(2 + 4) * B * N * N} bytes at 3.35 TB/s)", flush=True)

    # 7. profile of the main path
    PROF_STEPS = 16
    rollout(gen, states, 4, cfg)
    wall_us, rows = device_profile(lambda: rollout(gen, states, PROF_STEPS, cfg))
    busy_us = sum(r[0] for r in rows)
    if busy_us > 0:
        top = "; ".join(f"{k[:60]} {us / PROF_STEPS:.1f} us/step x{c // PROF_STEPS}" for us, c, k in rows[:8])
        print(f"[7 profile] 19x19 B={B}, {PROF_STEPS} steps: wall {wall_us / PROF_STEPS:.1f} us/step, "
              f"device busy {busy_us / PROF_STEPS:.1f} us/step ({100 * busy_us / wall_us:.1f}% busy), "
              f"{sum(r[1] for r in rows) / PROF_STEPS:.1f} kernel launches/step; top: {top}", flush=True)
    else:
        print(f"[7 profile] device time not visible to torch.profiler (not measured); "
              f"wall {wall_us / PROF_STEPS:.1f} us/step", flush=True)

    # 8. minmax kernel against its plain version, bit for bit on every cell
    gen8 = torch.Generator(device=dev).manual_seed(SEED + 8)
    cases = board_cases(dev, gen8, (5, 9, 19, 22, 32), (19, 22, 32))
    cases.append((f"steady 19x19 B={B}", a, b))
    mm_err = 0
    for name, ca, cb in cases:
        kmn, kmx = mf.minmax_flood_cuda(ca, cb)
        pmn, pmx = minmax_flood_plain(ca, cb)
        torch.cuda.synchronize()
        for k, p in ((kmn, pmn), (kmx, pmx)):
            mm_err = max(mm_err, int((k.to(torch.int32) - p.to(torch.int32)).abs().max()))
        if not (torch.equal(kmn, pmn) and torch.equal(kmx, pmx)):
            fail(f"minmax kernel != plain on {name}: "
                 f"{int(((kmn != pmn) | (kmx != pmx)).sum())} cells differ")
    print(f"[8 minmax kernel vs plain] {len(cases)} cases bit-exact on every cell "
          f"(max |diff| {mm_err})", flush=True)

    # 9. the minmax route, from phase 4's steady-state states
    tflood.set_flood_route("unrolled")
    gen9 = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf.BUNDLE_FLOOD.launches = mf.MINMAX_FLOOD.launches = 0
    rates9, runs9, starts9 = timed_windows(rollout, gen9, states, cfg, WINDOW, REPEATS)
    mm_launches, bundle_on_minmax = mf.MINMAX_FLOOD.launches, bf.BUNDLE_FLOOD.launches
    if mm_launches != REPEATS * (WINDOW + 1):
        fail(f"minmax flood launched {mm_launches} times on the minmax route, "
             f"expected {REPEATS * (WINDOW + 1)}")
    if bundle_on_minmax != 0:
        fail(f"bundle flood launched {bundle_on_minmax} times on the minmax route")
    if any(int(x.invalid.sum()) for x in runs9):
        fail("a step flagged an invalid action on the minmax route")
    print(f"[9 minmax route] 19x19 B={B}: {rates_text(rates9)}; games finished "
          f"{int(sum(x.dones.sum() for x in runs9))}; minmax kernel launches {mm_launches}, "
          f"bundle kernel launches {bundle_on_minmax}", flush=True)

    # 10. route equivalence: card minmax route -> card bundle route, and -> CPU
    tflood.set_flood_route("bitpack")
    acts = iter(runs9[0].actions)
    rb = rollout(gen9, starts9[0], WINDOW, cfg, policy_fn=lambda _g, _s: next(acts))
    for field in ("final_states", "rewards", "dones"):
        if not torch.equal(getattr(runs9[0], field), getattr(rb, field)):
            fail(f"minmax and bundle routes disagree on {field}")
    tflood.set_flood_route("unrolled")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    start = runs9[-1].final_states[:256].clone()
    rc = rollout(g, start, 200, cfg_r)
    acts = iter(rc.actions.cpu())
    rh = rollout(torch.Generator().manual_seed(0), start.cpu(), 200,
                 cfg_r, policy_fn=lambda _g, _s: next(acts))
    for field in ("final_states", "rewards", "dones"):
        if not torch.equal(getattr(rc, field).cpu(), getattr(rh, field)):
            fail(f"minmax route: card and CPU replay disagree on {field}")
    tflood.set_flood_route("bitpack")
    print(f"[10 route equivalence] 19x19 B={B} {WINDOW} steps: minmax route == bundle route "
          f"on final states, rewards, dones ({int(rb.dones.sum())} games finished); "
          f"19x19 B=256 200 steps: minmax route on the card == CPU plain path "
          f"({int(rc.dones.sum())} games finished)", flush=True)

    # 11. minmax kernel time against the plain version's, on phase 4's boards
    launches_before = mf.MINMAX_FLOOD.launches
    mm_ms = time_ms(lambda: mf.minmax_flood_cuda(a, b), 200)
    mm_plain_ms = time_ms(lambda: minmax_flood_plain(a, b), 5)
    mm_ms_2 = time_ms(lambda: mf.minmax_flood_cuda(a, b), 200)
    mf.MINMAX_FLOOD.launches = launches_before
    print(f"[11 timing] minmax flood 19x19 B={B} steady state: kernel {mm_ms:.4f} ms "
          f"(again {mm_ms_2:.4f}), plain {mm_plain_ms:.4f} ms, byte bound {bound_ms:.4f} ms "
          f"({(2 + 4) * B * N * N} bytes at 3.35 TB/s)", flush=True)

    play_launches, play_minmax_launches = play_path(dev, states, bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, train_minmax_launches = train_path(dev, states, bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD,
                                                           Path(workdir))

    gogame_launches, gogame_minmax = gogame_path(dev, states, bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)
    env_launches, env_minmax = go_env_path(dev, bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)
    bench_records = benches()
    gtp_launches, gtp_minmax = gtp_path(dev, bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)
    with tempfile.TemporaryDirectory() as workdir:
        tools(Path(workdir))

    print(json.dumps({"kernels": [{
        "name": "bundle_flood",
        "route": "cuda",
        "source": "gymgo_tpu_torch/csrc/bundle_flood.cu",
        "replaces": "gymgo_tpu/ops/pallas_flood.py:163",
        "launches": launches,
        "launches_play_path": play_launches,
        "launches_train_path": train_launches,
        "launches_gogame": gogame_launches,
        "launches_go_env": env_launches,
        "launches_bench_torch": {r["batch"]: r["kernel_launches"] for r in bench_records},
        "launches_gtp": gtp_launches,
        "max_abs_err": max_err,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "minmax_flood",
        "route": "cuda",
        "source": "gymgo_tpu_torch/csrc/minmax_flood.cu",
        "replaces": "gymgo_tpu/ops/pallas_flood.py:33",
        "launches": mm_launches,
        "launches_play_path": play_minmax_launches,
        "launches_train_path": train_minmax_launches,
        "launches_gogame": gogame_minmax,
        "launches_go_env": env_minmax,
        "launches_gtp": gtp_minmax,
        "max_abs_err": mm_err,
        "ms": min(mm_ms, mm_ms_2),
        "plain_ms": mm_plain_ms,
        # 2 bytes in (two uint8 planes), 4 out (two int16 planes) per cell
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
