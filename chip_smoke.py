"""Drive gymgo_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero.
Phases 3-7 run the default route (the bundle flood, ``GYMGO_FLOOD=bitpack``),
phases 8-11 the minmax route (``GYMGO_FLOOD=unrolled``):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: nvcc builds the three flood kernels (bundle, min/max, claim) and
     the served net's fused GroupNorm kernel from ``gymgo_tpu_torch/csrc``, in
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
     and claim kernels' must stay 0;
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
     timed windows of 64 steps (eager); the minmax kernel's launch count must
     grow by exactly one per step plus one per rollout call, the claim
     kernel's by one per step, the bundle kernel's not at all;
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
     B = 256 states of phase 4, the 128x6 net in bfloat16 (a CUDA graph: the
     warm-up call captures it, the measured calls replay it):
     legal actions, 32 visits per env, policies that sum to 1 and vanish on
     invalid moves, the same result from the same seed; searches/s, ms,
     kernel launches and host syncs per simulation, bundle launches; then
     B = 32, 16 simulations, float32, injected noise, replayed on the CPU
     plain path;
 14. a match (each ply a replayed graph): ``play_match`` on 9x9, the committed ``az9_r5_iter100`` net with
     the full search wrapped in ``with_pass_to_win`` against the uniform
     sampler, 128 games to the move cap of 243, which it must win at 0.85 or
     better by area; then 8 plies of the same at 19x19 with the 128x6 net,
     B = 128, 4 opening moves;
 15. training at full width (each self-play move a replayed graph):
     ``params_to_ckpt``'s tree of the committed 19x19
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
 19. the benches: ``bench_torch.py`` at ``--batch`` 4096 and 49152 (its
     12288 is phase 4's rollout, dropped to keep the run in its time limit),
     and ``python -m gymgo_tpu_torch.benchmarks.mcts_bench --search gumbel
     --channels 128 --blocks 6 --batch-sweep 128,256,512 --repeats 3``, as
     subprocesses, their JSON line and table parsed;
 20. GTP on the card at full width, the committed 19x19 128x6 net, komi 7.5,
     the match pass rule on (the movers replay graphs): (a) ``make_net_genmove(..., simulations=32,
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
     and ``value_probe`` (not collapsed);
 22. the parallel layer on the card: (a) ``ShardedGoEnv`` at 19x19,
     B = 12288, heuristic, auto-reset, on k = 1, 2 and 4 logical shards of
     the card (``make_mesh(devices=[cuda] * k)``), a 64-step rollout from
     phase 4's boards equal bit for bit to the unsharded ``rollout`` from the
     same seed (final states, actions, rewards, dones), the bundle kernel
     launched exactly k x (64 + 1) times: once per shard per step, and once
     per shard for the seeding of the carried atari/ko planes each call
     makes (its first call, run eagerly before the capture: ``ShardedGoEnv``
     replays a CUDA graph after); then, for the unsharded compiled rollout
     (``BatchGoEnv``) and each k, 3 timed windows of 64 steps from the same
     boards, and for k = 4 a device profile of a replayed 64-step window
     (25 profiles the unsharded one); (b)
     ``scripts.multiproc_worker`` as 2 ranks of 2 logical shards on the one
     card (gloo) at 19x19, B = 4096, 64 steps: both ranks' checksums equal a
     one-process rollout's; then 2 segments with rank 1 killed after segment
     0 and the survivor ended, and a fresh 2-rank job restarted from the
     checkpoint: equal to an uninterrupted segmented run; (c) the
     data-parallel learner step (``tests/torch_dp_step.py``, 2 ranks of 512
     rows, gloo) with the 19x19 128x6 iter-830 net in float32 (TF32 off), the
     masks differing between the halves, against one process on the 1024 rows:
     after the first AdamW step (lr 2e-4) the loss within 2e-5, the
     gradients the ranks summed within phase 16b's 1e-2 of each tensor's
     largest entry of one process's, and the parameters within 16b's 2 lr;
     3 steps timed on each side; (d) ``scripts.scaling_proxy --mode procs``
     and ``scripts.multihost_bench`` with one process, at 19x19 B = 4096, as
     subprocesses, their JSON lines parsed (``--mode mesh`` measures what
     (a) does, and runs in the CPU tests only, to keep the run in its time
     limit);
 23. the soak: ``python -m gymgo_tpu_torch.scripts.fuzz_parity --device
     cuda`` at 9x9 and 19x19, 16 games each, up to 300 steps: every state of
     every game after every step equal between the batched step on the card
     and the native engine (at least 3000 states), and 2 bundle launches per
     step;
 24. the measurement layer: (a) the step's ``GYMGO_ABLATE`` switches, each
     alone, all six together, and ``sampler``, on phase 4's boards, between
     two runs of the whole step: 3 timed windows of 64 steps, a 16-step
     profile (device us/step, busy share, launches/step), the bundle
     kernel's launches (one a step plus each call's seeding, none a step
     under ``bundle``), and a 64-step B = 256 rollout replayed on the CPU
     under the same switch; ``GYMGO_BITPACK_FIXED_ONLY`` must raise on CUDA
     tensors without a launch; then the table of what each component costs
     the step; (b) ``run_gumbel_mcts`` with the 128x6 net in bfloat16 at
     B = 256, 32/16 under the ``GYMGO_GUMBEL_PACK`` layouts default,
     ``i16,logp`` and ``i16,logp,bf16`` (legal actions, 32 visits, policies
     summing to 1; card against CPU by phase 13's rule, counted only under
     ``bf16``), then ``benchmarks.mcts_bench --batch-sweep 512,1024`` at
     128x6 under each layout as subprocesses; (c) the three studies as
     subprocesses: ``measure_convergence`` with 32 measured steps (the kernel's
     word equal to the counted fixpoint on every env of every step) and its
     ``--warm-study`` (fixpoint equality every step), ``walk_depth_study``
     at 13x13 and at 19x19 128x6 (B = 64 and 512) side by side, then
     ``search_cost_ablation`` at its 8x1 net and at 128x6;
 25. the compiled forms (CUDA graphs, ``utils.graphs``), from phase 4's
     boards: (a) ``BatchGoEnv.rollout``'s compiled 64-step window against the
     eager ``rollout`` from the same seed, bit for bit (actions, rewards,
     dones, invalid, final states, the generator's state) over the first call
     and two replays, 65 bundle launches a window by the counter; (b) no host
     sync inside a replayed window (sync debug mode); (c) a replayed and an
     eager window under the profiler: 65 bundle kernels each by its count and
     the counter's (the profiler may lose the seeding's record), kernels a
     step, the device's busy share; (d) 5 timed
     windows of each in turns, the graph's node count and capture seconds;
     (e) a 768-step window (phase 4's warmup) as one graph from fresh boards:
     its capture's nodes and seconds, a replay equal to the eager rollout bit
     for bit, the peak memory; (f) ``make_jitted_train_step`` at 1024 rows
     with the committed 128x6 net in bfloat16 against ``train_step`` on a copy
     whose AdamW is capturable too (cuDNN deterministic), bit for bit over 3
     steps, ms of each; (g) a 19x19 ``GoEnv`` game on the card through the
     compiled ``gogame`` step and again through the eager one: equal at every
     step, ms of each;
 26. the compiled search (``run_gumbel_mcts``, ``run_mcts`` and
     ``compact_subtree``, the self-play move, the match ply, each a CUDA
     graph) against its eager form (``utils.graphs.eager``) in the same call:
     (a) cell 3's search (B = 256, 128x6 bfloat16, Gumbel 32/16) bit for bit
     over the first call and 2 replays, 64 bundle launches and no host sync
     in a replay, ms per simulation and searches/s of both forms in turns,
     each one's device busy share and kernels per simulation under the
     profiler, the graph's nodes and capture seconds, and the walk's device
     us a simulation (the search's 32 walks alone, one graph, CUDA events);
     (b) PUCT 32 with subtree reuse over 4 genmoves and their replies, moves
     and carried trees equal to the eager mover's; (c) cell 5's self-play
     window (envs 512, 8 moves) compiled (capturing, then replayed) equal to
     the eager one row for row, seconds of each; (d) a 9x9 match of 16
     games, 4 opening moves, cap 60, tallies and final states equal; (e) the
     19x19 Gumbel ``genmove`` at B = 1, ms and busy share of both forms;
 27. the minmax route compiled (its claim flood a hand kernel with no host
     sync): (a) the claim kernel's uint8 word equal to its plain version's
     on every cell, on random boards at N = 5, 9, 19, 22, 23, 25, 32, the
     shaped boards at 19, 22, 25, 32, the odd batches and phase 4's
     steady-state boards, then timed (CUDA events) beside its byte bound and
     the plain version's time; (b) ``BatchGoEnv.rollout``'s compiled 64-step
     window at 19x19 B = 12288 on the minmax route against its eager form
     (``utils.graphs.eager``) from the same seed, bit for bit over the first
     call and two replays, 65 min/max, 64 claim and 0 bundle launches a
     window, no host sync in a replay (sync debug mode error), env-steps/s
     of both forms in turns and each one's busy share under the profiler;
     (c) ``run_gumbel_mcts`` (B = 256, 128x6 bfloat16, 32/16) on the minmax
     route compiled against eager, bit for bit over the first call and a
     replay, 64 min/max and 32 claim launches and no host sync in a replay,
     ms per simulation of both; (d) 25x25 (which the bundle word cannot
     hold), B = 4096: a replayed 64-step window equal to the eager one bit
     for bit with no host sync, and its first 64 envs equal to a CPU replay;
 28. boards over 32x32 on the minmax route (the min/max and claim kernels
     label them a block a board, up to 181x181): (a) both kernels equal to
     their plain versions on every cell, on random boards at N = 33 ... 181
     (both sides of where a board's int32 arrays stop fitting in shared
     memory), the shaped boards at 33, 64, 134, 181 and odd batches at
     181; (b) ``BatchGoEnv.rollout`` at 64x64 B = 1024 (1024 warmup steps),
     (c) at 181x181 B = 128 (512 warmup steps, 16-step windows): compiled
     against eager bit for bit over two replays, no host sync in a replay,
     65/17 min/max and 64/16 claim launches a window, a B = 16 / B = 2 slice
     equal to a CPU replay, env-steps/s of both forms in turns, busy shares,
     both kernels timed on the window's boards beside their byte bounds and
     plain times, ``score.areas`` against the CPU; (d) ``GoEnv`` (torch on
     the card) and ``gogame.next_state`` at 37x37 against the CPU.
 29. the served net's fused GroupNorm kernel at the 20-block net's shapes
     (19x19, C = 256, bfloat16, channels-last): (a) at B = 256 and B = 1,
     without and with the residual, the kernel within 1 ulp of the plain
     version (the library's group_norm, relu and add) on the same tensors,
     the share of unequal elements counted; kernel, plain version and the
     library's NCHW operations (as the net ran before) timed in CUDA graphs
     of 39 calls, beside the byte bound (x read, y written, the residual
     read); (b) the 20-block net built as the benchmark builds it (``meta``,
     ``to_empty``, ``copy_``): its convolution kernels channels-last, 39
     launches a forward at B = 256 and B = 1 (the counter set to 0 first),
     the served forward against the library's NCHW forward on the same
     weights, and both forwards timed in CUDA graphs.

Phases 12-14 are the play path, 15 the training path, 17-18 the host surface,
20 the GTP front end, 22-23 the parallel layer and the soak, 24 the
measurement layer, 25-26 the compiled forms, 27 the minmax route compiled,
28 boards over 32x32, 29 the served net's norm kernel;
the launch counts are set to 0 before the search, each match, the training
run, the ``gogame`` game, the ``GoEnv`` games, phase 20, each sharded
rollout of 22a, each ablation's windows, each layout's search, phase 25's
compiled windows and phase 26's searches, and read after; phase 27 reads
them around each path it drives, as does phase 28.  After phase 15, a replay of the recipe's
size takes one add of more rows than its capacity (81,920 into 65,536):
every slot must hold one whole row, the last 65,536 in order.
The line before the nvidia-smi line is a JSON object with the four kernels'
numbers; the last line is ``{"ok": true, "device": {...}}``.  Needs one card;
exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import functools
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


def board_cases(dev, gen, sizes, shaped_sizes, odd=19, batch=1237):
    """(name, mover, opp) cases: ``batch`` random boards at each of ``sizes``;
    serpentine, staircase and component boards at each of ``shaped_sizes``;
    and, at N = ``odd``, one board, 17 boards and a contiguous slice whose
    address is no multiple of 16."""
    cases = []
    for n in sizes:
        r = torch.rand((batch, n, n), generator=gen, device=dev)
        dens = torch.rand((batch, 1, 1), generator=gen, device=dev) * 0.9
        a = r < dens / 2
        b = (r >= dens / 2) & (r < dens)
        cases.append((f"random N={n} B={batch}", a.contiguous(), b.contiguous()))
    for maker in (serpentine, staircase):
        for n in shaped_sizes:
            mask = maker(n).to(dev)
            none = torch.zeros_like(mask)
            stack = lambda *xs: torch.stack(xs).contiguous()
            cases.append((f"{maker.__name__} N={n}",
                          stack(mask, none, ~mask, mask),
                          stack(none, mask, none, ~mask & (torch.arange(n * n, device=dev).view(n, n) % 3 == 0))))
    cases += [component_case(dev, n) for n in shaped_sizes]
    _, a, b = next(c for c in cases if c[0].startswith(f"random N={odd} "))
    if a[3:].data_ptr() % 16 == 0:
        fail("the sliced planes are aligned; the case would not try a misaligned address")
    cases += [(f"random N={odd} B=1", a[:1], b[:1]), (f"random N={odd} B=17", a[:17], b[:17]),
              (f"random N={odd} B={batch - 3} misaligned", a[3:], b[3:])]
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


def graphed_ms(fn, calls, reps):
    """Mean device ms per call of ``fn``, by CUDA events around ``reps``
    replays of one CUDA graph of ``calls`` calls (warmed up on a side stream
    first, as graph capture asks): the served net replays its norms so, and
    a graph leaves out the host's launch cost that an eager loop at batch 1
    would time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


@contextlib.contextmanager
def host_syncs():
    """Yields a list that holds, after the block, one warning per
    synchronizing CUDA call made inside it (PyTorch's sync debug mode, set to
    warn; other warnings, such as the mode's notice at its first use in a
    process that it is a prototype, are left out)."""
    previous = torch.cuda.get_sync_debug_mode()
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    syncs.extend(w for w in caught if "synchroniz" in str(w.message) and "prototype" not in str(w.message))


def device_profile(fn):
    """Run ``fn`` under torch.profiler: (wall us, [(device us, launches,
    kernel name)] by device time).  Kernel events only: an aten op's row
    repeats the time of its kernels, and the device-side image of one of the
    program's layer spans (``gymgo.*``) spans the kernels inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gymgo_tpu_torch.utils.tracing import PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0 and not ev.key.startswith(PREFIX)]
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
    """Phase 19: ``bench_torch.py`` at two batch sizes and the search
    bench's Gumbel sweep, as subprocesses; returns the rollout benches' JSON
    records."""
    t_phase = time.perf_counter()
    records = []
    for batch in (4096, 49152):  # 12288 is phase 4's rollout
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



def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start(args, env=None):
    """A subprocess from the root: ``args[0]`` a script (``*.py``) or a module;
    ``env`` adds to this process's environment."""
    head = [sys.executable] if args[0].endswith(".py") else [sys.executable, "-m"]
    return subprocess.Popen([*head, *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=None if env is None else dict(os.environ, **env))


def finish(name, procs, timeout):
    """The stdouts of ``procs``, each waited on with ``timeout``; fails on a
    non-zero exit or a timeout, and kills whatever still runs."""
    results = []
    try:
        for proc in procs:
            try:
                results.append(proc.communicate(timeout=timeout) + (proc.returncode,))
            except subprocess.TimeoutExpired:
                fail(f"{name}: timed out after {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for i, (out, err, rc) in enumerate(results):
        if rc != 0:
            fail(f"{name}: process {i} exited {rc}:\n{out[-1500:]}{err[-1500:]}")
    return [out for out, _, _ in results]


def json_line(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def checksums(r):
    """The multi-process worker's checksums of a rollout (float64 sums)."""
    return {"state_checksum": int(r.final_states.sum(dtype=torch.int64)),
            "action_checksum": int(r.actions.sum(dtype=torch.int64)),
            "reward_checksum": float(r.rewards.double().sum())}


CHECKSUM_KEYS = ("state_checksum", "action_checksum", "reward_checksum")


def sharding_path(dev, states, bundle_lib, minmax_lib, workdir):
    """Phase 22: the parallel layer on the card.  ``states`` are phase 4's
    steady-state boards.  Returns the bundle kernel's launches in (a) per
    number of shards, and (a)'s rates (key 0: unsharded)."""
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
    from gymgo_tpu_torch.models.az_net import AZNet
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh
    from gymgo_tpu_torch.rl.learner import make_train_state, train_step
    from gymgo_tpu_torch.utils.checkpoint import restore_npz, save_npz
    from gymgo_tpu_torch.utils.faulttol import chunk_seed

    # (a) k logical shards of the card against the unsharded rollout
    t_phase = time.perf_counter()
    B, STEPS, WINDOWS = 12288, 64, 3
    cfg = EnvConfig(board_size=19, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
    plain = rollout(torch.Generator(device=dev).manual_seed(SEED + 22), states, STEPS, cfg)
    launches, rates = {}, {}
    # the unsharded compiled rollout (BatchGoEnv) timed the same way, in this phase, for the rates of
    # each k; its first call, which captures, untimed (phase 25 profiles it on the same boards)
    unsharded = BatchGoEnv(cfg, device=dev)
    unsharded.rollout(torch.Generator(device=dev).manual_seed(SEED + 23), plain.final_states, STEPS)
    rates[0], _, _ = timed_windows(lambda g, s, w, c: unsharded.rollout(g, s, w),
                                   torch.Generator(device=dev).manual_seed(SEED + 23), plain.final_states,
                                   cfg, STEPS, WINDOWS)
    print(f"[22a logical shards] 19x19 B={B}, unsharded (BatchGoEnv, compiled): {WINDOWS} windows: "
          f"{rates_text(rates[0])}", flush=True)
    for k in (1, 2, 4):
        env = ShardedGoEnv(cfg, make_mesh(devices=[dev] * k))
        torch.cuda.synchronize()
        bundle_lib.launches = minmax_lib.launches = 0
        r = env.rollout(torch.Generator(device=dev).manual_seed(SEED + 22), states, STEPS)
        torch.cuda.synchronize()
        launches[k] = bundle_lib.launches
        if launches[k] != k * (STEPS + 1) or minmax_lib.launches != 0:
            fail(f"22a k={k}: bundle kernel launched {launches[k]} times (expected {k} x ({STEPS} + 1)), "
                 f"min/max {minmax_lib.launches}")
        for field in ("final_states", "actions", "rewards", "dones", "invalid"):
            if not torch.equal(getattr(r, field), getattr(plain, field)):
                fail(f"22a k={k}: the sharded rollout differs from the unsharded one on {field}")
        rates[k], _, _ = timed_windows(lambda g, s, w, c: env.rollout(g, s, w), torch.Generator(device=dev)
                                       .manual_seed(SEED + 23), plain.final_states, cfg, STEPS, WINDOWS)
        profiled = ""
        if k == 4:  # a replayed window
            wall_us, rows = device_profile(lambda: env.rollout(torch.Generator(device=dev).manual_seed(SEED),
                                                               states, STEPS))
            busy_us = sum(row[0] for row in rows)
            profiled = (f"; profiled {STEPS} steps: wall {wall_us / STEPS:.1f} us/step, device busy "
                        f"{busy_us / STEPS:.1f} us/step ({100 * busy_us / wall_us:.1f}%), "
                        f"{sum(row[1] for row in rows) / STEPS:.1f} kernel launches/step")
        print(f"[22a logical shards] 19x19 B={B}, k={k} shards of one card (compiled), {STEPS} steps from phase 4's "
              f"boards: final states, actions, rewards, dones == unsharded bit for bit; bundle launches "
              f"{launches[k]} = {k} x ({STEPS} + 1); {WINDOWS} windows from the unsharded windows' start: "
              f"{rates_text(rates[k])} ({statistics.median(rates[k]) / statistics.median(rates[0]):.3f} of "
              f"unsharded){profiled}", flush=True)
    print(f"[22a logical shards] phase {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (b) two ranks on the one card (gloo), against one process; then killed and restarted
    t0 = time.perf_counter()
    N, B2, STEPS2, SEGS = 19, 4096, 64, 2

    def worker(pid, port, *extra):
        return ["gymgo_tpu_torch.scripts.multiproc_worker", "--coordinator", f"localhost:{port}",
                "--num-processes", "2", "--process-id", str(pid), "--local-devices", "2", "--device", "cuda",
                "--board", str(N), "--batch", str(B2), "--steps", str(STEPS2), "--seed", str(SEED), *extra]

    port = free_port()
    outs = [json_line(o) for o in finish("22b two ranks", [start(worker(pid, port)) for pid in (0, 1)], 300)]
    cfg2 = EnvConfig(board_size=N, batch_size=B2, auto_reset=True)
    one = checksums(rollout(torch.Generator(device=dev).manual_seed(SEED), batch_init_state(B2, N, device=dev),
                            STEPS2, cfg2))
    got = [{k: o[k] for k in CHECKSUM_KEYS} for o in outs]
    if got[0] != got[1] or got[0] != one or {o["backend"] for o in outs} != {"gloo"}:
        fail(f"22b: two ranks {outs} against one process {one}")
    ckpt = workdir / "ranks.npz"
    seg = ["--num-segments", str(SEGS), "--ckpt", str(ckpt)]
    port = free_port()
    p0, p1 = start(worker(0, port, *seg)), start(worker(1, port, *seg, "--crash-after-segment", "0"))
    try:
        try:
            _, err1 = p1.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            fail("22b: the rank meant to crash timed out")
        if p1.returncode != 1 or not ckpt.exists():
            fail(f"22b: rank 1 exited {p1.returncode} (expected 1), checkpoint written {ckpt.exists()}:"
                 f"\n{err1[-1500:]}")
        try:  # the survivor fails on its dead peer or waits on it: the launcher ends it
            p0.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
    finally:
        for proc in (p0, p1):
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    survivor = p0.returncode
    port = free_port()
    resumed = [json_line(o) for o in finish("22b restart", [start(worker(pid, port, *seg, "--start-segment", "1"))
                                                           for pid in (0, 1)], 300)]
    s = batch_init_state(B2, N, device=dev)
    for i in range(SEGS):
        r = rollout(torch.Generator(device=dev).manual_seed(chunk_seed(SEED, i)), s, STEPS2 // SEGS, cfg2)
        s = r.final_states
    whole = checksums(r)
    got = [{k: o[k] for k in CHECKSUM_KEYS} for o in resumed]
    if got[0] != got[1] or got[0] != whole:
        fail(f"22b: the restarted run {resumed} differs from the uninterrupted one {whole}")
    print(f"[22b two ranks] 19x19 B={B2}, {STEPS2} steps, 2 ranks x 2 logical shards on one card (gloo): "
          f"checksums {outs[0]['state_checksum']}/{outs[0]['action_checksum']}/"
          f"{outs[0]['reward_checksum']} on both == one process; segmented ({SEGS} segments), rank 1 killed after "
          f"segment 0 (the survivor {'exited ' + str(survivor) if survivor is not None else 'was killed'}), "
          f"restarted from the checkpoint: == uninterrupted ({whole}); {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (c) the data-parallel learner step: 2 ranks of 512 rows against one process on 1024
    t0 = time.perf_counter()
    ROWS, LR, STEPS_C, LOSS_ATOL, GRAD_RTOL = 1024, 2e-4, 3, 2e-5, 1e-2  # phase 16b's tolerances
    rng = np.random.default_rng(SEED + 22)
    obs = states[:ROWS].cpu().numpy()
    valid = np.concatenate([obs[:, 3].reshape(ROWS, -1) == 0, np.ones((ROWS, 1), bool)], 1)
    pi = np.where(valid, np.exp(2 * rng.standard_normal(valid.shape)), 0.0)
    pi = (pi / pi.sum(1, keepdims=True)).astype(np.float32)
    v = rng.choice([-1.0, 0.0, 1.0], ROWS).astype(np.float32)
    first = np.arange(ROWS) < ROWS // 2
    mask = rng.random(ROWS) < np.where(first, 0.9, 0.3)
    vmask = mask & (rng.random(ROWS) < np.where(first, 0.7, 0.2))
    batch = {"obs": obs, "pi": pi, "v": v, "mask": mask, "vmask": vmask}
    sd = {k: t.detach().cpu() for k, t in load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)
          .state_dict().items()}
    save_npz(workdir / "dp_in.npz", {"net": sd, "batches": {str(i): batch for i in range(STEPS_C)}})
    port = free_port()
    finish("22c learner ranks", [start(["tests/torch_dp_step.py", "--coordinator", f"localhost:{port}",
                                        "--num-processes", "2", "--process-id", str(pid), "--device", "cuda",
                                        "--lr", str(LR), "--inputs", str(workdir / "dp_in.npz"),
                                        "--out", str(workdir / "dp_out.npz")]) for pid in (0, 1)], 300)
    tree = restore_npz(workdir / "dp_out.npz")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = AZNet(load_aznet_npz(NET_19, device="cpu", dtype=torch.float32).config, torch.float32).to(dev)
        net.load_state_dict(sd)
        net.train()
        state = make_train_state(net, learning_rate=LR)
        rows = [torch.from_numpy(batch[k]).to(dev) for k in ("obs", "pi", "v", "mask", "vmask")]
        single_ms = []
        for i in range(STEPS_C):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = train_step(state, rows)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t1) * 1e3)
            if i == 0:
                loss0 = float(m["loss"])
                after = {k: t.detach().cpu().clone() for k, t in net.state_dict().items()}
                grads = {k: p.grad.detach().cpu().numpy() for k, p in net.named_parameters()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    dp = tree["params"]["0"]
    param_err = max(float(np.abs(dp[k] - after[k].numpy()).max()) for k in after)
    over = sum(int((np.abs(dp[k] - after[k].numpy()) > 2e-5).sum()) for k in after)
    entries = sum(t.numel() for t in after.values())
    loss_dp = float(tree["metrics"]["0"]["loss"])
    moved = max(float((after[k] - sd[k]).abs().max()) for k in after)
    # the first step's gradients, summed over the ranks, against one process's: each tensor's max |diff|
    # relative to its largest entry (AdamW's first step bounds the parameters' gap by 2 lr whatever the
    # gradients, so they alone show that the sum is the whole batch's)
    grad_errs = {k: float(np.abs(tree["grads"]["0"][k] - g).max() / max(float(np.abs(g).max()), 1e-30))
                 for k, g in grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    if (abs(loss_dp - loss0) > LOSS_ATOL or grad_err > GRAD_RTOL or param_err > 2 * LR
            or not moved > 0.5 * LR):
        fail(f"22c: the 2-rank step differs from one process's by {abs(loss_dp - loss0):.3g} (loss; atol "
             f"{LOSS_ATOL}), {grad_err:.3g} (gradients, {worst}; relative {GRAD_RTOL}) and {param_err:.3g} "
             f"(parameters; atol {2 * LR}); the parameters moved {moved:.3g}")
    dp_ms = [float(x) for x in tree["ms"]]
    print(f"[22c learner] 19x19 128x6 iter-830 net, float32 (TF32 off), AdamW lr {LR}, {ROWS} rows whose masks "
          f"differ between the halves: 2 ranks x {ROWS // 2} rows (gloo, gradients through pinned host memory) "
          f"against 1 process: loss {loss_dp:.7f} / {loss0:.7f}, gradients max |diff| / max |g| per tensor "
          f"{grad_err:.3g} ({worst}; relative {GRAD_RTOL}), parameters max |diff| {param_err:.3g} "
          f"({over} of {entries} entries over 2e-05; atol 2 lr = {2 * LR}); step ms (host clock; the ranks' "
          f"first step is their fresh processes' first, cold): "
          f"2 ranks {', '.join(f'{x:.1f}' for x in dp_ms)}; 1 process {', '.join(f'{x:.1f}' for x in single_ms)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d) the scaling scripts as subprocesses
    t0 = time.perf_counter()
    sizes = ["--board", "19", "--envs", "4096", "--steps", "32", "--warmup", "64", "--repeats", "3"]
    rec = json_line(finish("22d scaling_proxy --mode procs", [start(
        ["gymgo_tpu_torch.scripts.scaling_proxy", "--mode", "procs", *sizes])], 300)[0])
    if rec["mode"] != "procs" or not all(row["env_steps_per_sec"] > 0 for row in rec["rows"]):
        fail(f"22d scaling_proxy --mode procs: {rec}")
    print(f"[22d scaling_proxy] {json.dumps(rec)}", flush=True)
    rec = json_line(finish("22d multihost_bench", [start(
        ["gymgo_tpu_torch.scripts.multihost_bench", "--board", "19", "--envs-per-host", "4096", "--warmup-steps",
         "128", "--steps", "64", "--repeats", "3"])], 300)[0])
    if rec["hosts"] != 1 or len(rec["aggregate_env_steps_per_sec"]) != 3 or not rec["aggregate_median"] > 0:
        fail(f"22d multihost_bench: {rec}")
    print(f"[22d multihost_bench] {json.dumps(rec)}; (d) {time.perf_counter() - t0:.1f} s; phase 22 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rates


def soak():
    """Phase 23: ``fuzz_parity`` on the card at 9x9 and 19x19: the batched
    ``step_states`` (two bundle launches a step) against the native engine,
    every state of every game after every step."""
    t0 = time.perf_counter()
    GAMES = 16
    rec = json_line(finish("23 fuzz_parity", [start(
        ["gymgo_tpu_torch.scripts.fuzz_parity", "--device", "cuda", "--sizes", "9", "19", "--games", str(GAMES),
         "--max-steps", "300"])], 300)[0])
    steps = rec["states_checked"] // GAMES
    if rec["states_checked"] < 3000 or rec["bundle_launches"] != 2 * steps:
        fail(f"23 fuzz_parity: {rec} (expected 2 bundle launches for each of {steps} steps)")
    print(f"[23 soak] {rec['states_checked']} states of {GAMES} games at 9x9 and 19x19 on {rec['device']}: "
          f"torch == native on every one; bundle launches {rec['bundle_launches']} (2 per step); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rec["bundle_launches"]


STEP_TOKENS = ("hit", "ko", "capsum", "bundle", "areas", "invd")


def ablation_path(dev, states, bundle_lib, minmax_lib):
    """Phase 24a: the step's cost split by its ``GYMGO_ABLATE`` switches, on
    phase 4's steady-state 19x19 B = 12288 boards.  Returns the bundle
    kernel's launches in each ablation's timed windows, read after them with
    the counts set to 0 before."""
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core import flood as tflood
    from gymgo_tpu_torch.core import step as tstep
    from gymgo_tpu_torch.env.batch_env import rollout

    t_phase = time.perf_counter()
    B, N, WINDOW, REPEATS, PROF, B_R, STEPS_R = 12288, 19, 64, 3, 16, 256, 64
    cfg = EnvConfig(board_size=N, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
    cfg_r = EnvConfig(board_size=N, batch_size=B_R, reward_method=HEURISTIC, auto_reset=True)
    # the whole step first and last: its drift over the phase shows beside the savings
    configs = ([("whole step", ())] + [(t, (t,)) for t in STEP_TOKENS]
               + [("all six", STEP_TOKENS), ("sampler", ("sampler",)), ("whole step again", ())])
    table, launches = [], {}
    for label, tokens in configs:
        previous = tstep.set_ablate(tokens)
        try:
            gen = torch.Generator(device=dev).manual_seed(SEED + 24)
            rollout(gen, states, 4, cfg)
            torch.cuda.synchronize()
            bundle_lib.launches = minmax_lib.launches = 0
            rates, _, _ = timed_windows(rollout, gen, states, cfg, WINDOW, REPEATS)
            per_step = 0 if "bundle" in tokens else 1
            expected = REPEATS * (WINDOW * per_step + 1)  # a step's flood, and each call's seeding
            if bundle_lib.launches != expected or minmax_lib.launches != 0:
                fail(f"24a {label}: bundle launches {bundle_lib.launches} (expected {expected}), "
                     f"min/max {minmax_lib.launches}")
            launches[label] = bundle_lib.launches
            wall_us, rows = device_profile(lambda: rollout(gen, states, PROF, cfg))
            # the same ablation replayed with its actions on the CPU plain path
            start_r = states[:B_R].clone()
            rc = rollout(torch.Generator(device=dev).manual_seed(SEED + 25), start_r, STEPS_R, cfg_r)
            acts = iter(rc.actions.cpu())
            rh = rollout(torch.Generator().manual_seed(0), start_r.cpu(), STEPS_R, cfg_r,
                         policy_fn=lambda _g, _s: next(acts))
            for field in ("final_states", "rewards", "dones"):
                if not torch.equal(getattr(rc, field).cpu(), getattr(rh, field)):
                    fail(f"24a {label}: card and CPU replay disagree on {field}")
        finally:
            tstep.set_ablate(previous)
        busy = sum(r[0] for r in rows) / PROF
        if busy <= 0:
            fail(f"24a {label}: the profile of {PROF} steps shows no device time")
        row = (label, B * 1e6 / statistics.median(rates), wall_us / PROF, busy,
               sum(r[1] for r in rows) / PROF)
        table.append(row)
        print(f"[24a ablation] {label}: 19x19 B={B}, {REPEATS} windows of {WINDOW} steps from phase 4's boards: "
              f"{rates_text(rates)}; bundle launches {launches[label]} (= {REPEATS} x ({WINDOW} x {per_step} "
              f"+ 1)); profiled {PROF} steps: wall {row[2]:.1f} us/step, device busy "
              f"{busy:.1f} us/step ({100 * busy * PROF / wall_us:.1f}%), {row[4]:.1f} kernel launches/step; "
              f"{STEPS_R}-step B={B_R} replay on the CPU: == card", flush=True)

    # GYMGO_BITPACK_FIXED_ONLY truncates the plain flood; the kernel has no substeps to truncate
    previous = tflood.set_bitpack_fixed_only(16)
    bundle_lib.launches = 0
    try:
        rollout(torch.Generator(device=dev).manual_seed(SEED), states[:64], 1, cfg_r)
    except ValueError as err:
        refused = str(err)
    else:
        fail("24a: GYMGO_BITPACK_FIXED_ONLY did not raise on CUDA tensors")
    finally:
        tflood.set_bitpack_fixed_only(previous)
    if bundle_lib.launches != 0:
        fail(f"24a: the bundle kernel launched {bundle_lib.launches} times under GYMGO_BITPACK_FIXED_ONLY")
    print(f"[24a FIXED_ONLY] GYMGO_BITPACK_FIXED_ONLY=1 on CUDA tensors: ValueError, no launch ({refused[:90]}...)",
          flush=True)

    whole = [(a + b) / 2 for a, b in zip(table[0][1:], table[-1][1:])]
    whole = (None, *whole)
    print("[24a decomposition] what each component costs the step, against the mean of the two whole-step runs "
          "of this call (host wall from the windows' median; device busy and launches from the profiled "
          "steps):", flush=True)
    print("[24a decomposition] | ablated | wall us/step | saved | profiled wall us/step | device us/step | "
          "saved | launches/step | saved |", flush=True)
    for label, wall, prof_wall, busy, n_k in table:
        print(f"[24a decomposition] | {label} | {wall:.1f} | {whole[1] - wall:.1f} | {prof_wall:.1f} | {busy:.1f} | "
              f"{whole[3] - busy:.1f} | {n_k:.1f} | {whole[4] - n_k:.1f} |", flush=True)
    print(f"[24a ablations] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def layouts_path(dev, states, bundle_lib, minmax_lib):
    """Phase 24b: the Gumbel search under the ``GYMGO_GUMBEL_PACK`` layouts
    of the JAX package's table (the default, ``i16,logp``,
    ``i16,logp,bf16``): at full width on the card, the card against the CPU,
    and the search bench's B = 512 -> 1024 sweep as subprocesses.  Returns
    each layout's bundle launches in one search, read after it with the
    counts set to 0 before."""
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.actions import batch_valid_moves, gumbel_noise
    from gymgo_tpu_torch.rl import gumbel_mcts as tgumbel

    t_phase = time.perf_counter()
    SIMS, CONSIDERED, B, B_R, SIMS_R = 32, 16, 256, 32, 16
    layouts = [("default", ()), ("i16,logp", ("i16", "logp")), ("i16,logp,bf16", ("i16", "logp", "bf16"))]
    net16 = load_aznet_npz(NET_19, device=dev, dtype=torch.bfloat16)
    net32 = load_aznet_npz(NET_19, device=dev, dtype=torch.float32)
    net_cpu = load_aznet_npz(NET_19, device="cpu", dtype=torch.float32)
    roots = states[:B].clone()
    valid = batch_valid_moves(roots) > 0
    noise = gumbel_noise(torch.Generator(device=dev).manual_seed(SEED + 14), (B_R, 19 * 19 + 1), dev)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    launches = {}
    for label, tokens in layouts:
        previous = tgumbel.set_gumbel_pack(tokens)
        try:
            def search():
                gen = torch.Generator(device=dev).manual_seed(SEED + 24)
                return tgumbel.run_gumbel_mcts(gen, roots, net16, num_simulations=SIMS, max_considered=CONSIDERED)

            search()
            torch.cuda.synchronize()
            bundle_lib.launches = minmax_lib.launches = 0
            t0 = time.perf_counter()
            res = search()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = bundle_lib.launches
            if bundle_lib.launches != 2 * SIMS or minmax_lib.launches != 0:
                fail(f"24b {label}: {bundle_lib.launches} bundle launches (expected {2 * SIMS}), "
                     f"{minmax_lib.launches} min/max")
            if not bool(valid.gather(1, res.actions.long()[:, None]).all()):
                fail(f"24b {label}: the search returned an illegal action")
            if not bool((res.root_visits.sum(1) == SIMS).all()):
                fail(f"24b {label}: root visits do not sum to {SIMS}")
            if not (bool(((res.improved_policy.sum(1) - 1).abs() < 1e-4).all())
                    and bool((res.improved_policy[~valid] == 0).all())
                    and bool(torch.isfinite(res.root_value).all())):
                fail(f"24b {label}: improved policy does not sum to 1 over the valid moves, or a value is not finite")
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            try:
                on_card = tgumbel.run_gumbel_mcts(None, roots[:B_R], net32, num_simulations=SIMS_R,
                                                  max_considered=CONSIDERED, gumbel=noise)
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
            on_cpu = tgumbel.run_gumbel_mcts(None, roots[:B_R].cpu(), net_cpu, num_simulations=SIMS_R,
                                             max_considered=CONSIDERED, gumbel=noise.cpu())
        finally:
            tgumbel.set_gumbel_pack(previous)
        differ = int(((on_card.actions.cpu() != on_cpu.actions)
                      | (on_card.root_visits.cpu() != on_cpu.root_visits).any(1)).sum())
        if "bf16" not in tokens and differ > 1:
            fail(f"24b {label}: {differ} of {B_R} envs differ between the card and the CPU")
        rule = ("counted, not required (bfloat16 sums)" if "bf16" in tokens
                else "at most 1 allowed: a float near-tie may flip a visit")
        print(f"[24b layout {label}] 19x19 128x6 bfloat16, B={B}, {SIMS}/{CONSIDERED}: {B / wall:.1f} searches/s, "
              f"{1e3 * wall / SIMS:.3f} ms/simulation, legal actions, {SIMS} visits, policies sum to 1; bundle "
              f"launches {launches[label]}; B={B_R}, {SIMS_R} simulations, float32 (TF32 off), injected noise: "
              f"card vs CPU differ on {differ} of {B_R} envs ({rule}); max |diff| improved policy "
              f"{float((on_card.improved_policy.cpu() - on_cpu.improved_policy).abs().max()):.3g}", flush=True)

    sweep = {}
    for label, tokens in layouts:
        t0 = time.perf_counter()
        out = finish(f"24b mcts_bench {label}", [start(
            ["gymgo_tpu_torch.benchmarks.mcts_bench", "--search", "gumbel", "--channels", "128", "--blocks", "6",
             "--batch-sweep", "512,1024", "--repeats", "3"], env={"GYMGO_GUMBEL_PACK": ",".join(tokens)})], 600)[0]
        rows = [ln for ln in out.splitlines() if ln.startswith("| ") and ln[2].isdigit()]
        if [int(r.split("|")[1]) for r in rows] != [512, 1024]:
            fail(f"24b mcts_bench {label}: {out[-1500:]}")
        sweep[label] = [float(r.split("|")[2]) for r in rows]
        for row in rows:
            print(f"[24b mcts_bench {label}] {row} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print("[24b layouts] | layout | B=512 ms | B=1024 ms | B=1024 decisions/s | 2x-batch time ratio |", flush=True)
    for label, (ms512, ms1024) in sweep.items():
        print(f"[24b layouts] | {label} | {ms512:.1f} | {ms1024:.1f} | {1024 / ms1024 * 1e3:,.0f} | "
              f"{ms1024 / ms512:.2f}x |", flush=True)
    print(f"[24b layouts] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def studies():
    """Phase 24c: the three measurement scripts as subprocesses on the card.
    The two that count (convergence, walk depth) run side by side; the one
    that times (search_cost_ablation) runs alone.  Returns the bundle
    launches of ``measure_convergence``'s steps."""
    t_phase = time.perf_counter()
    MEASURE_STEPS = 32  # the script's 64 cut to keep the run in its time limit
    names = ["measure_convergence", "measure_convergence --warm-study", "walk_depth_study 13x13",
             "walk_depth_study 19x19 128x6"]
    outs = finish("24c studies", [
        start(["gymgo_tpu_torch.scripts.measure_convergence", "--measure-steps", str(MEASURE_STEPS)]),
        start(["gymgo_tpu_torch.scripts.measure_convergence", "--measure-steps", str(MEASURE_STEPS),
               "--warm-study"]),
        start(["gymgo_tpu_torch.scripts.walk_depth_study"]),
        start(["gymgo_tpu_torch.scripts.walk_depth_study", "--board", "19", "--channels", "128", "--blocks", "6",
               "--batches", "64,512"]),
    ], 600)
    recs = [json_line(out) for out in outs]
    conv, warm = recs[0], recs[1]
    if not (conv["kernel_checked_steps"] == MEASURE_STEPS and conv["kernel_mismatch_steps"] == 0
            and conv["step_launches"] == MEASURE_STEPS + 1):
        fail(f"24c measure_convergence: {conv}")
    if not (warm["fixpoint_equal_every_step"] and warm["equal_steps"] == MEASURE_STEPS):
        fail(f"24c measure_convergence --warm-study: {warm}")
    for name, out in zip(names, outs):
        for line in out.strip().splitlines():
            print(f"[24c {name}] {line}", flush=True)
    print(f"[24c] counted studies side by side {time.perf_counter() - t_phase:.1f} s", flush=True)
    for width in ([], ["--channels", "128", "--blocks", "6"]):
        t0 = time.perf_counter()
        out = finish("24c search_cost_ablation", [start(["gymgo_tpu_torch.scripts.search_cost_ablation", *width])],
                     600)[0]
        rec = json_line(out)
        if len(rec["components"]) != 6 or not all("launches_per_sim" in c for c in rec["components"]):
            fail(f"24c search_cost_ablation {width}: {rec}")
        for line in out.strip().splitlines():
            print(f"[24c search_cost_ablation {rec['channels']}x{rec['blocks']}] {line}", flush=True)
        print(f"[24c search_cost_ablation {rec['channels']}x{rec['blocks']}] {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[24c studies] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"measure_convergence": conv["step_launches"]}


def compiled_path(dev, states, bundle_lib, minmax_lib):
    """Phase 25: the compiled forms (``utils.graphs``, CUDA graphs) on the
    card, from phase 4's steady-state 19x19 B = 12288 ``states``.  Returns the
    bundle kernel's launches in (a)'s three compiled windows."""
    from gymgo_tpu_torch import gogame
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env import GoEnv
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
    from gymgo_tpu_torch.models.az_net import AZNet
    from gymgo_tpu_torch.rl.learner import make_jitted_train_step, make_train_state, train_step

    t_phase = time.perf_counter()
    B, N, WINDOW, REPEATS = states.shape[0], states.shape[-1], 64, 5
    fields = ("actions", "rewards", "dones", "invalid", "final_states")
    cfg = EnvConfig(board_size=N, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
    env = BatchGoEnv(cfg, device=dev)
    if not env.compiled:
        fail("BatchGoEnv is not compiled on the bundle route on the card")

    # (a) the compiled rollout against the eager one from the same seed, bit for bit: the first call (run
    # eagerly, then captured) and two replays, each window from the last one's boards
    gc, ge = (torch.Generator(device=dev).manual_seed(SEED + 25) for _ in range(2))
    s = states
    bundle_lib.launches = minmax_lib.launches = 0
    per_call = []
    for i in range(3):
        before = bundle_lib.launches
        got = env.rollout(gc, s, WINDOW)
        per_call.append(bundle_lib.launches - before)
        want = rollout(ge, s, WINDOW, cfg)
        for field in fields:
            if not torch.equal(getattr(got, field), getattr(want, field)):
                fail(f"25a: the compiled rollout differs from the eager one on {field} at call {i}")
        s = got.final_states
    if per_call != [WINDOW + 1] * 3 or minmax_lib.launches != 0:
        fail(f"25a: bundle launches {per_call} per compiled window (expected {WINDOW + 1}), "
             f"min/max {minmax_lib.launches}")
    if not torch.equal(gc.get_state(), ge.get_state()):
        fail("25a: the compiled rollout left its generator elsewhere than the eager one")
    (graph,) = env._rollout.graphs.values()

    # (b) no host sync inside a replayed window
    with host_syncs() as caught:
        env.rollout(gc, s, WINDOW)
    if caught:
        fail(f"25b: a replayed window made {len(caught)} host syncs: {caught[0].message}")

    # (c) a replayed window and an eager one under the profiler: the bundle kernel's launches by the
    # profiler's count and by the counter, kernels a step, the device's busy share.  The profiler has
    # lost one kernel record of a window, replayed or eager, in some runs (64 of 65, where the counter and
    # the bit-exact result say all 65 ran), so it is held to one a step, the seeding's record allowed lost.
    profiles, seen = {}, {}
    for form, fn in (("compiled", lambda: env.rollout(gc, s, WINDOW)), ("eager", lambda: rollout(gc, s, WINDOW, cfg))):
        before = bundle_lib.launches
        wall_us, rows = device_profile(fn)
        counted = bundle_lib.launches - before
        seen[form] = sum(c for _, c, k in rows if "BundleOp" in k)
        busy_us = sum(r[0] for r in rows)
        if not WINDOW <= seen[form] <= WINDOW + 1 or counted != WINDOW + 1 or busy_us <= 0:
            fail(f"25c {form}: the profiler saw {seen[form]} bundle kernels and {busy_us} us of device time, the "
                 f"counter {counted}; expected {WINDOW + 1}")
        profiles[form] = (wall_us / WINDOW, busy_us / WINDOW, 100 * busy_us / wall_us,
                          sum(r[1] for r in rows) / WINDOW)

    # (d) timed windows in turns, each from the same boards and ending on a scalar checksum fetch
    rates = {"compiled": [], "eager": []}
    for _ in range(REPEATS):
        for form, fn in (("compiled", lambda: env.rollout(gc, s, WINDOW)),
                         ("eager", lambda: rollout(gc, s, WINDOW, cfg))):
            t0 = time.perf_counter()
            r = fn()
            checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
            rates[form].append(B * WINDOW / (time.perf_counter() - t0))
            if not math.isfinite(checksum):
                fail(f"25d: checksum not finite: {checksum}")
    for form in ("compiled", "eager"):
        wall, busy, share, kernels = profiles[form]
        print(f"[25 compiled rollout] 19x19 B={B}, {WINDOW}-step windows, {form}: {rates_text(rates[form])}; "
              f"profiled {wall:.1f} us/step wall, device busy {busy:.1f} us/step ({share:.1f}% busy), "
              f"{kernels:.1f} kernels/step", flush=True)
    print(f"[25 compiled rollout] == eager bit for bit over a first call and 2 replays (actions, rewards, dones, "
          f"invalid, final states, the generator); bundle launches {per_call} by the counter, "
          f"{seen['compiled']} in a replayed window by the profiler ({seen['eager']} in an eager one); "
          f"0 host syncs in a replay; graph {graph.nodes} nodes "
          f"({graph.nodes / WINDOW:.1f} a step), captured in {graph.capture_seconds:.3f} s", flush=True)

    # (e) a whole 768-step window (phase 4's warmup) as one graph, from fresh boards: the first call (eager,
    # then the capture), then a replay from fresh boards against the eager rollout, bit for bit
    LONG = 768
    fresh = batch_init_state(B, N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    env.rollout(torch.Generator(device=dev).manual_seed(SEED + 27), fresh, LONG)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    long_graph = next(g for g in env._rollout.graphs.values() if g.static_out.actions.shape[0] == LONG)
    t0 = time.perf_counter()
    got = env.rollout(torch.Generator(device=dev).manual_seed(SEED + 28), fresh, LONG)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = rollout(torch.Generator(device=dev).manual_seed(SEED + 28), fresh, LONG, cfg)
    for field in fields:
        if not torch.equal(getattr(got, field), getattr(want, field)):
            fail(f"25e: the compiled {LONG}-step rollout differs from the eager one on {field}")
    print(f"[25 compiled rollout] a {LONG}-step window from fresh boards: first call (eager, then the capture) "
          f"{first_s:.2f} s, graph {long_graph.nodes} nodes captured in {long_graph.capture_seconds:.2f} s, "
          f"a replay {replay_s:.3f} s == eager bit for bit; peak memory {peak_gb:.2f} GiB", flush=True)

    # (f) the learner step (cell 5's 1024 rows, the committed 128x6 net computing in bfloat16 as the trainer
    # does): compiled against train_step on a copy whose AdamW is capturable too, cuDNN deterministic, bit for
    # bit over 3 steps; then ms of each, by CUDA events
    ROWS = 1024
    src = load_aznet_npz(NET_19, device=dev)
    sd = {k: v.float() for k, v in src.state_dict().items()}
    nets = []
    for _ in range(2):
        net = AZNet(src.config, torch.float32)
        net.load_state_dict(sd)
        nets.append(net.to(dev))
    eager_ts, jit_ts = make_train_state(nets[0], 2e-4), make_train_state(nets[1], 2e-4)
    for group in eager_ts.optimizer.param_groups:
        group["capturable"] = True
    jit_step = make_jitted_train_step(jit_ts)
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    pi = torch.softmax(torch.randn((ROWS, N * N + 1), device=dev, generator=g), 1)
    v = torch.randint(0, 2, (ROWS,), device=dev, generator=g).float() * 2 - 1
    mask = torch.rand(ROWS, device=dev, generator=g) < 0.9
    batch = (states[:ROWS], pi, v, mask, mask & (torch.rand(ROWS, device=dev, generator=g) < 0.5))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(3):
            eager_ts, want = train_step(eager_ts, batch)
            jit_ts, got = jit_step(jit_ts, batch)
            if not all(torch.equal(got[k], want[k]) for k in want):
                fail(f"25f: learner step {i}: compiled loss {float(got['loss'])} != eager {float(want['loss'])}")
            if not all(torch.equal(p, q) for p, q in zip(nets[0].parameters(), nets[1].parameters())):
                worst = max(float((p - q).abs().max()) for p, q in zip(nets[0].parameters(), nets[1].parameters()))
                fail(f"25f: learner step {i}: the parameters differ by {worst:.3g}")
        eager_ms = time_ms(lambda: train_step(eager_ts, batch), 8)
        jit_ms = time_ms(lambda: jit_step(jit_ts, batch), 8)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (learner_graph,) = jit_step.update.graphs.values()
    print(f"[25 compiled learner] 19x19 128x6 bfloat16, {ROWS} rows, AdamW lr 2e-4: compiled == eager "
          f"(capturable AdamW, cuDNN deterministic) bit for bit over 3 steps (loss {float(got['loss']):.6f}); "
          f"ms a step: compiled {jit_ms:.3f}, eager {eager_ms:.3f}; graph {learner_graph.nodes} nodes, captured "
          f"in {learner_graph.capture_seconds:.3f} s", flush=True)

    # (g) a GoEnv game (cell 6) through the compiled gogame step, then the same actions through the eager one
    def game(moves):
        np.random.seed(SEED + 25)
        e = GoEnv(N, reward_method="heuristic", backend="torch", device=dev)
        e.reset()
        out, ms = [], []
        for _ in range(moves):
            a = e.uniform_random_action()
            t0 = time.perf_counter()
            obs, reward, done, _ = e.step(a)
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append((obs, reward, done))
            if done:
                break
        return out, ms

    compiled_step = gogame._step_states
    before = bundle_lib.launches
    game_c, ms_c = game(200)
    game_launches = bundle_lib.launches - before
    gogame._step_states = compiled_step.fn
    try:
        game_e, ms_e = game(200)
    finally:
        gogame._step_states = compiled_step
    if len(game_c) != len(game_e) or any(not (np.array_equal(a[0], b[0]) and a[1:] == b[1:])
                                         for a, b in zip(game_c, game_e)):
        fail("25g: the GoEnv game through the compiled step differs from the eager one")
    if game_launches != 2 * len(game_c):
        fail(f"25g: {game_launches} bundle launches in {len(game_c)} compiled GoEnv steps (2 a step)")
    print(f"[25 compiled GoEnv] 19x19 heuristic, {len(game_c)} moves, compiled == eager at every step; ms per "
          f"step: compiled {spread(ms_c[1:])} (first, with the capture, {ms_c[0]:.3f}), eager {spread(ms_e)}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sum(per_call)


def compiled_search_path(dev, states, bundle_lib, minmax_lib):
    """Phase 26: the compiled search (CUDA graphs of ``run_gumbel_mcts``,
    ``run_mcts`` + ``compact_subtree``, the self-play move and the match ply)
    against its eager form (``utils.graphs.eager``) in the same call, from
    phase 4's steady-state 19x19 ``states``.  Returns the bundle kernel's
    launches in (a)'s replayed searches."""
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core.actions import uniform_random_actions
    from gymgo_tpu_torch.native import NativeGoEngine
    from gymgo_tpu_torch.rl import treewalk
    from gymgo_tpu_torch.rl.evaluate import play_match, with_pass_to_win
    from gymgo_tpu_torch.rl.gumbel_mcts import make_gumbel_mcts_policy, run_gumbel_mcts
    from gymgo_tpu_torch.rl.selfplay import selfplay_gumbel_rollout
    from gymgo_tpu_torch.utils.graphs import compiled, eager
    from gymgo_tpu_torch.utils.gtp import make_net_genmove

    SIMS, CONSIDERED, B = 32, 16, 256
    t_phase = time.perf_counter()
    net16 = load_aznet_npz(NET_19, device=dev, dtype=torch.bfloat16)
    roots = states[:B].clone()
    kw = dict(num_simulations=SIMS, max_considered=CONSIDERED)

    def same(x, y):
        return all(torch.equal(p, q) for p, q in zip(x, y))

    def search(seed, form):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with form():
            return run_gumbel_mcts(gen, roots, net16, **kw)

    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # (a) cell 3: the compiled search against the eager one from the same seed, bit for bit, over the first
    # call (eager, then the capture) and two replays; launches, syncs, times, the device's busy share
    bundle_lib.launches = minmax_lib.launches = 0
    for i in range(3):
        if not same(search(SEED + 26 + i, contextlib.nullcontext), search(SEED + 26 + i, eager)):
            fail(f"26a: the compiled search differs from the eager one at call {i}")
    graph = run_gumbel_mcts.graphs[run_gumbel_mcts._call((torch.Generator(device=dev), roots, net16), kw).key]
    before = bundle_lib.launches
    search(SEED + 26, contextlib.nullcontext)
    replay_launches = bundle_lib.launches - before
    if replay_launches != 2 * SIMS or minmax_lib.launches:
        fail(f"26a: a replayed search launched the bundle kernel {replay_launches} times (expected {2 * SIMS}), "
             f"the min/max kernel {minmax_lib.launches}")
    with host_syncs() as caught:
        search(SEED + 26, contextlib.nullcontext)
    if caught:
        fail(f"26a: a replayed search made {len(caught)} host syncs: {caught[0].message}")
    times = {"compiled": [], "eager": []}
    for form in ("compiled", "eager", "eager", "compiled", "compiled", "eager"):
        ctx = contextlib.nullcontext if form == "compiled" else eager
        times[form].append(wall_s(lambda: search(SEED + 26, ctx)))
    prof = {}
    for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
        wall_us, rows = device_profile(lambda: search(SEED + 26, ctx))
        busy_us = sum(r[0] for r in rows)
        if busy_us <= 0:
            fail(f"26a: the profiler saw no device time in the {form} search")
        prof[form] = (wall_us / SIMS, busy_us / SIMS, 100 * busy_us / wall_us, sum(r[1] for r in rows) / SIMS)

    # the walk alone: the search's 32 walks (bounds 1..32, the forced root) on (B, 33) tables, one graph,
    # by CUDA events; a walk's work does not depend on the tables' values
    m = SIMS + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    j = torch.arange(m, device=dev)
    step = torch.randint(1, m, (B, m), generator=g, device=dev)
    nxt = torch.where(j + step < m, j + step, -1).to(torch.int32)
    best = torch.randint(0, 362, (B, m), generator=g, device=dev, dtype=torch.int32)
    keep = (nxt >= 0) & (torch.rand((B, m), generator=g, device=dev) < 0.9)
    f_act = torch.randint(0, 362, (B,), generator=g, device=dev)
    f_nxt, f_keep = nxt[:, 0], keep[:, 0]

    def walks(best, nxt, keep, f_act, f_nxt, f_keep):
        return torch.stack([treewalk.walk_paths(best, nxt, keep, m, forced_root=(f_act, f_nxt, f_keep),
                                                depth_bound=sim + 1)[0] for sim in range(SIMS)])

    walks_c = compiled(walks)
    walk_args = (best, nxt, keep, f_act, f_nxt, f_keep)
    if not torch.equal(walks_c(*walk_args), walks(*walk_args)):
        fail("26a: the walks' graph differs from the eager walks")
    walk_us = time_ms(lambda: walks_c(*walk_args), 20) * 1e3 / SIMS
    (walk_graph,) = walks_c.graphs.values()
    c_wall, c_busy, c_share, c_kernels = prof["compiled"]
    e_wall, e_busy, e_share, e_kernels = prof["eager"]
    ms_c, ms_e = min(times["compiled"]), min(times["eager"])
    print(f"[26a compiled search] 19x19 128x6 bfloat16, B={B}, Gumbel {SIMS}/{CONSIDERED}: compiled == eager bit "
          f"for bit over the first call and 2 replays (actions, improved policy, root value, visits, candidates); "
          f"a replay launches the bundle kernel {replay_launches} times (2 a simulation) and makes 0 host syncs; "
          f"compiled {1e3 * ms_c / SIMS:.3f} ms/simulation, {B / ms_c:.1f} searches/s (runs "
          f"{', '.join(f'{1e3 * t:.1f}' for t in times['compiled'])} ms); eager {1e3 * ms_e / SIMS:.3f} "
          f"ms/simulation, {B / ms_e:.1f} searches/s (runs {', '.join(f'{1e3 * t:.1f}' for t in times['eager'])} "
          f"ms); under the profiler, per simulation: compiled {c_wall:.1f} us wall, device busy {c_busy:.1f} us "
          f"({c_share:.1f}%), {c_kernels:.1f} kernels; eager {e_wall:.1f} us wall, busy {e_busy:.1f} us "
          f"({e_share:.1f}%), {e_kernels:.1f} kernels; graph {graph.nodes} nodes ({graph.nodes / SIMS:.1f} a "
          f"simulation), captured in {graph.capture_seconds:.3f} s; the walk alone {walk_us:.1f} us of device "
          f"time a simulation ({100 * walk_us / c_busy:.1f}% of the compiled simulation's busy time; "
          f"{walk_graph.nodes / SIMS:.1f} nodes a simulation)", flush=True)

    # (b) PUCT, 32 simulations, subtree reuse, over 4 genmoves and the opponent's replies: the compiled
    # mover against the eager one, moves and carried trees equal
    N19, KOMI = 19, 7.5
    movers = [make_net_genmove(str(NET_19), N19, 128, 6, simulations=SIMS, komi=KOMI, seed=SEED, search="puct",
                               device=dev) for _ in range(2)]
    forms = (contextlib.nullcontext, eager)
    referee, rng = NativeGoEngine(N19), np.random.default_rng(SEED + 26)
    state = np.zeros((6, N19, N19), np.int8)
    puct_ms = {"compiled": [], "eager": []}
    for i in range(4):
        moves = []
        for mover, ctx, form in zip(movers, forms, puct_ms):
            t0 = time.perf_counter()
            with ctx():
                moves.append(mover(state))
            puct_ms[form].append(1e3 * (time.perf_counter() - t0))
        if moves[0] != moves[1] or not same(movers[0]._tree, movers[1]._tree):
            fail(f"26b: the compiled PUCT mover differs from the eager one at genmove {i}: {moves}")
        legal = np.flatnonzero(state[3].reshape(-1) == 0)
        for action in (moves[0], int(rng.choice(legal[legal != moves[0]]))):
            for mover, ctx in zip(movers, forms):
                with ctx():
                    mover.on_move(action)
            state, status = referee.next_state(state, action)
            if status != 0:
                fail(f"26b: move {action} after genmove {i} is illegal")
        if not same(movers[0]._tree, movers[1]._tree):
            fail(f"26b: the carried trees differ after genmove {i}")
    print(f"[26b compiled PUCT genmove] 19x19 128x6 bfloat16, {SIMS} simulations, subtree reuse, 4 genmoves and "
          f"the replies: moves and carried trees equal to the eager mover's; ms per genmove compiled "
          f"{spread(puct_ms['compiled'][1:])} (the first, with the capture, {puct_ms['compiled'][0]:.1f}), eager "
          f"{spread(puct_ms['eager'])}", flush=True)

    # (c) cell 5's self-play window (envs 512, 8 moves, Gumbel 32/16): compiled (the first window captures,
    # the second replays every move) against eager, every row equal
    ENVS, STEPS = 512, 8
    cfg = EnvConfig(board_size=N19, batch_size=ENVS, auto_reset=True)
    start = states[:ENVS].clone()
    window_kw = dict(pass_min_stones=N19 * N19 // 2, **kw)

    def window(form):
        gen = torch.Generator(device=dev).manual_seed(SEED + 28)
        with form():
            return selfplay_gumbel_rollout(gen, start, net16, STEPS, cfg, **window_kw)

    window_s = {}
    results = {}
    for form, ctx in (("first", contextlib.nullcontext), ("eager", eager), ("replayed", contextlib.nullcontext)):
        t0 = time.perf_counter()
        results[form] = window(ctx)
        results[form][1].mask.any().item()
        window_s[form] = time.perf_counter() - t0
    for form in ("first", "replayed"):
        final, batch = results[form]
        if not (torch.equal(final, results["eager"][0]) and same(batch, results["eager"][1])):
            fail(f"26c: the {form} compiled self-play window differs from the eager one")
    print(f"[26c compiled self-play] 19x19 envs {ENVS}, {STEPS} moves, Gumbel {SIMS}/{CONSIDERED}: rows and final "
          f"states equal to the eager window's (the capturing window and a replayed one); "
          f"{window_s['replayed']:.3f} s a replayed window ({ENVS * STEPS / window_s['replayed']:.1f} env-steps/s), "
          f"{window_s['first']:.3f} s with the capture, {window_s['eager']:.3f} s eager "
          f"({ENVS * STEPS / window_s['eager']:.1f} env-steps/s)", flush=True)

    # (d) a 9x9 match of 16 games (the search with pass-to-win against the uniform sampler): compiled
    # plies against eager ones, tallies and final states equal
    net9 = load_aznet_npz(NET_9, device=dev, dtype=torch.bfloat16)
    policy = with_pass_to_win(make_gumbel_mcts_policy(net9, pass_min_stones=1 << 20, **kw))
    match_s, matches = {}, {}
    for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
        t0 = time.perf_counter()
        with ctx():
            matches[form] = play_match(torch.Generator(device=dev).manual_seed(SEED + 29), policy,
                                       uniform_random_actions, EnvConfig(board_size=9), num_games=16,
                                       max_steps=60, opening_moves=4, with_states=True, device=dev)
        match_s[form] = time.perf_counter() - t0
    (rc, sc), (re_, se) = matches["compiled"], matches["eager"]
    if not (torch.equal(sc, se) and same(rc, re_)):
        fail("26d: the compiled match differs from the eager one")
    print(f"[26d compiled match] 9x9 {NET_9.name} bfloat16, search {SIMS}/{CONSIDERED} with pass-to-win vs "
          f"uniform random, 16 games, 4 opening moves, cap 60: tallies and final states equal to the eager "
          f"match's ({json.dumps({k: v.item() for k, v in rc._asdict().items()})}); compiled "
          f"{match_s['compiled']:.2f} s (with 2 captures), eager {match_s['eager']:.2f} s", flush=True)

    # (e) one 19x19 genmove at B = 1 (cell 7), the Gumbel mover, compiled and eager
    gumbel_mover = make_net_genmove(str(NET_19), N19, 128, 6, simulations=SIMS, komi=KOMI, seed=SEED,
                                    search="gumbel", device=dev)
    genmove_ms, busy = {"compiled": [], "eager": []}, {}
    gumbel_mover(state)  # the capture
    for form in ("compiled", "eager", "eager", "compiled", "compiled", "eager"):
        ctx = contextlib.nullcontext if form == "compiled" else eager
        genmove_ms[form].append(1e3 * wall_s(lambda: _in(ctx, gumbel_mover, state)))
    for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
        wall_us, rows = device_profile(lambda: _in(ctx, gumbel_mover, state))
        busy[form] = 100 * sum(r[0] for r in rows) / wall_us
    print(f"[26e compiled genmove] 19x19 128x6 bfloat16, Gumbel {SIMS}/{CONSIDERED}, B=1: ms per genmove "
          f"compiled {spread(genmove_ms['compiled'])}, eager {spread(genmove_ms['eager'])}; device busy under "
          f"the profiler compiled {busy['compiled']:.1f}%, eager {busy['eager']:.1f}%; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return replay_launches


@contextlib.contextmanager
def no_host_sync():
    """Raise at any synchronizing CUDA call inside the block (PyTorch's sync
    debug mode, set to error)."""
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def minmax_compiled_path(dev, states, libs):
    """Phase 27: the claim flood kernel and the minmax route compiled (CUDA
    graphs; the claim kernel keeps its flood on the card), from phase 4's
    steady-state 19x19 B = 12288 ``states``.  ``libs`` are the bundle,
    min/max and claim kernels' libraries.  Sets the minmax route and leaves
    the default one.  Returns the claim kernel's numbers: its check, its
    times and bound, and the launches of each kernel on each path."""
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.core import flood as tflood
    from gymgo_tpu_torch.core.flood import claim_flood_plain
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
    from gymgo_tpu_torch.ops import claim_flood as cf
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts
    from gymgo_tpu_torch.utils.graphs import eager

    t_phase = time.perf_counter()
    fields = ("actions", "rewards", "dones", "invalid", "final_states")
    B, N, WINDOW, REPEATS = states.shape[0], states.shape[-1], 64, 3
    counts = functools.partial(kernel_counts, libs)
    launched = functools.partial(kernels_launched, libs)

    def same(x, y, what):
        for field in fields:
            if not torch.equal(getattr(x, field), getattr(y, field)):
                fail(f"27: {what} differs on {field}")

    # (a) the kernel against its plain version, bit for bit on every cell: random boards at N = 5 ... 32,
    # the shaped boards and odd batches of phases 3 and 8, phase 4's steady-state boards; then timed
    a, b = boards_of(states)
    cases = board_cases(dev, torch.Generator(device=dev).manual_seed(SEED + 27), (5, 9, 19, 22, 23, 25, 32),
                        (19, 22, 25, 32))
    cases.append((f"steady 19x19 B={B}", a, b))
    before = counts()
    err = 0
    for name, ca, cb in cases:
        k = cf.claim_flood_cuda(ca, cb)
        p = claim_flood_plain(ca, cb)
        torch.cuda.synchronize()
        err = max(err, int((k.to(torch.int32) - p.to(torch.int32)).abs().max()))
        if not torch.equal(k, p):
            fail(f"27a: claim kernel != plain on {name}: {int((k != p).sum())} cells differ")
    kernel_ms = time_ms(lambda: cf.claim_flood_cuda(a, b), 200)
    plain_ms = time_ms(lambda: claim_flood_plain(a, b), 5)
    kernel_ms_2 = time_ms(lambda: cf.claim_flood_cuda(a, b), 200)
    restore_counts(libs, before)
    # 2 bytes in (two uint8 planes), 1 out (one uint8 plane) per cell
    bound_ms = (2 + 1) * B * N * N / H100_BYTES_PER_S * 1e3
    print(f"[27a claim kernel vs plain] {len(cases)} cases bit-exact on every cell (max |diff| {err}); 19x19 "
          f"B={B} steady state: kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f}), plain {plain_ms:.4f} ms, "
          f"byte bound {bound_ms:.6f} ms ({(2 + 1) * B * N * N} bytes at 3.35 TB/s)", flush=True)

    previous = tflood.set_flood_route("unrolled")
    try:
        # (b) cell 2: the minmax route's compiled window against its eager form from the same seed, bit for bit,
        # over the first call and two replays; the launches of all three kernels; no host sync in a replay;
        # env-steps/s of both forms in turns; the device's busy share of each
        cfg = EnvConfig(board_size=N, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
        env = BatchGoEnv(cfg, device=dev)
        if not env.compiled:
            fail("27b: BatchGoEnv is not compiled on the minmax route on the card")
        gc, ge = (torch.Generator(device=dev).manual_seed(SEED + 270) for _ in range(2))
        s, window_launches = states, []
        for i in range(3):
            before = counts()
            got = env.rollout(gc, s, WINDOW)
            window_launches.append(launched(before))
            with eager():
                want = env.rollout(ge, s, WINDOW)
            same(got, want, f"27b: the minmax route's compiled window at call {i}")
            s = got.final_states
        expected = {"bundle": 0, "minmax": WINDOW + 1, "claim": WINDOW}
        if any(x != expected for x in window_launches):
            fail(f"27b: launches a compiled window {window_launches}, expected {expected}")
        if not torch.equal(gc.get_state(), ge.get_state()):
            fail("27b: the compiled window left its generator elsewhere than the eager one")
        (graph,) = env._rollout.graphs.values()
        with no_host_sync():
            env.rollout(gc, s, WINDOW)
        torch.cuda.synchronize()  # the replay's device work ends before the first timed window starts
        rates = {"compiled": [], "eager": []}
        for _ in range(REPEATS):
            for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
                t0 = time.perf_counter()
                r = _in(ctx, env.rollout, gc, s, WINDOW)
                checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
                rates[form].append(B * WINDOW / (time.perf_counter() - t0))
                if not math.isfinite(checksum):
                    fail(f"27b: checksum not finite: {checksum}")
        for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
            wall_us, rows = device_profile(lambda: _in(ctx, env.rollout, gc, s, WINDOW))
            busy_us = sum(r[0] for r in rows)
            if busy_us <= 0:
                fail(f"27b: the profiler saw no device time in the {form} window")
            print(f"[27b minmax route compiled] 19x19 B={B}, {WINDOW}-step windows, {form}: {rates_text(rates[form])}; "
                  f"profiled {wall_us / WINDOW:.1f} us/step wall, device busy {busy_us / WINDOW:.1f} us/step "
                  f"({100 * busy_us / wall_us:.1f}% busy), {sum(r[1] for r in rows) / WINDOW:.1f} kernels/step",
                  flush=True)
        print(f"[27b minmax route compiled] == eager bit for bit over a first call and 2 replays (actions, rewards, "
              f"dones, invalid, final states, the generator); launches a window {window_launches[-1]}; 0 host syncs "
              f"in a replay (sync debug mode error); graph {graph.nodes} nodes ({graph.nodes / WINDOW:.1f} a step), "
              f"captured in {graph.capture_seconds:.3f} s", flush=True)

        # (c) cell 3 on the minmax route: the compiled Gumbel search against the eager one, bit for bit over the
        # first call and a replay; launches and no host sync in a replay; ms per simulation of both forms
        SIMS, CONSIDERED, SB = 32, 16, 256
        net16 = load_aznet_npz(NET_19, device=dev, dtype=torch.bfloat16)
        roots = states[:SB].clone()

        def search(seed, ctx):
            with ctx():
                return run_gumbel_mcts(torch.Generator(device=dev).manual_seed(seed), roots, net16,
                                       num_simulations=SIMS, max_considered=CONSIDERED)

        for i in range(2):
            got, want = search(SEED + 271 + i, contextlib.nullcontext), search(SEED + 271 + i, eager)
            if not all(torch.equal(p, q) for p, q in zip(got, want)):
                fail(f"27c: the compiled search on the minmax route differs from the eager one at call {i}")
        before = counts()
        with no_host_sync():
            search(SEED + 271, contextlib.nullcontext)
        search_launches = launched(before)
        expected = {"bundle": 0, "minmax": 2 * SIMS, "claim": SIMS}
        if search_launches != expected:
            fail(f"27c: launches a replayed search {search_launches}, expected {expected}")
        search_ms = {}
        for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager), ("compiled", contextlib.nullcontext)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(SEED + 271, ctx)
            torch.cuda.synchronize()
            search_ms.setdefault(form, []).append(1e3 * (time.perf_counter() - t0) / SIMS)
        print(f"[27c minmax route compiled search] 19x19 128x6 bfloat16, B={SB}, Gumbel {SIMS}/{CONSIDERED}: compiled "
              f"== eager bit for bit over the first call and a replay; a replay launches {search_launches}, 0 host "
              f"syncs; ms/simulation compiled {min(search_ms['compiled']):.3f} "
              f"({SB / (SIMS * min(search_ms['compiled']) / 1e3):.1f} searches/s), eager {search_ms['eager'][0]:.3f}",
              flush=True)

        # (d) 25x25, which the bundle word cannot hold: B = 4096 compiled windows (the first from fresh boards
        # captures, the second replays) against the eager window, bit for bit; a B = 64 slice replayed on the CPU
        N25, B25, W25 = 25, 4096, 64
        cfg25 = EnvConfig(board_size=N25, batch_size=B25, reward_method=HEURISTIC, auto_reset=True)
        env25 = BatchGoEnv(cfg25, device=dev)
        if not env25.compiled:
            fail("27d: BatchGoEnv is not compiled at 25x25 on the minmax route")
        g25 = torch.Generator(device=dev).manual_seed(SEED + 272)
        t0 = time.perf_counter()
        first = env25.rollout(g25, batch_init_state(B25, N25, device=dev), W25)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        start = first.final_states
        ge25 = torch.Generator(device=dev).manual_seed(SEED + 273)
        g25.manual_seed(SEED + 273)
        before = counts()
        t0 = time.perf_counter()
        with no_host_sync():
            got = env25.rollout(g25, start, W25)
        got.rewards.sum().item()
        replay_s = time.perf_counter() - t0
        launches25 = launched(before)
        t0 = time.perf_counter()
        with eager():
            want = env25.rollout(ge25, start, W25)
        want.rewards.sum().item()
        eager_s = time.perf_counter() - t0
        same(got, want, "27d: the 25x25 compiled window")
        expected = {"bundle": 0, "minmax": W25 + 1, "claim": W25}
        if launches25 != expected:
            fail(f"27d: launches a replayed 25x25 window {launches25}, expected {expected}")
        acts = iter(got.actions[:, :64].cpu())
        cpu = rollout(torch.Generator(), start[:64].cpu(), W25, EnvConfig(board_size=N25, batch_size=64,
                      reward_method=HEURISTIC, auto_reset=True), policy_fn=lambda _g, _s: next(acts))
        rows = {"final_states": got.final_states[:64], "rewards": got.rewards[:, :64], "dones": got.dones[:, :64]}
        for field, x in rows.items():
            if not torch.equal(x.cpu(), getattr(cpu, field)):
                fail(f"27d: the 25x25 window's first 64 envs differ from the CPU replay on {field}")
        if got.invalid.any() or not (got.rewards != 0).any():
            fail("27d: an invalid action, or no reward read from the claimed areas, in the 25x25 window")
        print(f"[27d 25x25 compiled] B={B25}, {W25}-step windows on the minmax route: a replay == eager bit for bit "
              f"(0 host syncs, launches {launches25}), its first 64 envs == the CPU replay; first window (eager, then "
              f"the capture) {first_s:.2f} s, a replay {replay_s:.3f} s ({B25 * W25 / replay_s:.1f} env-steps/s), "
              f"eager {eager_s:.3f} s ({B25 * W25 / eager_s:.1f} env-steps/s); phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        tflood.set_flood_route(previous)
    return {
        "max_abs_err": err, "ms": min(kernel_ms, kernel_ms_2), "plain_ms": plain_ms, "bound_ms": bound_ms,
        "window": window_launches[-1], "search": search_launches, "window_25x25": launches25,
    }


def big_boards_path(dev, libs):
    """Phase 28: boards over 32x32 on the minmax route, which the min/max and
    claim kernels label a block a board up to 181x181.  ``libs`` are the
    bundle, min/max and claim kernels' libraries.  Sets the minmax route and
    leaves the default one.  Returns each kernel's check, times, bounds and
    plain times at 64x64 B = 1024 and 181x181 B = 128, and the launches of
    each path."""
    from gymgo_tpu_torch import gogame
    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core import flood as tflood
    from gymgo_tpu_torch.core import score as tscore
    from gymgo_tpu_torch.core.flood import claim_flood_plain, minmax_flood_plain
    from gymgo_tpu_torch.env import GoEnv
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
    from gymgo_tpu_torch.ops import claim_flood as cf
    from gymgo_tpu_torch.ops import minmax_flood as mf
    from gymgo_tpu_torch.utils.graphs import eager

    t_phase = time.perf_counter()
    fields = ("actions", "rewards", "dones", "invalid", "final_states")
    counts = functools.partial(kernel_counts, libs)
    launched = functools.partial(kernels_launched, libs)

    # (a) both kernels against their plain versions, bit for bit on every cell: random boards on both sides
    # of where a board's int32 arrays stop fitting in a block's shared memory (133/134 for the min/max
    # flood, 160/161 for the claim flood on an H100; 124/125 and 145/146 with a place table beside them),
    # up to 181x181, 301 a size (more than the 132 boards an H100 labels at once at 181x181); the shaped
    # boards (the longest runs and chains, which the plain versions take thousands of rounds over) at four
    # of the sizes (the card tests take them at all); odd batches at 181
    SIZES = (33, 37, 45, 63, 64, 65, 100, 124, 125, 133, 134, 145, 146, 160, 161, 181)
    cases = board_cases(dev, torch.Generator(device=dev).manual_seed(SEED + 28), SIZES, (33, 64, 134, 181),
                        odd=181, batch=301)
    before = counts()
    err = {"minmax": 0, "claim": 0}
    t0 = time.perf_counter()
    for name, ca, cb in cases:
        kmn, kmx = mf.minmax_flood_cuda(ca, cb)
        kc = cf.claim_flood_cuda(ca, cb)
        pmn, pmx = minmax_flood_plain(ca, cb)
        pc = claim_flood_plain(ca, cb)
        torch.cuda.synchronize()
        for k, p in ((kmn, pmn), (kmx, pmx)):
            err["minmax"] = max(err["minmax"], int((k.to(torch.int32) - p.to(torch.int32)).abs().max()))
        err["claim"] = max(err["claim"], int((kc.to(torch.int32) - pc.to(torch.int32)).abs().max()))
        if not (torch.equal(kmn, pmn) and torch.equal(kmx, pmx)):
            fail(f"28a: minmax kernel != plain on {name}: {int(((kmn != pmn) | (kmx != pmx)).sum())} cells differ")
        if not torch.equal(kc, pc):
            fail(f"28a: claim kernel != plain on {name}: {int((kc != pc).sum())} cells differ")
    restore_counts(libs, before)
    print(f"[28a big-board kernels vs plain] {len(cases)} cases at N = {', '.join(map(str, SIZES))}: min/max and "
          f"claim kernels bit-exact on every cell (max |diff| {err}); {time.perf_counter() - t0:.1f} s", flush=True)

    out = {"max_abs_err": err}
    previous = tflood.set_flood_route("unrolled")
    try:
        # (b) 64x64 B = 1024 (cell 10) and (c) 181x181 B = 128: the compiled window from fresh boards (the first
        # call runs eagerly and captures), replays to warm up, then two replays against the eager window from the
        # same boards and seed, bit for bit, with no host sync in a replay; a slice replayed on the CPU; both
        # forms timed in turns and profiled; both kernels timed on the last boards
        for tag, N, B, W, WARM, SLICE in (("28b", 64, 1024, 64, 1024, 16), ("28c", 181, 128, 16, 512, 2)):
            t_size = time.perf_counter()
            cfg = EnvConfig(board_size=N, batch_size=B, reward_method=HEURISTIC, auto_reset=True)
            env = BatchGoEnv(cfg, device=dev)
            if not env.compiled:
                fail(f"{tag}: BatchGoEnv is not compiled at {N}x{N} on the minmax route")
            g = torch.Generator(device=dev).manual_seed(SEED + 280 + N)
            t0 = time.perf_counter()
            s = env.rollout(g, env.reset(), W).final_states
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(WARM // W - 1):
                s = env.rollout(g, s, W).final_states
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            gc, ge = (torch.Generator(device=dev).manual_seed(SEED + 281 + N) for _ in range(2))
            window_launches = []
            for i in range(2):
                start = s
                before = counts()
                with no_host_sync():
                    got = env.rollout(gc, start, W)
                window_launches.append(launched(before))
                with eager():
                    want = env.rollout(ge, start, W)
                for field in fields:
                    if not torch.equal(getattr(got, field), getattr(want, field)):
                        fail(f"{tag}: the {N}x{N} compiled window differs from the eager one on {field} at replay {i}")
                s = got.final_states
            expected = {"bundle": 0, "minmax": W + 1, "claim": W}
            if any(x != expected for x in window_launches):
                fail(f"{tag}: launches a replayed {N}x{N} window {window_launches}, expected {expected}")
            if not torch.equal(gc.get_state(), ge.get_state()):
                fail(f"{tag}: the compiled window left its generator elsewhere than the eager one")
            if got.invalid.any() or not (got.rewards != 0).any():
                fail(f"{tag}: an invalid action, or no reward read from the claimed areas, in the {N}x{N} window")
            acts = iter(got.actions[:, :SLICE].cpu())
            cpu = rollout(torch.Generator(), start[:SLICE].cpu(), W, EnvConfig(board_size=N, batch_size=SLICE,
                          reward_method=HEURISTIC, auto_reset=True), policy_fn=lambda _g, _s: next(acts))
            rows = {"final_states": got.final_states[:SLICE], "rewards": got.rewards[:, :SLICE],
                    "dones": got.dones[:, :SLICE]}
            for field, x in rows.items():
                if not torch.equal(x.cpu(), getattr(cpu, field)):
                    fail(f"{tag}: the {N}x{N} window's first {SLICE} envs differ from the CPU replay on {field}")
            torch.cuda.synchronize()
            rates = {"compiled": [], "eager": []}
            for _ in range(3):
                for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
                    t0 = time.perf_counter()
                    r = _in(ctx, env.rollout, gc, s, W)
                    checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
                    rates[form].append(B * W / (time.perf_counter() - t0))
                    if not math.isfinite(checksum):
                        fail(f"{tag}: checksum not finite: {checksum}")
            busy = {}
            for form, ctx in (("compiled", contextlib.nullcontext), ("eager", eager)):
                wall_us, rows = device_profile(lambda: _in(ctx, env.rollout, gc, s, W))
                busy_us = sum(r[0] for r in rows)
                if busy_us <= 0:
                    fail(f"{tag}: the profiler saw no device time in the {form} window")
                busy[form] = (wall_us / W, busy_us / W, 100 * busy_us / wall_us, sum(r[1] for r in rows) / W)
            stones = s[:, :2].to(torch.int32).sum().item() / B
            for form in ("compiled", "eager"):
                wall, dev_us, share, kernels = busy[form]
                print(f"[{tag} {N}x{N} minmax route] B={B}, {W}-step windows, {form}: {rates_text(rates[form])}; "
                      f"profiled {wall:.1f} us/step wall, device busy {dev_us:.1f} us/step ({share:.1f}% busy), "
                      f"{kernels:.1f} kernels/step", flush=True)

            # the two kernels on the window's last boards, by CUDA events, beside their byte bounds
            a, b = boards_of(s)
            before = counts()
            mm = [time_ms(lambda: mf.minmax_flood_cuda(a, b), 100)]
            cl = [time_ms(lambda: cf.claim_flood_cuda(a, b), 100)]
            mm_plain = time_ms(lambda: minmax_flood_plain(a, b), 3)
            cl_plain = time_ms(lambda: claim_flood_plain(a, b), 3)
            mm.append(time_ms(lambda: mf.minmax_flood_cuda(a, b), 100))
            cl.append(time_ms(lambda: cf.claim_flood_cuda(a, b), 100))
            restore_counts(libs, before)
            kmn, kmx = mf.minmax_flood_cuda(a, b)
            pmn, pmx = minmax_flood_plain(a, b)
            if not (torch.equal(kmn, pmn) and torch.equal(kmx, pmx) and torch.equal(cf.claim_flood_cuda(a, b),
                                                                                    claim_flood_plain(a, b))):
                fail(f"{tag}: a kernel != plain on the {N}x{N} window's boards")
            cells = B * N * N
            # 2 bytes in (two uint8 planes) per cell; 4 out (two int16 planes) for min/max, 1 (uint8) for claims
            mm_bound, cl_bound = (2 + 4) * cells / H100_BYTES_PER_S * 1e3, (2 + 1) * cells / H100_BYTES_PER_S * 1e3
            print(f"[{tag} {N}x{N} kernels] B={B} ({cells} cells, {stones:.1f} stones a board): min/max kernel "
                  f"{mm[0]:.4f} ms (again {mm[1]:.4f}), plain {mm_plain:.4f} ms, byte bound {mm_bound:.6f} ms; claim "
                  f"kernel {cl[0]:.4f} ms (again {cl[1]:.4f}), plain {cl_plain:.4f} ms, byte bound {cl_bound:.6f} ms",
                  flush=True)
            (graph,) = env._rollout.graphs.values()
            print(f"[{tag} {N}x{N} compiled] == eager bit for bit over 2 replays (actions, rewards, dones, invalid, "
                  f"final states, the generator), 0 host syncs in a replay (sync debug mode error), launches a window "
                  f"{window_launches[-1]}; its first {SLICE} envs == the CPU replay; first window (eager, then the "
                  f"capture) {first_s:.2f} s, {WARM - W} warmup steps replayed in {warm_s:.2f} s; graph {graph.nodes} "
                  f"nodes; {time.perf_counter() - t_size:.1f} s", flush=True)
            out[N] = {"minmax_ms": min(mm), "minmax_plain_ms": mm_plain, "minmax_bound_ms": mm_bound,
                      "claim_ms": min(cl), "claim_plain_ms": cl_plain, "claim_bound_ms": cl_bound,
                      "window": window_launches[-1]}

            # the area score of the window's boards on the card against the CPU (a slice at 181: the CPU's
            # flood by rounds crosses the board's empty region)
            k = B if N <= 64 else 8
            for got_area, want_area in zip(tscore.areas(s), tscore.areas(s[:k].cpu())):
                if not torch.equal(got_area[:k].cpu(), want_area):
                    fail(f"{tag}: score.areas at {N}x{N}: the card and the CPU differ")

        # (d) GoEnv and gogame at 37x37 on the card (compiled, a stateless step a move) against the CPU
        MOVES = 300
        t0 = time.perf_counter()
        np.random.seed(SEED + 28)
        before = counts()
        envs = [GoEnv(37, reward_method="heuristic", backend="torch", device=dev),
                GoEnv(37, reward_method="heuristic", backend="torch", device="cpu")]
        env_moves = 0
        for t in range(MOVES):
            act = envs[0].uniform_random_action()
            (obs, reward, done, info), (o, r, d, i) = (e.step(act) for e in envs)
            env_moves += 1
            if not (np.array_equal(o, obs) and r == reward and d == done
                    and np.array_equal(i["invalid_moves"], info["invalid_moves"])):
                fail(f"28d: GoEnv 37x37 on the card differs from the CPU at move {t}")
            if done:
                break
        env_launches = launched(before)
        before = counts()
        state = gogame.init_state(37)
        for t in range(MOVES):
            act = gogame.random_action(state)
            card = gogame.next_state(state, act, device=dev)
            if not np.array_equal(card, gogame.next_state(state, act, device="cpu")):
                fail(f"28d: gogame.next_state at 37x37: the card and the CPU differ at move {t}")
            state = card
        gogame_launches = launched(before)
        if env_launches["minmax"] < 2 * env_moves or gogame_launches["minmax"] < 2 * MOVES or \
                env_launches["bundle"] or gogame_launches["bundle"]:
            fail(f"28d: launches GoEnv {env_launches}, gogame {gogame_launches}")
        print(f"[28d 37x37] GoEnv (torch on the card, compiled) == torch on the CPU over {env_moves} moves, "
              f"launches {env_launches}; gogame.next_state == CPU over {MOVES} moves, launches {gogame_launches}; "
              f"score.areas at 64x64 and 181x181 == CPU; {time.perf_counter() - t0:.1f} s; phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        out.update(go_env=env_launches, gogame=gogame_launches)
    finally:
        tflood.set_flood_route(previous)
    return out


def group_norm_path(dev, lib):
    """Phase 29: the served net's fused GroupNorm kernel (``lib``, its
    library) against its plain version and timed at the 20-block net's
    shapes; the 20-block net's launches a forward and its served forward
    against the library's.  Returns the kernel's numbers by case
    (``b256``, ``b256_residual``, ``b1``, ``b1_residual``) and the launches
    a forward by batch."""
    from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
    from gymgo_tpu_torch.ops import group_norm_act as gna

    N, C, GROUPS, EPS, CALLS = 19, 256, 8, 1e-6, 39  # CALLS: the norms of a 20-block evaluation
    t_phase = time.perf_counter()
    out = {"cases": {}}
    # (a) the kernel against its plain version on the same channels-last tensors, then timed
    for B in (256, 1):
        g = torch.Generator(device=dev).manual_seed(SEED + 29 + B)
        # a convolution's output: a per-channel offset and scale
        h = (torch.randn(B, C, N, N, device=dev, generator=g) * (0.5 + torch.rand(C, 1, 1, device=dev, generator=g))
             + torch.randn(C, 1, 1, device=dev, generator=g)).bfloat16()
        res = torch.randn(B, C, N, N, device=dev, generator=g).bfloat16()
        weight = (1 + 0.1 * torch.randn(C, device=dev, generator=g)).bfloat16()
        bias = (0.1 * torch.randn(C, device=dev, generator=g)).bfloat16()
        h_cl, res_cl = (t.contiguous(memory_format=torch.channels_last) for t in (h, res))
        act_bytes = h.numel() * h.element_size()
        for r, r_cl in ((None, None), (res, res_cl)):
            key = f"b{B}" + ("" if r is None else "_residual")
            lib.launches = 0
            got = gna.group_norm_act_cuda(h_cl, GROUPS, weight, bias, EPS, r_cl)
            if lib.launches != 1:
                fail(f"29a {key}: {lib.launches} launches for one call")
            want = gna.group_norm_act_plain(h_cl, GROUPS, weight, bias, EPS, r_cl)
            # 1 ulp of bfloat16 at each element's magnitude: the output's, or the residual's where it is larger
            scale = want.float().abs() if r is None else torch.maximum(want.float().abs(), r.float().abs())
            ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(scale.clamp_min(1.0))))
            off = (got.float() - want.float()).abs()
            ulps = float((off / ulp).max())
            unequal = float((got != want).float().mean())
            if not got.is_contiguous(memory_format=torch.channels_last) or ulps > 1:
                fail(f"29a {key}: the kernel is {ulps} ulps from the plain version (unequal share {unequal})")
            if not torch.equal(gna.group_norm_act_cuda(h_cl, GROUPS, weight, bias, EPS, r_cl), got):
                fail(f"29a {key}: two calls of the kernel differ")
            ms = [graphed_ms(lambda: gna.group_norm_act_cuda(h_cl, GROUPS, weight, bias, EPS, r_cl), CALLS, 50)
                  for _ in range(2)]
            plain_ms = graphed_ms(lambda: gna.group_norm_act_plain(h_cl, GROUPS, weight, bias, EPS, r_cl), CALLS, 10)
            library_ms = graphed_ms(lambda: gna.group_norm_act_plain(h, GROUPS, weight, bias, EPS, r), CALLS, 10)
            passes = 2 if r is None else 3  # x read and y written, and the residual read
            bound_ms = passes * act_bytes / H100_BYTES_PER_S * 1e3
            out["cases"][key] = {"ms": min(ms), "ms_again": max(ms), "plain_ms": plain_ms,
                                 "library_ms": library_ms, "bound_ms": bound_ms, "bytes": passes * act_bytes,
                                 "max_abs_err": float(off.max()), "max_ulps": ulps, "unequal_share": unequal}
            print(f"[29a group norm {key}] 19x19 C={C} bf16 channels-last: kernel within {ulps:.0f} ulp of the "
                  f"plain version (max |diff| {float(off.max())}, unequal share {unequal:.3e}); graphs of {CALLS} "
                  f"calls, ms a call: kernel {ms[0]:.5f} (again {ms[1]:.5f}), plain version (NHWC) {plain_ms:.5f}, "
                  f"library (NCHW group_norm, relu{'' if r is None else ', add'}) {library_ms:.5f}, byte bound "
                  f"{bound_ms:.6f} ({passes * act_bytes} bytes at 3.35 TB/s)", flush=True)
        del h, res, h_cl, res_cl

    # (b) the 20-block net as the benchmark builds it: launches a forward, served against the library
    cfg = AZNetConfig(board_size=N, channels=C, blocks=19, policy_channels=2, value_channels=1)
    with torch.device("meta"):
        net = AZNet(cfg)
    net = net.to_empty(device=dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, device=dev, generator=g) * p[0].numel() ** -0.5)
            else:
                p.copy_(1 + 0.1 * torch.randn(p.shape, device=dev, generator=g) if name.endswith("norm.weight")
                        else 0.1 * torch.randn(p.shape, device=dev, generator=g))
    if not all(m.weight.is_contiguous(memory_format=torch.channels_last)
               for m in net.modules() if isinstance(m, torch.nn.Conv2d)):
        fail("29b: the served net's convolution kernels are not channels-last")
    before = AZNet(cfg, torch.bfloat16).to(dev).eval().requires_grad_(False)  # contiguous kernels, as before
    before.load_state_dict(net.state_dict())

    def library_forward(x):
        with torch.enable_grad():  # autograd on: the library's NCHW operations
            return before(x)

    states = torch.randint(0, 2, (256, 6, N, N), generator=g, device=dev, dtype=torch.int64).to(torch.int8)
    out["launches"] = {}
    with torch.no_grad():
        for B in (256, 1):
            x = states[:B].clone()
            net(x)  # cuDNN's choice of algorithms
            torch.cuda.synchronize()
            lib.launches = 0
            logits, value = net(x)
            out["launches"][B] = lib.launches
            if lib.launches != CALLS:
                fail(f"29b: the 20-block forward at B = {B} launched the norm kernel {lib.launches} times, "
                     f"expected {CALLS}")
            lib_logits, lib_value = library_forward(x)
            if lib.launches != CALLS:
                fail("29b: the library's forward launched the norm kernel")
            gap = float((logits - lib_logits).abs().max()) / float(lib_logits.max() - lib_logits.min())
            value_gap = float((value - lib_value).abs().max())
            if gap > 0.02 or value_gap > 0.02:
                fail(f"29b: served and library forwards differ at B = {B}: logits {gap} of their range, "
                     f"value {value_gap}")
            served_ms = graphed_ms(lambda: net(x), 1, 20)
            library_ms = graphed_ms(lambda: library_forward(x), 1, 20)
            out[f"forward_b{B}"] = {"served_ms": served_ms, "library_ms": library_ms}
            print(f"[29b 20-block net B={B}] built on meta, to_empty, copy_: kernels channels-last; {CALLS} norm "
                  f"launches a forward; served against the library's NCHW forward: logits {gap:.4f} of their "
                  f"range, value {value_gap:.4f}; graphed forward {served_ms:.4f} ms served, {library_ms:.4f} ms "
                  f"library", flush=True)
    print(f"[29 group norm] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def kernel_counts(libs):
    """The launch counts of the bundle, min/max and claim libraries ``libs``,
    by name."""
    return {name: lib.launches for name, lib in zip(("bundle", "minmax", "claim"), libs)}


def kernels_launched(libs, before):
    """The launches of each of ``libs`` since ``kernel_counts`` gave ``before``."""
    return {name: n - before[name] for name, n in kernel_counts(libs).items()}


def restore_counts(libs, before):
    """Set ``libs``' counts back to ``before``: the launches in between only
    held a kernel against its plain version or timed it."""
    for lib, n in zip(libs, before.values()):
        lib.launches = n


def _in(ctx, fn, *args):
    with ctx():
        return fn(*args)


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
    from gymgo_tpu_torch.ops import claim_flood as cf
    from gymgo_tpu_torch.ops import group_norm_act as gna
    from gymgo_tpu_torch.ops import minmax_flood as mf

    tflood.set_flood_route("bitpack")  # phases 3-7 run the default route

    t_main = time.perf_counter()
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
    libs = (bf.BUNDLE_FLOOD, mf.MINMAX_FLOOD)  # the kernels phases 12-26 count
    built = libs + (cf.CLAIM_FLOOD, gna.GROUP_NORM_ACT)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(built)) as ex:
        list(ex.map(lambda lib: lib.function(), built))
    build_s = time.perf_counter() - t0
    for lib in built:
        ptxas = " | ".join(l.split(":", 1)[-1].strip() for l in lib.build_log.splitlines()
                           if "spill" in l or ("ptxas info" in l and "Used" in l))
        if re.search(r"[1-9][0-9]* bytes spill", ptxas):
            fail(f"{lib.source.name} spills registers: {ptxas}")
        print(f"[2 build] {lib.source.name} built and loaded in {lib.build_seconds:.2f} s "
              f"(all {len(built)}: {build_s:.2f} s); {ptxas}", flush=True)

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
    bf.BUNDLE_FLOOD.launches = mf.MINMAX_FLOOD.launches = cf.CLAIM_FLOOD.launches = 0
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
    if minmax_on_default != 0 or cf.CLAIM_FLOOD.launches != 0:
        fail(f"minmax flood launched {minmax_on_default} times, claim flood {cf.CLAIM_FLOOD.launches} times, "
             f"on the default route")
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
    bf.BUNDLE_FLOOD.launches = mf.MINMAX_FLOOD.launches = cf.CLAIM_FLOOD.launches = 0
    rates9, runs9, starts9 = timed_windows(rollout, gen9, states, cfg, WINDOW, REPEATS)
    mm_launches, bundle_on_minmax = mf.MINMAX_FLOOD.launches, bf.BUNDLE_FLOOD.launches
    claim_launches = cf.CLAIM_FLOOD.launches
    if mm_launches != REPEATS * (WINDOW + 1):
        fail(f"minmax flood launched {mm_launches} times on the minmax route, "
             f"expected {REPEATS * (WINDOW + 1)}")
    if claim_launches != REPEATS * WINDOW:
        fail(f"claim flood launched {claim_launches} times on the minmax route, expected {REPEATS * WINDOW}")
    if bundle_on_minmax != 0:
        fail(f"bundle flood launched {bundle_on_minmax} times on the minmax route")
    if any(int(x.invalid.sum()) for x in runs9):
        fail("a step flagged an invalid action on the minmax route")
    print(f"[9 minmax route] 19x19 B={B}: {rates_text(rates9)}; games finished "
          f"{int(sum(x.dones.sum() for x in runs9))}; minmax kernel launches {mm_launches}, "
          f"claim kernel launches {claim_launches}, bundle kernel launches {bundle_on_minmax}", flush=True)

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

    seconds = {"1-11": time.perf_counter() - t_main}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    play_launches, play_minmax_launches = phase("12-14", play_path, dev, states, *libs)
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, train_minmax_launches = phase("15-16", train_path, dev, states, *libs, Path(workdir))

    gogame_launches, gogame_minmax = phase("17", gogame_path, dev, states, *libs)
    env_launches, env_minmax = phase("18", go_env_path, dev, *libs)
    bench_records = phase("19", benches)
    gtp_launches, gtp_minmax = phase("20", gtp_path, dev, *libs)
    with tempfile.TemporaryDirectory() as workdir:
        phase("21", tools, Path(workdir))
    with tempfile.TemporaryDirectory() as workdir:
        sharded_launches, _ = phase("22", sharding_path, dev, states, *libs, Path(workdir))
    soak_launches = phase("23", soak)
    ablation_launches = phase("24a", ablation_path, dev, states, *libs)
    layout_launches = phase("24b", layouts_path, dev, states, *libs)
    study_launches = phase("24c", studies)
    compiled_launches = phase("25", compiled_path, dev, states, *libs)
    compiled_search_launches = phase("26", compiled_search_path, dev, states, *libs)
    claim = phase("27", minmax_compiled_path, dev, states, built)
    big = phase("28", big_boards_path, dev, built)
    norm = phase("29", group_norm_path, dev, gna.GROUP_NORM_ACT)
    print(f"[seconds] each phase's: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"{time.perf_counter() - t_main:.1f} s in all", flush=True)

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
        "launches_sharded": {f"{k} shards": n for k, n in sharded_launches.items()},
        "launches_soak": soak_launches,
        "launches_ablations": ablation_launches,
        "launches_layouts": layout_launches,
        "launches_studies": study_launches,
        "launches_compiled": compiled_launches,
        "launches_compiled_search": compiled_search_launches,
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
        "launches_compiled_minmax_window": claim["window"]["minmax"],
        "launches_compiled_minmax_search": claim["search"]["minmax"],
        "launches_compiled_25x25_window": claim["window_25x25"]["minmax"],
        "launches_compiled_64x64_window": big[64]["window"]["minmax"],
        "launches_compiled_181x181_window": big[181]["window"]["minmax"],
        "launches_go_env_37x37": big["go_env"]["minmax"],
        "launches_gogame_37x37": big["gogame"]["minmax"],
        "max_abs_err": mm_err,
        "max_abs_err_over_32x32": big["max_abs_err"]["minmax"],
        "ms": min(mm_ms, mm_ms_2),
        "plain_ms": mm_plain_ms,
        # 2 bytes in (two uint8 planes), 4 out (two int16 planes) per cell
        "bound_ms": bound_ms,
        "ms_64x64": big[64]["minmax_ms"],
        "plain_ms_64x64": big[64]["minmax_plain_ms"],
        "bound_ms_64x64": big[64]["minmax_bound_ms"],
        "ms_181x181": big[181]["minmax_ms"],
        "plain_ms_181x181": big[181]["minmax_plain_ms"],
        "bound_ms_181x181": big[181]["minmax_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "claim_flood",
        "route": "cuda",
        "source": "gymgo_tpu_torch/csrc/claim_flood.cu",
        "replaces": "gymgo_tpu/core/flood.py:190 (flood_or_unrolled, an XLA while_loop; no Pallas kernel)",
        # the minmax route's compiled window (27b), the slice's main path
        "launches": claim["window"]["claim"],
        "launches_minmax_route_eager": claim_launches,
        "launches_compiled_minmax_search": claim["search"]["claim"],
        "launches_compiled_25x25_window": claim["window_25x25"]["claim"],
        "launches_compiled_64x64_window": big[64]["window"]["claim"],
        "launches_compiled_181x181_window": big[181]["window"]["claim"],
        "launches_go_env_37x37": big["go_env"]["claim"],
        "launches_gogame_37x37": big["gogame"]["claim"],
        "max_abs_err": claim["max_abs_err"],
        "max_abs_err_over_32x32": big["max_abs_err"]["claim"],
        "ms": claim["ms"],
        "plain_ms": claim["plain_ms"],
        # 2 bytes in (two uint8 planes), 1 out (one uint8 plane) per cell
        "bound_ms": claim["bound_ms"],
        "ms_64x64": big[64]["claim_ms"],
        "plain_ms_64x64": big[64]["claim_plain_ms"],
        "bound_ms_64x64": big[64]["claim_bound_ms"],
        "ms_181x181": big[181]["claim_ms"],
        "plain_ms_181x181": big[181]["claim_plain_ms"],
        "bound_ms_181x181": big[181]["claim_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "group_norm_act",
        "route": "cuda",
        "source": "gymgo_tpu_torch/csrc/group_norm_act.cu",
        "replaces": "none: the counterpart of XLA's fusion of GroupNorm, relu and the residual add "
                    "(gymgo_tpu/models/az_net.py, ResBlock)",
        # a 20-block evaluation (29b); the cases are 19x19, C = 256, bfloat16, in graphs of 39 calls (29a)
        "launches": norm["launches"][256],
        "launches_b1": norm["launches"][1],
        "max_abs_err": max(c["max_abs_err"] for c in norm["cases"].values()),
        "max_ulps": max(c["max_ulps"] for c in norm["cases"].values()),
        "unequal_share": {k: c["unequal_share"] for k, c in norm["cases"].items()},
        "ms": norm["cases"]["b256"]["ms"],
        "plain_ms": norm["cases"]["b256"]["plain_ms"],
        # x read and y written once (2 bytes each per element), and the residual read
        "bound_ms": norm["cases"]["b256"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": norm["cases"]["b256"]["library_ms"],
        **{f"{field}_{key}": c[field] for key, c in norm["cases"].items() if key != "b256"
           for field in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "forward_ms": {f"{k}_{f}": v for k, fw in norm.items() if k.startswith("forward_") for f, v in fw.items()},
    }]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
