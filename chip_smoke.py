"""Drive gymgo_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: nvcc builds the bundle-flood kernel from ``gymgo_tpu_torch/csrc``;
  3. kernel vs plain: the kernel's int32 word equals the plain PyTorch
     version's bit for bit, on random boards at N = 5, 9, 19, 22, on serpentine
     and staircase boards, and on steady-state 19x19 boards from a rollout;
  4. main path: ``rollout`` at 19x19, B = 12288, heuristic reward, auto-reset,
     uniform sampler: a 768-step warmup, then 5 timed windows of 64 steps, each
     ending on a scalar checksum fetch; the kernel's launch count must grow by
     exactly one per step plus one seeding call per rollout;
  5. replay: a 19x19, B = 256, 200-step rollout on the card, from steady-state
     boards of phase 4, is replayed with its actions on the CPU plain path;
     states, rewards and dones must agree;
  6. timing: the kernel against the plain version at B = 12288 on the
     steady-state boards of phase 4, with CUDA events, beside the byte bound;
  7. profile: torch.profiler over 16 main-path steps: device time by kernel
     and the device's busy share of the wall time.

The line before the last is a JSON object with the kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero
without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SEED = 0


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


def boards_of(states):
    """(mover, opp) contiguous bool planes of int8 states, by side to move."""
    wtm = states[:, 2, 0, 0].bool()[:, None, None]
    black, white = states[:, 0].bool(), states[:, 1].bool()
    return (torch.where(wtm, white, black).contiguous(),
            torch.where(wtm, black, white).contiguous())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1

    from gymgo_tpu_torch.config import HEURISTIC, EnvConfig
    from gymgo_tpu_torch.core.flood import bundle_flood_plain
    from gymgo_tpu_torch.core.state import batch_init_state
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.ops import bundle_flood as bf

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

    # 2. build
    t0 = time.perf_counter()
    bf.build()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(l.strip() for l in bf.BUNDLE_FLOOD.build_log.splitlines() if "ptxas info" in l)
    print(f"[2 build] bundle_flood.cu built and loaded in {build_s:.2f} s; {ptxas}", flush=True)

    # 3. kernel against its plain version, bit for bit
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for n in (5, 9, 19, 22):
        r = torch.rand((1237, n, n), generator=gen, device=dev)
        dens = torch.rand((1237, 1, 1), generator=gen, device=dev) * 0.9
        a = r < dens / 2
        b = (r >= dens / 2) & (r < dens)
        cases.append((f"random N={n} B=1237", a.contiguous(), b.contiguous()))
    for maker in (serpentine, staircase):
        for n in (19, 22):
            mask = maker(n).to(dev)
            none = torch.zeros_like(mask)
            stack = lambda *xs: torch.stack(xs).contiguous()
            cases.append((f"{maker.__name__} N={n}",
                          stack(mask, none, ~mask, mask),
                          stack(none, mask, none, ~mask & (torch.arange(n * n, device=dev).view(n, n) % 3 == 0))))
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
    bf.BUNDLE_FLOOD.launches = 0
    t0 = time.perf_counter()
    r = rollout(gen, states, WARMUP, cfg)
    states = r.final_states
    n_invalid = r.invalid.sum()
    n_games = r.dones.sum()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        r = rollout(gen, states, WINDOW, cfg)
        checksum = (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
        dt = time.perf_counter() - t0
        rates.append(B * WINDOW / dt)
        states = r.final_states
        n_invalid = n_invalid + r.invalid.sum()
        n_games = n_games + r.dones.sum()
    launches = bf.BUNDLE_FLOOD.launches
    expected = (WARMUP + 1) + REPEATS * (WINDOW + 1)
    if launches != expected:
        fail(f"bundle flood launched {launches} times on the main path, expected {expected}")
    if int(n_invalid) != 0:
        fail(f"{int(n_invalid)} steps flagged an invalid action on the main path")
    if not math.isfinite(checksum):
        fail(f"checksum not finite: {checksum}")
    stones = states[:, :2].to(torch.int32).sum().item() / B
    med = statistics.median(rates)
    print(f"[4 main path] 19x19 B={B}: warmup {WARMUP} steps {warm_s:.2f} s; "
          f"env-steps/s median {med:.1f} min {min(rates):.1f} max {max(rates):.1f} "
          f"(runs {', '.join(f'{x:.1f}' for x in rates)}); games finished {int(n_games)}; "
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

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    launches_before = bf.BUNDLE_FLOOD.launches
    kernel_ms = time_ms(lambda: bf.bundle_flood_cuda(a, b), 50)
    plain_ms = time_ms(lambda: bundle_flood_plain(a, b), 5)
    kernel_ms_2 = time_ms(lambda: bf.bundle_flood_cuda(a, b), 50)
    bf.BUNDLE_FLOOD.launches = launches_before
    if not torch.equal(bf.bundle_flood_cuda(a, b), bundle_flood_plain(a, b)):
        fail("kernel != plain on the main path's steady-state boards")
    bound_ms = (2 + 4) * B * N * N / H100_BYTES_PER_S * 1e3
    print(f"[6 timing] bundle flood 19x19 B={B} steady state: kernel {kernel_ms:.4f} ms "
          f"(again {kernel_ms_2:.4f}), plain {plain_ms:.4f} ms, byte bound {bound_ms:.4f} ms "
          f"({(2 + 4) * B * N * N} bytes at 3.35 TB/s)", flush=True)

    # 7. profile of the main path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    PROF_STEPS = 16
    rollout(gen, states, 4, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(gen, states, PROF_STEPS, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only: an aten op's row repeats the time of its kernels
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us > 0:
        top = "; ".join(f"{k[:60]} {us / PROF_STEPS:.1f} us/step x{c // PROF_STEPS}" for us, c, k in rows[:8])
        print(f"[7 profile] 19x19 B={B}, {PROF_STEPS} steps: wall {wall_us / PROF_STEPS:.1f} us/step, "
              f"device busy {busy_us / PROF_STEPS:.1f} us/step ({100 * busy_us / wall_us:.1f}% busy), "
              f"{sum(r[1] for r in rows) / PROF_STEPS:.1f} kernel launches/step; top: {top}", flush=True)
    else:
        print(f"[7 profile] device time not visible to torch.profiler (not measured); "
              f"wall {wall_us / PROF_STEPS:.1f} us/step", flush=True)

    print(json.dumps({"kernels": [{
        "name": "bundle_flood",
        "route": "cuda",
        "source": "gymgo_tpu_torch/csrc/bundle_flood.cu",
        "replaces": "gymgo_tpu/ops/pallas_flood.py:163",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
