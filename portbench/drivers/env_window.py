"""Batched random self-play: ``BatchGoEnv.rollout``'s compiled window of
``window_steps`` steps over ``batch`` games, windows back to back, each ending
on a fetch of its checksum, as a consumer of trajectories would.

Set-up plays ``warmup_steps`` in such windows from the empty board (the first
captures the window's CUDA graph), so the window sees mid- and late-game
boards, then plays on for ``settle_s`` seconds (``Context.settle``).  The
traffic's parameters: ``batch``, ``window_steps``, ``warmup_steps``,
``settle_s``, ``trace_windows`` (windows under the profiler in a traced
run), ``sampled_games`` and ``kept_windows`` (what the reference replays).

The reference replays, for ``sampled_games`` games drawn from the seed, the
first window of the run (from the empty board) and ``kept_windows`` windows
drawn from the seed among all later ones (from the state the program handed
over).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import Outcome
from portbench.lib import trace as _trace
from portbench.reference import judge


class Reservoir:
    """Keeps ``k`` windows drawn uniformly from a stream of unknown length;
    whether a window is kept is known before it runs."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k, self.seen, self.items = rng, k, 0, []

    def slot(self):
        """The slot the next window goes to, or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.k else None


def record(start, r, games, from_empty: bool = False) -> dict:
    """The sampled games' part of a window (device tensors)."""
    return {"start": start[games], "actions": r.actions[:, games], "rewards": r.rewards[:, games],
            "dones": r.dones[:, games], "invalid": r.invalid[:, games], "final": r.final_states[games],
            "from_empty": from_empty}


def to_host(rec: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in rec.items()}


def run(ctx) -> Outcome:
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, steps = tr["batch"], tr["window_steps"]
    env = BatchGoEnv(EnvConfig(board_size=cfg["board_size"], komi=cfg["komi"], reward_method=cfg["reward_method"],
                               batch_size=batch, auto_reset=True), device=dev)
    gen = ctx.generator("sampler")
    rng = ctx.rng("host")
    games = torch.as_tensor(np.sort(rng.choice(batch, size=min(tr["sampled_games"], batch), replace=False)),
                            device=dev)
    kept = Reservoir(rng, tr["kept_windows"])
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    state = {"states": env.reset()}

    def window(slot=None, first=False):
        start = state["states"]
        with _trace.span("rollout"):
            r = env.rollout(gen, start, steps)
        if first or slot is not None:
            rec = record(start, r, games, from_empty=first)
            if slot is not None:
                kept.items[slot] = rec
        failed.add_(r.invalid.sum())
        with _trace.span("checksum"):
            (r.final_states.to(torch.int32).sum() + r.rewards.sum()).item()
        state["states"] = r.final_states
        return rec if first else None

    ctx.note("env made")
    first = window(first=True)
    ctx.note("first window captured")
    for _ in range(tr["warmup_steps"] // steps - 1):
        window()
    ctx.settle(window)
    failed.zero_()
    ctx.setup_done()

    windows, ends = 0, []
    t0 = time.perf_counter()
    while True:
        window(kept.slot())
        windows += 1
        ends.append(time.perf_counter())
        elapsed = ends[-1] - t0
        if elapsed >= ctx.seconds:
            break
    ctx.spread("windows", list(np.diff([t0] + ends)))
    host = {"env_steps": batch * steps * windows, "window_s": elapsed}
    traced = None
    if ctx.trace:
        with _trace.traced(dev) as holder:
            for _ in range(tr["trace_windows"]):
                window(kept.slot())
            holder["units"] = tr["trace_windows"] * steps
        traced = holder["trace"]
    peak = ctx.window_closed()
    attempted = batch * steps * (windows + (tr["trace_windows"] if ctx.trace else 0))
    failures = int(failed.item())
    records = [to_host(first)] + [to_host(w) for w in kept.items if w is not None]
    del env, state, kept, first
    readings = judge.env_windows(records, cfg["komi"], cfg["reward_method"])
    return Outcome(host, attempted, failures, peak, readings, traced)
