"""Batched Gumbel search as a self-play actor runs it: ``run_gumbel_mcts``
over ``batch`` roots (one CUDA graph a search on the card), its chosen moves
played by ``BatchGoEnv.step`` (auto-reset), search after search, each ending
on a fetch of its checksum.

Set-up makes mid-game roots by ``root_steps`` uniform-random compiled
windows from the empty board, then runs two moves (the first captures the
search's and the step's graphs) and plays on for ``settle_s`` seconds
(``Context.settle``); the reference follows every move, these too.  The root
noise is drawn by the benchmark from the seed and handed to the search
(``gumbel=``).  The traffic's parameters: ``batch``, ``root_steps``,
``simulations``, ``considered``, ``c_visit``, ``c_scale``, ``komi`` (the
search's and the env's), ``settle_s``, ``trace_searches``, ``sampled_games``
(the games the reference follows from the empty board) and ``net_roots``
(the roots of those games at which it evaluates the network).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import Outcome
from portbench.lib import trace as _trace
from portbench.lib import weights as _weights
from portbench.drivers.env_window import record, to_host
from portbench.reference import judge


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, float32, -log(-log(u)) with u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def run(ctx) -> Outcome:
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv
    from gymgo_tpu_torch.rl import gumbel_mcts

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, n = tr["batch"], cfg["board_size"]
    net, weights = _weights.program_net(cfg, ctx.seed, dev)
    env = BatchGoEnv(EnvConfig(board_size=n, komi=tr["komi"], reward_method=cfg["reward_method"],
                               batch_size=batch, auto_reset=True), device=dev)
    gen_env, gen_noise = ctx.generator("sampler"), ctx.generator("noise")
    rng = ctx.rng("host")
    games = torch.as_tensor(np.sort(rng.choice(batch, size=min(tr["sampled_games"], batch), replace=False)),
                            device=dev)
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    moves = []

    ctx.note("net and env made")
    states = env.reset()
    setup_windows = []
    for steps in tr["root_steps"]:
        r = env.rollout(gen_env, states, steps)
        setup_windows.append(record(states, r, games))
        states = r.final_states

    def move(roots):
        g = gumbel(gen_noise, (batch, n * n + 1), dev)
        with _trace.span("search"):
            res = gumbel_mcts.run_gumbel_mcts(gen_noise, roots, net, num_simulations=tr["simulations"],
                                              max_considered=tr["considered"], c_visit=tr["c_visit"],
                                              c_scale=tr["c_scale"], komi=tr["komi"], gumbel=g)
        with _trace.span("env_step"):
            _, st = env.step(roots, res.actions)
        moves.append({"root": roots[games], "gumbel": g[games], "actions": res.actions[games],
                      "policy": res.improved_policy[games], "visits": res.root_visits[games],
                      "next": st.obs[games], "reward": st.reward[games], "done": st.done[games],
                      "invalid": st.invalid_action[games]})
        failed.add_(st.invalid_action.sum())
        with _trace.span("checksum"):
            (res.root_value.sum() + st.reward.sum()).item()
        return st.obs

    ctx.note("roots made")
    for i in range(2):
        states = move(states)
        ctx.note(f"move {i} searched")
    held = {"states": states}
    ctx.settle(lambda: held.update(states=move(held["states"])))
    states = held["states"]
    failed.zero_()
    ctx.setup_done()

    searches, ends = 0, []
    t0 = time.perf_counter()
    while True:
        states = move(states)
        searches += 1
        ends.append(time.perf_counter())
        elapsed = ends[-1] - t0
        if elapsed >= ctx.seconds:
            break
    ctx.spread("searches", list(np.diff([t0] + ends)))
    host = {"moves": batch * searches, "window_s": elapsed}
    traced = None
    if ctx.trace:
        with _trace.traced(dev) as holder:
            for _ in range(tr["trace_searches"]):
                states = move(states)
            holder["units"] = tr["trace_searches"]
        traced = holder["trace"]
    peak = ctx.window_closed()
    attempted = batch * (searches + (tr["trace_searches"] if ctx.trace else 0))
    failures = int(failed.item())
    setup_windows = [to_host(w) for w in setup_windows]
    moves = [to_host(m) for m in moves]
    del net, env, states
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge.search_chain(setup_windows, moves, weights, tr, tr["komi"], cfg["reward_method"],
                                  ctx.rng("judge"))
    return Outcome(host, attempted, failures, peak, readings, traced)
