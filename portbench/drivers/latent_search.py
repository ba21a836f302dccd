"""Batched Gumbel MuZero as a self-play actor with a learned model runs it:
``run_gumbel_mcts`` over ``batch`` roots with a ``MuZeroNet`` (its own
dynamics inside the tree, one CUDA graph a search on the card), the chosen
moves played by ``BatchGoEnv.step`` (auto-reset), search after search, each
ending on a fetch of its checksum.

``batched_search.py``'s loop, with its noise: set-up makes mid-game roots by
``root_steps`` uniform-random compiled windows from the empty board, runs
two moves (the first captures the search's and the step's graphs) and plays
on for ``settle_s`` seconds; the reference follows every move of
``sampled_games`` games, these too, with each of their search trees.  Each
search also hands back one sampled game's stored hidden states (the games
taken in turn); the trees of ``net_roots`` moves, drawn uniformly from all
the run's moves as they come (a reservoir), keep them for the judge, which
checks each node one step from its parent's stored state.  The traffic's
parameters are ``batched_search.py``'s.  The judge is
``reference/muzero_judge.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.batched_search import gumbel
from portbench.drivers.env_window import record, to_host
from portbench.harness import Outcome
from portbench.lib import muzero_weights
from portbench.lib import trace as _trace
from portbench.reference import muzero_judge


def run(ctx) -> Outcome:
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv
    from gymgo_tpu_torch.rl import gumbel_mcts

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    batch, n = tr["batch"], cfg["board_size"]
    net, weights = muzero_weights.program_net(cfg, ctx.seed, dev)  # a program without MuZeroNet stops here
    env = BatchGoEnv(EnvConfig(board_size=n, komi=tr["komi"], reward_method=cfg["reward_method"],
                               batch_size=batch, auto_reset=True), device=dev)
    gen_env, gen_noise = ctx.generator("sampler"), ctx.generator("noise")
    rng = ctx.rng("host")
    games = torch.as_tensor(np.sort(rng.choice(batch, size=min(tr["sampled_games"], batch), replace=False)),
                            device=dev)
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    moves, with_tree, pick = [], [], ctx.rng("trees")

    def keep_tree(rec, latents):
        """Keep this move's tree for the judge if the reservoir draws it."""
        if len(with_tree) < tr["net_roots"]:
            with_tree.append(rec)
        else:
            j = int(pick.integers(0, len(moves)))
            if j >= len(with_tree):
                return
            del with_tree[j]["latents"]
            with_tree[j] = rec
        rec["latents"] = latents

    ctx.note("net and env made")
    states = env.reset()
    setup_windows = []
    for steps in tr["root_steps"]:
        r = env.rollout(gen_env, states, steps)
        setup_windows.append(record(states, r, games))
        states = r.final_states

    def move(roots):
        g = gumbel(gen_noise, (batch, n * n + 1), dev)
        at = len(moves) % len(games)
        with _trace.span("search"):
            res = gumbel_mcts.run_gumbel_mcts(gen_noise, roots, net, num_simulations=tr["simulations"],
                                              max_considered=tr["considered"], c_visit=tr["c_visit"],
                                              c_scale=tr["c_scale"], komi=tr["komi"], gumbel=g,
                                              latent_rows=games[at:at + 1])
        with _trace.span("env_step"):
            _, st = env.step(roots, res.actions)
        moves.append({"root": roots[games], "gumbel": g[games], "actions": res.actions[games],
                      "policy": res.improved_policy[games], "visits": res.root_visits[games],
                      "node_parent": res.node_parent[games], "node_action": res.node_action[games],
                      "node_value": res.node_value[games], "node_logits": res.node_logits[games],
                      "next": st.obs[games], "reward": st.reward[games], "done": st.done[games],
                      "invalid": st.invalid_action[games], "latent_game": at})
        keep_tree(moves[-1], res.node_latents[0])
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
    for rec in with_tree:
        rec["latents"] = rec["latents"].to("cpu", torch.float32)
    moves = [to_host(m) for m in moves]
    del net, env, states
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = muzero_judge.search_chain(setup_windows, moves, weights, tr, tr["komi"], cfg["reward_method"])
    return Outcome(host, attempted, failures, peak, readings, traced)
