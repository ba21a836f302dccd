"""Idle time inside a replayed CUDA graph, with and without the profiler.

Under ``torch.profiler`` (CUPTI) the card runs a replayed graph's short
kernels further apart than it does untraced, so the idle that a trace shows
between one replay's operations (``portbench``'s ``env_node_gap_us_per_step``
and ``genmove_node_gap_ms``) holds the profiler's cost beside the card's
own.  This measures both for the graphs the benchmark's cells replay: the
64-step rollout window of ``go19`` at B = 12288 and 512, and the Gumbel
search (32 simulations, 16 considered) of the ``agz20`` network at B = 256
and 1.

For each graph: one call of its compiled function captures it; its graph
is replayed for ``--settle`` seconds (a process's replays start with each
node slower and drop to their pace once); then

- untraced: CUDA events around replays queued back to back for about
  ``--seconds`` seconds, three times: the card's time a replay, its
  operations and the gaps between them (and the short gap from one replay
  to the next);
- traced: ``--traced`` replays under ``torch.profiler``: each replay's
  operations (by its launch's correlation id), their summed time, and the
  idle between its first and last operation.

The untraced gap of a replay is its untraced time (the fastest of the three)
less the traced operations' summed time.

    python -m gymgo_tpu_torch.scripts.replay_gaps [--graphs rollout_b12288,rollout_b512,search_b256,search_b1]
        [--settle 15] [--seconds 3] [--traced 3]

Runs on the card only.  Prints one JSON object a graph.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

__all__ = ["replay_split", "main"]

GRAPHS = ("rollout_b12288", "rollout_b512", "search_b256", "search_b1")


def replay_split(ops) -> tuple:
    """``(busy_ns, idle_ns)`` of one replay's operations ``(start_ns, end_ns)``:
    their summed time, and the time between the first's start and the last's
    end that none of them ran."""
    busy = idle = 0
    reach = None
    for start, end in sorted(ops):
        busy += end - start
        if reach is not None:
            idle += max(0, start - reach)
        reach = end if reach is None else max(reach, end)
    return busy, idle


def _captured(name: str, dev):
    """``(graph, units)``: the captured graph of ``name`` and the units of
    work a replay does (steps, simulations)."""
    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv
    from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
    from gymgo_tpu_torch.rl import gumbel_mcts

    kind, batch = name.split("_b")
    batch = int(batch)
    if kind == "rollout":
        env = BatchGoEnv(EnvConfig(board_size=19, batch_size=batch, auto_reset=True, reward_method="heuristic"),
                         device=dev)
        env.rollout(env.generator(0), env.reset(), 64)
        return next(iter(env._rollout.graphs.values())), 64
    cfg = AZNetConfig(board_size=19, channels=256, blocks=19, policy_channels=2, value_channels=1,
                      dtype=torch.bfloat16)
    # the served module's bfloat16 parameters, as the benchmark's network holds them; their values do
    # not change the graph
    net = AZNet(cfg).to(dev).eval().requires_grad_(False)
    states = BatchGoEnv(EnvConfig(board_size=19, batch_size=batch), device=dev).reset()
    gen = torch.Generator(device=dev).manual_seed(0)
    gumbel = -torch.log(-torch.log(torch.rand((batch, 19 * 19 + 1), generator=gen, device=dev)))
    before = set(gumbel_mcts.run_gumbel_mcts.graphs)
    gumbel_mcts.run_gumbel_mcts(gen, states, net, num_simulations=32, max_considered=16, gumbel=gumbel)
    key = (set(gumbel_mcts.run_gumbel_mcts.graphs) - before).pop()
    return gumbel_mcts.run_gumbel_mcts.graphs[key], 32


def _untraced_ms(graph, seconds: float) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    reps = max(3, int(seconds * 1e3 / start.elapsed_time(end)))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _traced(graph, replays: int) -> list:
    """``(busy_ns, idle_ns, ops)`` of each traced replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = [e.correlation_id() for e in events if e.name() == "cudaGraphLaunch"]
    by_launch = {c: [] for c in launches}
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.correlation_id() in by_launch and not e.is_user_annotation():
            by_launch[e.correlation_id()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return [replay_split(ops) + (len(ops),) for ops in by_launch.values()]


def measure(name: str, dev, settle: float, seconds: float, replays: int) -> dict:
    captured, units = _captured(name, dev)
    graph = captured.graph
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < settle:
        graph.replay()
        torch.cuda.synchronize()
    untraced = [_untraced_ms(graph, seconds) for _ in range(3)]
    traced = _traced(graph, replays)
    busy = sum(b for b, _, _ in traced) / len(traced) / 1e6
    idle = sum(i for _, i, _ in traced) / len(traced) / 1e6
    ops = traced[0][2]
    gap = min(untraced) - busy
    return {"graph": name, "nodes": captured.nodes, "ops": ops, "units": units,
            "untraced_ms": untraced, "traced_busy_ms": busy, "traced_gap_ms": idle,
            "untraced_gap_ms": gap, "traced_gap_us_per_op": idle * 1e3 / max(1, ops - 1),
            "untraced_gap_us_per_op": gap * 1e3 / max(1, ops - 1),
            "traced_gap_per_unit_ms": idle / units, "untraced_gap_per_unit_ms": gap / units}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--graphs", default=",".join(GRAPHS))
    p.add_argument("--settle", type=float, default=15.0)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--traced", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("replay_gaps needs a CUDA card")
    dev = torch.device("cuda")
    for name in args.graphs.split(","):
        if name not in GRAPHS:
            raise SystemExit(f"unknown graph {name!r}: one of {', '.join(GRAPHS)}")
        print(json.dumps(measure(name, dev, args.settle, args.seconds, args.traced)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
