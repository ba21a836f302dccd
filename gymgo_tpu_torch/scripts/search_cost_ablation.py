"""Per-component cost of one search simulation (counterpart of the JAX
package's ``scripts/search_cost_ablation.py``).

One Gumbel or PUCT simulation at (B, N x N) pays for: the selection tables and
walk, one exact env step (``step_states``), one net evaluation of the new
leaves (``masked_policy``: canonical form, valid moves, the net), the node
writes, the parent-row gather, and the backup scatter-add.  This times each
piece alone, so that optimisation goes where the milliseconds are.

Each component runs ``--sims`` iterations of an eager Python loop whose
inputs depend on the previous iteration (a carried accumulator perturbs
them), as the JAX script's ``fori_loop`` does, and ends on one scalar fetch,
which waits for the device.  Eager PyTorch has no ``fori_loop``: every
iteration is launched from the host, kernel by kernel, so "per simulation"
here is the host's dispatch of one iteration's launches plus whatever
device time they take beyond it, which is what a simulation of the port's
search pays when it runs eagerly (``run_gumbel_mcts.fn``; on the card the
package replays a whole search as one CUDA graph, which ``chip_smoke.py``
phase 26 times).  The selection walk runs the ``i + 1`` depths the search's
walk runs at simulation ``i``.  The time of an empty loop of the same trip count that ends on
the same fetch (the call's fixed cost, the JAX script's null loop) is
subtracted.  Each component is the best of 5 runs after one warm-up run, by
the host's clock and, on the card, by CUDA events around the loop; on the
card it also prints each iteration's kernel launches (``torch.profiler``) and
bundle-kernel launches (the kernel's own count).

    python -m gymgo_tpu_torch.scripts.search_cost_ablation [--board 19
        --batch 256 --sims 32 --channels 8 --blocks 1] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without one.
The last line is one JSON object with every component's numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

__all__ = ["main"]

REPEATS = 5


def _kernel_launches(fn, iterations):
    """Device kernels launched per iteration by one run of ``fn`` (CUDA
    only), from ``torch.profiler``; the device-side images of the program's
    layer spans (``gymgo.*``) are no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gymgo_tpu_torch.utils.tracing import PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and not ev.key.startswith(PREFIX)) / iterations


def timed(fn, dev):
    """Best of ``REPEATS`` runs of ``fn`` (which ends on a scalar fetch) after
    one warm-up run: (host seconds, device seconds by CUDA events or None)."""
    fn()
    best_host = best_dev = float("inf")
    for _ in range(REPEATS):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        fn()
        best_host = min(best_host, time.perf_counter() - t0)
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            best_dev = min(best_dev, start.elapsed_time(end) / 1e3)
    return best_host, (best_dev if dev.type == "cuda" else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.search_cost_ablation",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=32)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.core import actions as _actions
    from gymgo_tpu_torch.core import step as _step
    from gymgo_tpu_torch.core import transform as _transform
    from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
    from gymgo_tpu_torch.env.batch_env import rollout
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
    from gymgo_tpu_torch.ops import bundle_flood as _bundle
    from gymgo_tpu_torch.rl import treewalk as _treewalk

    dev = resolve_device(args.device)
    n, b, sims = args.board, args.batch, args.sims
    m, a = sims + 1, n * n + 1
    net = init_params(torch.Generator(device=dev).manual_seed(0),
                      AZNetConfig(board_size=n, channels=args.channels, blocks=args.blocks))
    cfg = EnvConfig(board_size=n, batch_size=b, auto_reset=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    states = batch_init_state(b, n, device=dev)
    for _ in range(2):
        states = rollout(gen, states, 64, cfg).final_states
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} B={b} board={n} net={args.channels}ch x{args.blocks} sims/loop={sims}", flush=True)

    def null_loop():
        acc = torch.zeros((), device=dev)
        for _ in range(sims):
            pass
        return acc.item()

    overhead, overhead_dev = timed(null_loop, dev)
    print(f"call overhead (null loop): {overhead * 1e3:6.1f} ms", flush=True)
    rows = []

    def report(label, fn):
        host, device_s = timed(fn, dev)
        per = (host - overhead) / sims
        row = {"component": label, "ms_per_sim": per * 1e3, "loop_ms": host * 1e3}
        text = f"{label:<26}{per * 1e3:7.3f} ms/sim   (x{sims} = {(host - overhead) * 1e3:6.1f} ms + overhead)"
        if device_s is not None:
            before = _bundle.BUNDLE_FLOOD.launches
            fn()
            row["bundle_launches_per_sim"] = (_bundle.BUNDLE_FLOOD.launches - before) / sims
            row["events_ms_per_sim"] = (device_s - overhead_dev) / sims * 1e3
            row["launches_per_sim"] = _kernel_launches(fn, sims)
            text += (f"; CUDA events {row['events_ms_per_sim']:7.3f} ms/sim; {row['launches_per_sim']:.1f} "
                     f"kernel launches/sim, {row['bundle_launches_per_sim']:.1f} of the bundle kernel")
        print(text, flush=True)
        rows.append(row)

    # 1. env step: the states feed back each iteration
    def env_loop():
        s, acc = states, torch.zeros((), dtype=torch.int64, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        for _ in range(sims):
            s, info = _step.step_states(s, _actions.uniform_random_actions(g, s))
            acc = acc + info.num_captured.sum()
        return acc.item()

    report("step_states", env_loop)

    # 2. masked_policy: one cell perturbed per iteration
    def policy_loop():
        s, acc = states.clone(), torch.zeros((), device=dev)
        for i in range(sims):
            s[:, 0, 0, 0] = i % 2
            logits, value = net(_transform.batch_canonical_form(s))
            valid = _actions.batch_valid_moves(s) > 0
            probs = torch.softmax(torch.where(valid, logits, -torch.inf), dim=-1)
            acc = acc + value.sum() + probs[0, 0]
        return acc.item()

    with torch.no_grad():
        report("masked_policy (net)", policy_loop)

    # 3. selection tables + walk over a random tree
    g2 = torch.Generator(device=dev).manual_seed(2)
    scores0 = torch.rand((b, m, a), generator=g2, device=dev)
    child = torch.where(torch.rand((b, m, a), generator=g2, device=dev) < 0.05,
                        torch.randint(0, m, (b, m, a), generator=g2, device=dev), -1).to(torch.int32)
    node_done = torch.zeros((b, m), dtype=torch.bool, device=dev)

    def select_loop():
        scores, acc = scores0.clone(), torch.zeros((), device=dev)
        for i in range(sims):
            scores[:, 0, 0] = acc % 1.0
            # the iterations the search's walk runs at simulation i
            depth, _path_n, _path_a = _treewalk.walk_paths(*_treewalk.node_tables(scores, child, node_done), m,
                                                           depth_bound=i + 1)
            acc = acc + depth.sum().to(torch.float32) * 1e-6
        return acc.item()

    report("selection (tables+walk)", select_loop)

    # 4. node write set: a states row and a prior row
    node_states0 = torch.zeros((b, m, 6, n, n), dtype=torch.int8, device=dev)
    prior0 = torch.zeros((b, m, a), dtype=torch.float32, device=dev)

    def write_loop():
        ns, pr = node_states0.clone(), prior0.clone()
        acc = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(sims):
            slot = i % m
            ns[:, slot] = states + acc.to(torch.int8)
            pr[:, slot] = acc.to(torch.float32)
            acc = acc + 1
        return (ns[0, 0, 0, 0, 0].to(torch.float32) + pr[0, 0, 0]).item()

    report("node write (state+prior)", write_loop)

    # 5. parent state gather (the expansion's input), its index carried
    bidx = torch.arange(b, device=dev)
    parent0 = torch.randint(0, m, (b,), generator=g2, device=dev)

    def read_loop():
        p, acc = parent0, torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(sims):
            s = node_states0[bidx, p]
            acc = acc + s[:, 0, 0, 0].sum()
            p = (p + 1) % m
        return acc.item()

    report("node row gather", read_loop)

    # 6. backup scatter-add along random paths
    path_n = torch.randint(0, m, (b, m), generator=g2, device=dev)
    path_a = torch.randint(0, a, (b, m), generator=g2, device=dev)
    depth = torch.randint(1, m, (b,), generator=g2, device=dev)
    on = torch.arange(m, device=dev) < depth[:, None]
    index = (bidx[:, None].expand(b, m), torch.where(on, path_n, 0), torch.where(on, path_a, 0))

    def backup_loop():
        visit = torch.zeros((b, m, a), dtype=torch.int32, device=dev)
        wsum = torch.zeros((b, m, a), dtype=torch.float32, device=dev)
        for _ in range(sims):
            v = 1.0 + wsum[:, 0, 0]
            visit.index_put_(index, on.to(torch.int32), accumulate=True)
            wsum.index_put_(index, torch.where(on, v[:, None], 0.0), accumulate=True)
        return wsum[:, 0].sum().item()

    report("backup scatter-add", backup_loop)
    print(json.dumps({"board": n, "batch": b, "sims": sims, "channels": args.channels, "blocks": args.blocks,
                      "device": name, "overhead_ms": overhead * 1e3, "components": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
