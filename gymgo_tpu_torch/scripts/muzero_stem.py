"""Two forms of the learned model's dynamics input on the card: the
257-plane convolution over ``concat(s, plane(a))`` that the CPU and autograd
run, beside the served form, which convolves the 256 state planes alone and
stamps the action plane's 3x3 filter at the played point
(``models.muzero_net._stamp_``).

At ``--batch`` boards of 19x19 (``MuZeroNet`` at 256 wide, bf16, served
channels-last), each form is captured into a CUDA graph and timed by CUDA
events over ``--reps`` back-to-back replays, ``--repeats`` times:

- ``first.*``: the parent's gather from a 33-slot store of hidden states,
  then ``g``'s first convolution;
- ``g.*``: the same, then the whole tower and ``scale`` (what a simulation
  runs under ``search.latent`` and ``search.dynamics``).

Then one call of each first layer under ``torch.profiler``: its device
operations by name, so the cuDNN kernel each form gets is on record.

    python -m gymgo_tpu_torch.scripts.muzero_stem [--batch 256] [--reps 50] [--repeats 3]

Runs on the card only.  Prints one JSON object a form, then the kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

__all__ = ["main"]


def _timed(fn, reps: int, repeats: int) -> list:
    """Milliseconds a replay of ``fn`` captured into a CUDA graph, ``repeats``
    times over ``reps`` replays each."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(5):
        graph.replay()
    out = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return out


def _kernels(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"), key=lambda e: e.time_range.start)
    return [(round(e.time_range.elapsed_us(), 1), e.name[:160]) for e in ops]


def main(argv=None) -> int:
    from gymgo_tpu_torch.models import muzero_net
    from gymgo_tpu_torch.models.az_net import _conv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    n, slots, b = 19, 33, args.batch
    gen = torch.Generator(device=dev).manual_seed(0)
    net = muzero_net.acting_copy(muzero_net.init_params(gen, muzero_net.MuZeroNetConfig(n)))
    with torch.no_grad():
        store = net.latent_store(slots, b, dev)
        store.copy_(torch.rand(store.shape, generator=gen, device=dev))
        parent = torch.randint(0, slots, (b,), generator=gen, device=dev)
        actions = torch.randint(0, n * n + 1, (b,), generator=gen, device=dev)
        actions[:5] = torch.tensor([0, n - 1, n * n - n, n * n - 1, n * n], device=dev)
        c = net.config.channels
        weight = net.g.stem.weight

        def concat_first():
            s, a = net.dynamics_input(store, parent, actions)
            return _conv(net.g.stem, torch.cat([s, muzero_net.action_plane(a, n, s.dtype)], dim=1),
                         torch.channels_last)

        def stamp_first():
            s, a = net.dynamics_input(store, parent, actions)
            h = torch.nn.functional.conv2d(s, weight[:, :c].to(memory_format=torch.channels_last), padding=1)
            return muzero_net._stamp_(h, weight[:, c], a)

        forms = {
            "first.concat_257": concat_first,
            "first.stamp_256": stamp_first,
            "g.concat_257": lambda: muzero_net.scale(net.g.body(concat_first(), True), store[1]),
            "g.stamp_256": lambda: net.dynamics_from_input(net.dynamics_input(store, parent, actions), store[1]),
        }
        diff = float((concat_first().float() - stamp_first().float()).abs().max())
        scale = float(concat_first().float().abs().max())
        for name, fn in forms.items():
            ms = _timed(fn, args.reps, args.repeats)
            print(json.dumps({"form": name, "batch": b, "ms": ms, "best_ms": min(ms)}), flush=True)
        print(json.dumps({"first_layer_max_abs_diff": diff, "first_layer_max_abs": scale}), flush=True)
        for name in ("first.concat_257", "first.stamp_256"):
            print(json.dumps({"kernels": name, "ops": _kernels(forms[name])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
