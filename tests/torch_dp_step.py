"""One rank of the port's data-parallel learner step, run as a process of its
own: ``tests/test_torch_multiprocess.py`` (gloo on the CPU) and
``chip_smoke.py`` phase 22c (gloo, two ranks on one card) launch it.  Imports
no JAX.

    python tests/torch_dp_step.py --coordinator localhost:PORT --num-processes 2 \\
        --process-id 0 --inputs in.npz --out out.npz [--device cpu|cuda] [--lr 1e-3]

``--inputs`` is a ``utils.checkpoint`` tree: ``net`` (a float32 ``AZNet``
state dict) and ``batches`` (``0``, ``1``, ...: each ``obs``, ``pi``, ``v``,
``mask``, ``vmask`` of the global batch).  Each rank takes its env slice of
every batch (rank r of W: rows r*M/W to (r+1)*M/W) and makes one
``train_step(..., group=WORLD)`` per batch, in float32 with TF32 off.  Rank 0
writes the parameters after each step (``params/<i>``), the gradients the step
applied, summed over the ranks (``grads/<i>``), each step's metrics and its
host-clock milliseconds (``ms``; each step ends on a synchronize) to
``--out``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gymgo_tpu_torch.convert import aznet_config_from_state_dict
    from gymgo_tpu_torch.models.az_net import AZNet
    from gymgo_tpu_torch.parallel.mesh import initialize_distributed
    from gymgo_tpu_torch.rl import learner
    from gymgo_tpu_torch.utils.checkpoint import restore_npz, save_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
        tree = restore_npz(args.inputs)
        sd = {k: torch.from_numpy(v) for k, v in tree["net"].items()}
        net = AZNet(aznet_config_from_state_dict(sd, torch.float32)).to(dev)
        net.load_state_dict(sd)
        net.train()
        state = learner.make_train_state(net, learning_rate=args.lr)
        params, grads, metrics, ms = {}, {}, {}, []
        for i in range(len(tree["batches"])):
            batch = tree["batches"][str(i)]
            m = batch["obs"].shape[0]
            rows = slice(args.process_id * m // args.num_processes, (args.process_id + 1) * m // args.num_processes)
            part = tuple(torch.from_numpy(batch[k][rows]).to(dev) for k in ("obs", "pi", "v", "mask", "vmask"))
            t0 = time.perf_counter()
            state, mt = learner.train_step(state, part, group=dist.group.WORLD)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics[str(i)] = {k: float(v) for k, v in mt.items()}
            params[str(i)] = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            grads[str(i)] = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
        if args.process_id == 0:
            save_npz(args.out, {"params": params, "grads": grads, "metrics": metrics, "ms": torch.tensor(ms)})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
