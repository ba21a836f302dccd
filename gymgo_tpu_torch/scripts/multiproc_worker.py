"""One rank of the multi-process harness (counterpart of the JAX package's
``scripts/multiproc_worker.py``).

Each worker joins the process group (``parallel.mesh.initialize_distributed``:
gloo, or NCCL when every rank has a card of its own), builds the global mesh
of ``--local-devices`` logical shards per rank on ``--device``, and runs a
sharded rollout whose batch spans the ranks.  It prints one JSON line of
checksums all-reduced over the ranks; the launcher checks that every rank
prints the same values, equal to a one-process run: the words of the sampler
are drawn for the whole batch on every rank, so the number of ranks does not
change a trajectory.

    python -m gymgo_tpu_torch.scripts.multiproc_worker --coordinator localhost:9876 \\
        --num-processes 2 --process-id 0 --device cpu &
    python -m gymgo_tpu_torch.scripts.multiproc_worker --coordinator localhost:9876 \\
        --num-processes 2 --process-id 1 --device cpu

Segmented mode (``--num-segments`` > 1) splits the run into rollouts of
``steps / num_segments`` steps, segment ``s`` seeded with
``utils.faulttol.chunk_seed(seed, s)``, so a restart resumes mid-run exactly.
After each segment the ranks gather the global states and rank 0 writes them
to ``--ckpt`` (``utils.checkpoint.save_npz``, renamed into place), and every
rank waits until it has.  ``--crash-after-segment`` makes the rank given it die
right after that segment's checkpoint, with no shutdown, as a lost host would;
``--start-segment`` resumes from the checkpoint.  Without a card,
``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.multiproc_worker")
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4, help="logical env shards per rank")
    ap.add_argument("--board", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-segments", type=int, default=1)
    ap.add_argument("--start-segment", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="npz checkpoint path (written after each segment by rank 0; read at --start-segment > 0)")
    ap.add_argument("--crash-after-segment", type=int, default=-1,
                    help="this rank os._exit(1)s right after the given segment's checkpoint lands")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)
    if args.steps % args.num_segments != 0:
        ap.error(f"--steps {args.steps} does not split into {args.num_segments} segments")

    import torch
    import torch.distributed as dist

    from gymgo_tpu_torch.config import EnvConfig
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh, shard_states
    from gymgo_tpu_torch.parallel.mesh import initialize_distributed
    from gymgo_tpu_torch.utils import checkpoint as ckpt
    from gymgo_tpu_torch.utils.faulttol import chunk_seed

    backend = initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
        mesh = make_mesh(devices=[dev] * (args.local_devices * args.num_processes))
        env = ShardedGoEnv(EnvConfig(board_size=args.board, batch_size=args.batch, auto_reset=True), mesh)
        gen = torch.Generator(device=dev)
        if args.num_segments == 1:
            r = env.rollout(gen.manual_seed(args.seed), env.reset(), args.steps)
        else:
            seg_steps = args.steps // args.num_segments
            if args.start_segment == 0:
                states = env.reset()
            else:
                states = shard_states(torch.from_numpy(ckpt.restore_npz(args.ckpt)["states"]), mesh)
            for seg in range(args.start_segment, args.num_segments):
                r = env.rollout(gen.manual_seed(chunk_seed(args.seed, seg)), states, seg_steps)
                states = r.final_states
                if args.ckpt:
                    full = env.gather_states(states)  # every rank takes part
                    if args.process_id == 0:
                        tmp = f"{args.ckpt}.{os.getpid()}.tmp.npz"
                        ckpt.save_npz(tmp, {"states": full})
                        os.replace(tmp, args.ckpt)
                    dist.barrier()  # the checkpoint has landed before any rank goes on
                if seg == args.crash_after_segment:
                    sys.stdout.flush()
                    os._exit(1)  # a lost host: no shutdown; the launcher restarts the job
        sums = env.checksums(r)
        print(json.dumps({
            "process_id": args.process_id,
            "process_count": dist.get_world_size(),
            "global_devices": mesh.size,
            "backend": backend,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            **sums,
        }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
