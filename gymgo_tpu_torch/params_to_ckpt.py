"""Rebuild a full trainer checkpoint from a params-only artifact (counterpart
of the JAX package's ``scripts/params_to_ckpt.py``).

Full checkpoints (optimizer, replay, env states) are not committed; the
``artifacts/*_params.npz`` files are.  This re-seeds a checkpoint that
``python -m gymgo_tpu_torch.train --resume`` takes: the parameters (and the
frozen target's) from the artifact, a fresh AdamW, an empty replay, fresh
boards, a generator seeded from ``--seed``, and the iteration counter set to
``--iteration`` so a resumed run numbers on from the artifact's line.

    python -m gymgo_tpu_torch.params_to_ckpt \\
        --params artifacts/az19_big128x6_iter830_params.npz \\
        --out checkpoints/az19_big.npz --board 19 --envs 512 \\
        --channels 128 --blocks 6 --iteration 830 --lr 2e-4
    python -m gymgo_tpu_torch.train --resume checkpoints/az19_big.npz --iters 900 ...

The generator's state is a state of the device's generator: a trainer that
resumes it on another kind of device (``--cpu`` on one side only) seeds its
generator from ``--seed`` instead, with a note.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from gymgo_tpu_torch import convert
from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
from gymgo_tpu_torch.models.az_net import AZNet
from gymgo_tpu_torch.rl.learner import make_train_state
from gymgo_tpu_torch.rl.replay import ReplayBuffer
from gymgo_tpu_torch.train import trainer_tree
from gymgo_tpu_torch.utils import checkpoint as ckpt

__all__ = ["tree_from_params", "main"]


def tree_from_params(params_path, board: int, envs: int, channels: int, blocks: int, iteration: int,
                     lr: float = 1e-3, replay_capacity: int = 1 << 16, seed: int = 0, device=None) -> dict:
    """The trainer tree of a fresh line from ``params_path``'s weights, built
    on ``device`` (``cuda`` unless named).  Raises ``ValueError`` when the
    artifact is not a ``board`` x ``board`` ``channels`` x ``blocks`` net."""
    device = resolve_device(device)
    params = convert.read_flax_npz(params_path)
    config = convert.aznet_config_from_flax(params)
    if (config.board_size, config.channels, config.blocks) != (board, channels, blocks):
        raise ValueError(f"{params_path} holds a {config.board_size}x{config.board_size} "
                         f"{config.channels}x{config.blocks} net, not {board}x{board} {channels}x{blocks}")
    net = AZNet(config, torch.float32)
    net.load_state_dict(convert.aznet_state_dict_from_flax(params, config), strict=True)
    net.to(device)
    return trainer_tree(
        make_train_state(net, learning_rate=lr),
        ReplayBuffer(replay_capacity, board, device).init(),
        batch_init_state(envs, board, device=device),
        torch.Generator(device=device).manual_seed(seed),
        iteration,
        net,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.params_to_ckpt",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", required=True, help="params-only artifact (artifacts/*_params.npz)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--board", type=int, required=True)
    ap.add_argument("--envs", type=int, required=True)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--iteration", type=int, required=True, help="iteration counter for the resumed line")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="kept for the JAX script's command line: the tree stores no learning rate, the "
                         "resuming trainer's --lr is the one used")
    ap.add_argument("--replay-capacity", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="build the tree for a trainer run with --cpu")
    args = ap.parse_args(argv)
    tree = tree_from_params(args.params, args.board, args.envs, args.channels, args.blocks, args.iteration,
                            args.lr, args.replay_capacity, args.seed, device="cpu" if args.cpu else None)
    ckpt.save_npz(args.out, tree)
    print(f"{args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB "
          f"(iteration {args.iteration}, fresh optimizer/replay/envs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
