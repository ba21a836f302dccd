"""Grow a trainer checkpoint to a larger AZNet (Net2Net) and write a new
trainer checkpoint that resumes FROM the parent's strength (counterpart of
the JAX package's ``scripts/net2net.py``).

The parameters are widened and deepened function-preservingly
(``models.surgery.widen_deepen``: group-aware channel duplication under
GroupNorm, identity blocks for new depth, small symmetry-breaking noise); the
AdamW state restarts fresh for the new architecture; the replay, the env
states, the generator, the update step and the iteration counter carry over
unchanged: replay rows are board states and targets, which do not depend on
the architecture, so the grown net trains on the parent's data from step one.

Usage:
  python -m gymgo_tpu_torch.scripts.net2net --in checkpoints/az19_seg5.npz \\
      --out checkpoints/az19_big.npz --board 19 --envs 512 \\
      --channels 64 --blocks 3 --new-channels 128 --new-blocks 6
  python -m gymgo_tpu_torch.train --resume checkpoints/az19_big.npz \\
      --channels 128 --blocks 6 ...

The input is this port's trainer checkpoint or a JAX ``train.py`` one; the
surgery runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.models.surgery import widen_deepen
from gymgo_tpu_torch.rl.learner import make_train_state
from gymgo_tpu_torch.rl.replay import ReplayState
from gymgo_tpu_torch.train import load_trainer_tree, trainer_tree
from gymgo_tpu_torch.utils import checkpoint as ckpt

__all__ = ["grow_tree", "main"]


def grow_tree(tree: dict, new_channels: int, new_blocks: int, lr: float = 1e-3, noise_scale: float = 1e-2,
              seed: int = 0) -> dict:
    """The trainer tree of ``tree``'s run with its net grown to
    ``new_channels`` x ``new_blocks``: fresh AdamW moments; replay, env
    states, generator (when the tree has one), update step and iteration as
    they were."""
    sd = {k: torch.as_tensor(v) for k, v in tree["params"].items()}
    old_cfg = convert.aznet_config_from_state_dict(sd, torch.float32)
    net = AZNet(old_cfg, torch.float32)
    net.load_state_dict(sd, strict=True)
    new_cfg = AZNetConfig(board_size=old_cfg.board_size, channels=new_channels, blocks=new_blocks,
                          dtype=torch.float32)
    grown = widen_deepen(net, new_cfg, torch.Generator().manual_seed(seed), noise_scale=noise_scale)
    buf = {k: torch.as_tensor(np.asarray(v)) for k, v in tree["buf"].items()}
    train_state = make_train_state(grown, learning_rate=lr)._replace(step=int(tree["step"]))
    out = trainer_tree(train_state, ReplayState(**buf), torch.as_tensor(np.asarray(tree["env_states"])),
                       torch.Generator().manual_seed(seed), int(tree["iteration"]), grown)
    if "generator" in tree:  # a JAX tree has none: the resuming trainer seeds one
        out["generator"] = np.asarray(tree["generator"])
        out["generator_device"] = np.asarray(tree["generator_device"])
    else:
        del out["generator"], out["generator_device"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.net2net")
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--board", type=int, required=True)
    ap.add_argument("--envs", type=int, required=True,
                    help="env count of the parent run (its env_states shape)")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--new-channels", type=int, required=True)
    ap.add_argument("--new-blocks", type=int, required=True)
    ap.add_argument("--replay-capacity", type=int, default=1 << 16)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="kept for the JAX script's command line: the tree stores no learning rate, "
                         "the resuming trainer's --lr is the one used")
    ap.add_argument("--noise-scale", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    tree = load_trainer_tree(args.inp)
    cfg = convert.aznet_config_from_state_dict(tree["params"])
    got = (cfg.board_size, cfg.channels, cfg.blocks, np.asarray(tree["env_states"]).shape[0],
           np.asarray(tree["buf"]["obs"]).shape[0])
    want = (args.board, args.channels, args.blocks, args.envs, args.replay_capacity)
    if got != want:
        raise ValueError(f"{args.inp} holds board, channels, blocks, envs, replay capacity {got}, not {want}")
    out = grow_tree(tree, args.new_channels, args.new_blocks, args.lr, args.noise_scale, args.seed)
    ckpt.save_npz(args.out, out)
    n_old = sum(np.asarray(v).size for v in tree["params"].values())
    n_new = sum(np.asarray(v).size for v in out["params"].values())
    print(f"grew {args.inp} ({args.channels}ch x {args.blocks}, "
          f"{n_old:,} params) -> {args.out} ({args.new_channels}ch x "
          f"{args.new_blocks}, {n_new:,} params) at iteration "
          f"{int(tree['iteration'])}; replay/env states carried over")


if __name__ == "__main__":
    main()
