"""Export a params-only artifact in the JAX package's layout from a net of
this port (counterpart of the JAX package's ``scripts/export_params.py``,
and the way a net the port trained becomes an artifact of ``gymgo_tpu``).

The input is this port's trainer checkpoint (or any checkpoint that
``convert.load_aznet_checkpoint`` reads); the output is what the JAX
package's ``utils.checkpoint.save_npz({"params": variables})`` writes: the
leaves ``params::i`` in flax's sorted-name order (HWIO conv kernels, dense
kernels with flax's ``(h, w, c)`` rows), ``__len__params`` and
``__def__params``, the treedef's text.  It loads into ``gymgo_tpu`` through
``restore_npz(path, {"params": init_params(...)})`` and into this port
through ``convert.load_aznet_npz``.

Usage: python -m gymgo_tpu_torch.scripts.export_params --ckpt checkpoints/az9.npz \\
          --out artifacts/az9_port_params.npz --board 9 --channels 64 --blocks 3
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gymgo_tpu_torch import convert

__all__ = ["export_params", "main"]


def export_params(net, path) -> None:
    """Write the parameters of ``net``, a port ``AZNet``, to
    ``path`` as a params-only artifact of the JAX package."""
    tree = convert.flax_params_from_aznet(net)
    leaves = []
    for leaf_path in convert._leaf_paths(tree):  # tree_flatten's order: keys sorted as strings
        node = tree
        for key in leaf_path:
            node = node[key]
        leaves.append(node)
    flat = {"__len__params": np.asarray(len(leaves))}
    flat.update({f"params::{i}": leaf for i, leaf in enumerate(leaves)})
    flat["__def__params"] = np.frombuffer(convert.flax_treedef_text(tree).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.scripts.export_params")
    ap.add_argument("--ckpt", required=True, help="this port's trainer checkpoint (or a JAX params tree)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--board", type=int, required=True)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    args = ap.parse_args(argv)

    # the float32 parameters, read on the CPU: no device is needed
    net = convert.load_aznet_checkpoint(args.ckpt, device="cpu", dtype=torch.float32,
                                        expect=(args.board, args.channels, args.blocks))
    export_params(net, args.out)
    print(f"{args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
