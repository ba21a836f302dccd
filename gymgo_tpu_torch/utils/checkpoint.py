"""Checkpoint / resume: the trainer's tree saved with numpy (counterpart of
``gymgo_tpu.utils.checkpoint``'s ``save_npz`` / ``restore_npz``).

The 6-channel state is Markov (turn, pass bit, done flag and ko live inside
the array), so the env states, the generator's state, the counters, the
learner (float32 parameters and AdamW moments) and the replay capture a run;
the restore is bit-exact.  A tree is nested dicts of tensors, arrays and
numbers; it is stored flat, one ``.npz`` entry per leaf under its
``/``-joined path.  Orbax has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_npz", "restore_npz"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            if "/" in key:
                raise ValueError(f"checkpoint key {key!r} holds a '/'")
            yield from _leaves(value, f"{prefix}{key}/")
    else:
        if isinstance(tree, torch.Tensor):
            if tree.dtype == torch.bfloat16:
                raise ValueError(f"{prefix[:-1]}: numpy holds no bfloat16; save float32 parameters")
            tree = tree.detach().cpu().numpy()
        yield prefix[:-1], np.asarray(tree)


def save_npz(path, tree: Dict[str, Any]) -> None:
    """Save the nested dict ``tree`` to ``path`` (.npz), tensors moved to
    the host."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **dict(_leaves(tree)))


def restore_npz(path) -> Dict[str, Any]:
    """The nested dict of numpy arrays that ``save_npz`` wrote."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for name in data.files:
            *parents, leaf = name.split("/")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = data[name]
    return out
