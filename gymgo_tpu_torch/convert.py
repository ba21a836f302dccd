"""Carry state and weights across between numpy (and so the JAX package) and
this port.

States are int8 ``(B, 6, N, N)`` in both packages, with the same channels, so
they convert by a copy.  A ``PlanesState`` converts field by field, its carried
``atari`` (int16) and ``ko_surr`` (bool) planes included.

An ``AZNet`` checkpoint of the JAX package (a flax parameter tree, or a
committed ``artifacts/*_params.npz`` file) becomes a ``state_dict`` of the
port's ``AZNet``; the file is read with numpy alone.
"""

from __future__ import annotations

import ast
import math

import numpy as np
import torch

from gymgo_tpu_torch.core.state import resolve_device
from gymgo_tpu_torch.core.step import PlanesState
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig

__all__ = [
    "states_to_torch",
    "states_to_numpy",
    "planes_to_torch",
    "planes_to_numpy",
    "aznet_state_dict_from_flax",
    "aznet_config_from_flax",
    "read_flax_npz",
    "load_aznet_npz",
]

_PLANE_DTYPES = {
    "black": torch.bool,
    "white": torch.bool,
    "invd": torch.bool,
    "white_to_move": torch.bool,
    "prev_passed": torch.bool,
    "done": torch.bool,
    "atari": torch.int16,
    "ko_surr": torch.bool,
}


def states_to_torch(states, device) -> torch.Tensor:
    """int8 ``(B, 6, N, N)`` array-like -> int8 tensor on ``device``."""
    arr = np.asarray(states)
    if arr.ndim != 4 or arr.shape[1] != 6 or arr.shape[2] != arr.shape[3]:
        raise ValueError(f"states must be (B, 6, N, N), got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int8, copy=True)).to(device)


def states_to_numpy(states: torch.Tensor) -> np.ndarray:
    return states.detach().to("cpu", torch.int8).numpy()


def planes_to_torch(ps, device) -> PlanesState:
    """Any PlanesState-like tuple with the same field names (numpy or JAX
    arrays) -> the port's ``PlanesState`` on ``device``."""
    fields = {}
    for name, dtype in _PLANE_DTYPES.items():
        v = getattr(ps, name, None)
        fields[name] = None if v is None else torch.from_numpy(np.array(v)).to(device, dtype)
    return PlanesState(**fields)


def planes_to_numpy(ps: PlanesState) -> dict:
    """The port's ``PlanesState`` -> a dict of numpy arrays (None kept)."""
    return {
        name: None if getattr(ps, name) is None else getattr(ps, name).detach().cpu().numpy()
        for name in PlanesState._fields
    }


def _conv_kernel(kernel) -> torch.Tensor:
    """flax HWIO ``(kh, kw, in, out)`` -> PyTorch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _dense_kernel(kernel, flattened_hw: int = 0) -> torch.Tensor:
    """flax ``(in, out)`` -> ``nn.Linear.weight`` ``(out, in)``.  With
    ``flattened_hw = N*N`` the rows follow a flatten of ``(h, w, c)`` and are
    reordered to the port's flatten of ``(c, h, w)``."""
    k = np.asarray(kernel)
    if flattened_hw:
        rows, out = k.shape
        if rows % flattened_hw:
            raise ValueError(f"a dense kernel of {rows} rows does not follow a flatten of {flattened_hw} cells")
        k = k.reshape(flattened_hw, rows // flattened_hw, out).transpose(1, 0, 2).reshape(rows, out)
    return torch.from_numpy(np.ascontiguousarray(k.T))


def _vector(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v))


def aznet_config_from_flax(params, dtype=torch.bfloat16) -> AZNetConfig:
    """The ``AZNetConfig`` that the shapes of a flax ``AZNet`` parameter tree
    imply; raises ``ValueError`` where they fit no such net."""
    p = params["params"] if "params" in params else params
    try:
        channels = p["Conv_0"]["kernel"].shape[3]
        policy_channels = p["Conv_1"]["kernel"].shape[3]
        value_channels = p["Conv_2"]["kernel"].shape[3]
        rows, actions = p["Dense_0"]["kernel"].shape
    except (KeyError, IndexError, AttributeError) as e:
        raise ValueError(f"not an AZNet parameter tree: {e!r}") from e
    n = math.isqrt(actions - 1)
    if n * n + 1 != actions or rows != n * n * policy_channels:
        raise ValueError(f"policy head {rows} x {actions} fits no square board")
    blocks = sum(1 for name in p if name.startswith("ResBlock_"))
    return AZNetConfig(board_size=n, channels=channels, blocks=blocks,
                       policy_channels=policy_channels, value_channels=value_channels, dtype=dtype)


def aznet_state_dict_from_flax(params, config: AZNetConfig) -> dict:
    """A float32 ``state_dict`` for the port's ``AZNet(config)`` from the flax
    parameter tree ``params``: nested dicts of arrays, ``{"params": {"Conv_0":
    {"kernel": ...}, "ResBlock_0": {"Conv_0": ..., "GroupNorm_0": {"scale",
    "bias"}}, ...}}`` (the outer ``"params"`` level may be left out).

    Conv kernels go from HWIO to OIHW, dense kernels are transposed, and the
    rows of the two dense kernels that follow a flatten are reordered from
    flax's ``(h, w, c)`` to the port's ``(c, h, w)``.  Raises ``ValueError``
    when a name or a shape does not fit ``config``."""
    p = params["params"] if "params" in params else params
    inferred = aznet_config_from_flax(p, config.dtype)
    if inferred != config:
        raise ValueError(f"the parameters are those of {inferred}, not of {config}")
    hw = config.board_size ** 2
    sd = {
        "stem.weight": _conv_kernel(p["Conv_0"]["kernel"]),
        "stem_norm.weight": _vector(p["GroupNorm_0"]["scale"]),
        "stem_norm.bias": _vector(p["GroupNorm_0"]["bias"]),
        "policy_conv.weight": _conv_kernel(p["Conv_1"]["kernel"]),
        "policy_conv.bias": _vector(p["Conv_1"]["bias"]),
        "policy_out.weight": _dense_kernel(p["Dense_0"]["kernel"], hw),
        "policy_out.bias": _vector(p["Dense_0"]["bias"]),
        "value_conv.weight": _conv_kernel(p["Conv_2"]["kernel"]),
        "value_conv.bias": _vector(p["Conv_2"]["bias"]),
        "value_hidden.weight": _dense_kernel(p["Dense_1"]["kernel"], hw),
        "value_hidden.bias": _vector(p["Dense_1"]["bias"]),
        "value_out.weight": _dense_kernel(p["Dense_2"]["kernel"]),
        "value_out.bias": _vector(p["Dense_2"]["bias"]),
    }
    for i in range(config.blocks):
        block = p[f"ResBlock_{i}"]
        for j in (0, 1):
            sd[f"blocks.{i}.conv_{j}.weight"] = _conv_kernel(block[f"Conv_{j}"]["kernel"])
            sd[f"blocks.{i}.norm_{j}.weight"] = _vector(block[f"GroupNorm_{j}"]["scale"])
            sd[f"blocks.{i}.norm_{j}.bias"] = _vector(block[f"GroupNorm_{j}"]["bias"])
    return sd


def _leaf_paths(tree, order=sorted, prefix=()):
    """Leaf paths of nested dicts, the keys of every level taken in ``order``.
    ``sorted`` gives ``jax.tree_util.tree_flatten``'s order: keys compared as
    strings (``ResBlock_10`` before ``ResBlock_2``); ``list`` the order the
    dicts were built in."""
    if not isinstance(tree, dict):
        return [prefix]
    return [path for key in order(tree) for path in _leaf_paths(tree[key], order, prefix + (key,))]


def read_flax_npz(path, name: str = "params") -> dict:
    """The pytree ``name`` of a ``gymgo_tpu.utils.checkpoint.save_npz`` file as
    nested dicts of numpy arrays, read without JAX.

    The file holds the leaves ``{name}::0 .. {name}::K-1`` in
    ``tree_flatten`` order and ``__def__{name}``, the ``repr`` of the treedef
    as bytes.  The structure is parsed from that text; the leaf order is
    rebuilt by sorting the names and checked against the order written there."""
    with np.load(path) as data:
        text = bytes(data[f"__def__{name}"]).decode()
        if not (text.startswith("PyTreeDef(") and text.endswith(")")):
            raise ValueError(f"{path}: unreadable treedef {text[:40]!r}")
        tree = ast.literal_eval(text[len("PyTreeDef("):-1].replace("*", "None"))
        paths = _leaf_paths(tree)
        if paths != _leaf_paths(tree, order=list):
            raise ValueError(f"{path}: the treedef's names are not in sorted order")
        if int(data[f"__len__{name}"]) != len(paths):
            raise ValueError(f"{path}: {int(data[f'__len__{name}'])} leaves for {len(paths)} names")
        for i, leaf_path in enumerate(paths):
            node = tree
            for key in leaf_path[:-1]:
                node = node[key]
            node[leaf_path[-1]] = data[f"{name}::{i}"]
    return tree


def load_aznet_npz(path, device=None, dtype=torch.bfloat16) -> AZNet:
    """An ``AZNet`` in eval mode on ``device`` (``cuda`` unless named) with the
    weights of a committed ``*_params.npz`` artifact of the JAX package.

    Board size, channels and blocks are inferred from the shapes; a file that
    fits no ``AZNet`` raises ``ValueError``.  ``dtype`` is the compute type
    (``torch.float32`` to compare with the JAX package, bfloat16 to run)."""
    device = resolve_device(device)
    params = read_flax_npz(path)
    config = aznet_config_from_flax(params, dtype)
    net = AZNet(config)
    try:
        net.load_state_dict(aznet_state_dict_from_flax(params, config), strict=True)
    except (KeyError, RuntimeError) as e:
        raise ValueError(f"{path}: parameters do not fit {config}: {e}") from e
    return net.to(device).eval().requires_grad_(False)
