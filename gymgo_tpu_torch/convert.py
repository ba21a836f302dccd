"""Carry state and weights across between numpy (and so the JAX package) and
this port.

States are int8 ``(B, 6, N, N)`` in both packages, with the same channels, so
they convert by a copy.  A ``PlanesState`` converts field by field, its carried
``atari`` (int16) and ``ko_surr`` (bool) planes included.

An ``AZNet`` checkpoint of the JAX package (a flax parameter tree, or a
committed ``artifacts/*_params.npz`` file) becomes a ``state_dict`` of the
port's ``AZNet``, and a whole ``train.py`` checkpoint of the JAX package the
port's trainer tree (``trainer_tree_from_jax_npz``); the files are read with
numpy alone.
"""

from __future__ import annotations

import ast
import math

import numpy as np
import torch

from gymgo_tpu_torch.core.state import resolve_device
from gymgo_tpu_torch.core.step import PlanesState
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.rl.replay import ReplayState

__all__ = [
    "states_to_torch",
    "states_to_numpy",
    "planes_to_torch",
    "planes_to_numpy",
    "aznet_state_dict_from_flax",
    "aznet_config_from_flax",
    "read_flax_npz",
    "load_aznet_npz",
    "aznet_config_from_state_dict",
    "load_aznet_checkpoint",
    "flax_params_from_aznet",
    "flax_treedef_text",
    "trainer_tree_from_jax_npz",
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


def aznet_config_from_state_dict(sd, dtype=torch.bfloat16) -> AZNetConfig:
    """The ``AZNetConfig`` that the shapes of a port ``AZNet`` state_dict
    imply; raises ``ValueError`` where they fit no such net."""
    try:
        channels = sd["stem.weight"].shape[0]
        policy_channels = sd["policy_conv.weight"].shape[0]
        value_channels = sd["value_conv.weight"].shape[0]
        actions = sd["policy_out.weight"].shape[0]
    except (KeyError, IndexError, AttributeError) as e:
        raise ValueError(f"not an AZNet state_dict: {e!r}") from e
    n = math.isqrt(actions - 1)
    if n * n + 1 != actions:
        raise ValueError(f"a policy head of {actions} actions fits no square board")
    blocks = sum(1 for name in sd if name.startswith("blocks.") and name.endswith(".conv_0.weight"))
    return AZNetConfig(board_size=n, channels=channels, blocks=blocks,
                       policy_channels=policy_channels, value_channels=value_channels, dtype=dtype)


def load_aznet_checkpoint(path, device=None, dtype=torch.bfloat16, expect=None) -> AZNet:
    """An ``AZNet`` in eval mode on ``device`` (``cuda`` unless named) from any
    of the three checkpoint kinds, told apart by their keys: a params-only
    artifact or a ``train.py`` checkpoint of the JAX package (``__def__params``,
    read by ``load_aznet_npz``), or this port's trainer checkpoint
    (``params/<state_dict name>``, ``utils.checkpoint.save_npz``).

    ``expect`` = ``(board_size, channels, blocks)``: raise ``ValueError``
    when the file holds another net."""
    with np.load(path) as data:
        files = data.files
        if "__def__params" in files:
            net = load_aznet_npz(path, device=device, dtype=dtype)
        elif any(name.startswith("params/") for name in files):
            sd = {name[len("params/"):]: torch.from_numpy(data[name]) for name in files
                  if name.startswith("params/")}
            net = AZNet(aznet_config_from_state_dict(sd, dtype))
            try:
                net.load_state_dict(sd, strict=True)
            except RuntimeError as e:
                raise ValueError(f"{path}: parameters do not fit {net.config}: {e}") from e
            net = net.to(resolve_device(device)).eval().requires_grad_(False)
        else:
            raise ValueError(f"{path}: neither a JAX params tree (__def__params) nor a trainer checkpoint (params/)")
    if expect is not None:
        cfg = net.config
        if (cfg.board_size, cfg.channels, cfg.blocks) != tuple(expect):
            n, c, b = expect
            raise ValueError(f"{path} holds a {cfg.board_size}x{cfg.board_size} {cfg.channels}x{cfg.blocks} net, "
                             f"not {n}x{n} {c}x{b}")
    return net


class _Leaf:
    def __repr__(self):
        return "*"


def flax_treedef_text(tree) -> str:
    """``repr(treedef)`` of the nested dicts ``tree`` as
    ``jax.tree_util.tree_flatten`` gives it: ``PyTreeDef({...})``, every
    level's keys sorted as strings, ``*`` for each leaf."""
    def stars(t):
        return {k: stars(t[k]) for k in sorted(t)} if isinstance(t, dict) else _Leaf()

    return f"PyTreeDef({stars(tree)!r})"


def flax_params_from_aznet(net) -> dict:
    """The inverse of ``aznet_state_dict_from_flax``: the flax variables
    ``{"params": {"Conv_0": {"kernel": ...}, ...}}`` of the JAX package's
    ``AZNet`` as float32 numpy arrays, from a port ``AZNet``.  Conv kernels
    go from OIHW to HWIO, dense kernels are transposed, and the rows of the
    two dense kernels that follow a flatten go back from the port's
    ``(c, h, w)`` to flax's ``(h, w, c)``."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in net.state_dict().items()}
    config = aznet_config_from_state_dict(sd)
    hw = config.board_size ** 2

    def conv(name):
        return np.ascontiguousarray(np.transpose(sd[name], (2, 3, 1, 0)))

    def dense(name, flattened_hw=0):
        k = sd[name].T
        if flattened_hw:
            rows, out = k.shape
            k = k.reshape(rows // flattened_hw, flattened_hw, out).transpose(1, 0, 2).reshape(rows, out)
        return np.ascontiguousarray(k)

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    p = {
        "Conv_0": {"kernel": conv("stem.weight")},
        "GroupNorm_0": norm("stem_norm"),
        "Conv_1": {"kernel": conv("policy_conv.weight"), "bias": sd["policy_conv.bias"]},
        "Dense_0": {"kernel": dense("policy_out.weight", hw), "bias": sd["policy_out.bias"]},
        "Conv_2": {"kernel": conv("value_conv.weight"), "bias": sd["value_conv.bias"]},
        "Dense_1": {"kernel": dense("value_hidden.weight", hw), "bias": sd["value_hidden.bias"]},
        "Dense_2": {"kernel": dense("value_out.weight"), "bias": sd["value_out.bias"]},
    }
    for i in range(config.blocks):
        block = {}
        for j in (0, 1):
            block[f"Conv_{j}"] = {"kernel": conv(f"blocks.{i}.conv_{j}.weight")}
            block[f"GroupNorm_{j}"] = norm(f"blocks.{i}.norm_{j}")
        p[f"ResBlock_{i}"] = block
    return {"params": p}


def _numpy_state_dict(tree, config: AZNetConfig) -> dict:
    return {k: v.numpy() for k, v in aznet_state_dict_from_flax(tree, config).items()}


def trainer_tree_from_jax_npz(path) -> dict:
    """A checkpoint of the JAX package's ``train.py`` as the port's trainer
    tree (``gymgo_tpu_torch.train.trainer_tree``: numpy arrays, no
    ``generator`` entry), read with numpy alone.

    * ``params`` and ``target_params`` (a file without the latter gets the
      online parameters) go through ``aznet_state_dict_from_flax``.
    * ``opt_state`` is optax.adamw's ``(ScaleByAdamState(count, mu, nu),
      EmptyState(), EmptyState())``, whose treedef text no literal parser
      reads.  Its leaves are ``count``, then ``mu`` and ``nu``, each in the
      parameters' sorted leaf order; ``mu`` and ``nu`` take exactly the
      parameters' permutations (HWIO to OIHW, transposes, the (h, w, c) rows).
    * ``buf`` holds the 7 ``ReplayState`` leaves in field order; a file of 6
      (no ``vmask``) gets ``vmask = mask``, as the JAX package restores it.
    * ``key`` (a threefry key) has no counterpart in a torch generator and is
      dropped: the trainer seeds its generator instead."""
    params = read_flax_npz(path, "params")
    config = aznet_config_from_flax(params, torch.float32)
    paths = _leaf_paths(params)
    k = len(paths)

    def as_tree(leaves):
        tree = {}
        for leaf_path, leaf in zip(paths, leaves):
            node = tree
            for key in leaf_path[:-1]:
                node = node.setdefault(key, {})
            node[leaf_path[-1]] = leaf
        return tree

    with np.load(path) as data:
        n_opt = int(data["__len__opt_state"])
        if n_opt != 1 + 2 * k:
            raise ValueError(f"{path}: {n_opt} opt_state leaves; optax.adamw over {k} parameters has {1 + 2 * k}")
        opt = [data[f"opt_state::{i}"] for i in range(n_opt)]
        n_buf = int(data["__len__buf"])
        buf = [data[f"buf::{i}"] for i in range(n_buf)]
        if n_buf == 6:
            buf.insert(4, buf[3])  # vmask := mask
        elif n_buf != 7:
            raise ValueError(f"{path}: a replay of {n_buf} leaves; expected 7 (or 6 without vmask)")
        rest = {name: data[f"{name}::0"] for name in ("step", "env_states", "iteration")}
        has_target = "__def__target_params" in data.files
    target = read_flax_npz(path, "target_params") if has_target else params
    return {
        "params": _numpy_state_dict(params, config),
        "opt_state": {
            "step": np.asarray(opt[0], np.float32),
            "exp_avg": _numpy_state_dict(as_tree(opt[1:1 + k]), config),
            "exp_avg_sq": _numpy_state_dict(as_tree(opt[1 + k:]), config),
        },
        "step": np.asarray(rest["step"], np.int64),
        "buf": dict(zip(ReplayState._fields, buf)),
        "env_states": rest["env_states"],
        "iteration": np.asarray(rest["iteration"], np.int64),
        "target_params": _numpy_state_dict(target, config),
    }
