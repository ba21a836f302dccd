"""gymgo_tpu_torch.models.az_net and the weight loader of
gymgo_tpu_torch.convert against gymgo_tpu.models.az_net.

The same weights (a flax random init, or a committed artifact read by both
packages) and the same states go through both nets in float32.  Tolerance:
atol 1e-4 on logits and value; both compute in float32 on the CPU, and only
the order of the sums in the convolutions and dense layers differs.
"""

import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.utils.checkpoint import restore_npz
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from torch_boards import midgame_states

_ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
_ALL = sorted(p.name for p in _ARTIFACTS.glob("*_params.npz"))
ATOL = 1e-4


def _states(n, b, seed):
    s = midgame_states(n, b, n * n // 2, seed)
    s[0] = 0  # an empty board too
    return s


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_nets_agree(jcfg, jparams, tnet, states):
    jlogits, jvalue = jax.jit(jaz.AZNet(jcfg).apply)(jparams, jnp.asarray(states))
    with torch.no_grad():
        tlogits, tvalue = tnet(torch.from_numpy(states))
    n = jcfg.board_size
    assert tlogits.dtype == torch.float32 and tlogits.shape == (len(states), n * n + 1)
    assert tvalue.dtype == torch.float32 and tvalue.shape == (len(states),)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(jvalue), rtol=0, atol=ATOL)
    # the comparison says something: the outputs vary across states and actions
    assert np.asarray(jlogits).std() > 10 * ATOL


@pytest.mark.parametrize("n,channels,blocks,heads", [(5, 16, 2, 2), (7, 32, 1, 8), (9, 8, 0, 4)])
def test_random_init_net_matches_flax(n, channels, blocks, heads):
    jcfg = jaz.AZNetConfig(board_size=n, channels=channels, blocks=blocks, policy_channels=heads,
                           value_channels=heads, dtype=jnp.float32)
    jparams = jaz.init_params(jax.random.PRNGKey(n), jcfg)
    # flax inits biases to 0 and scales to 1: perturb every leaf so that each
    # one, and its place in the layout, shows in the output
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rng = np.random.default_rng(n)
    leaves = [np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tcfg = AZNetConfig(board_size=n, channels=channels, blocks=blocks, policy_channels=heads,
                       value_channels=heads, dtype=torch.float32)
    assert convert.aznet_config_from_flax(_numpy_tree(jparams), torch.float32) == tcfg
    tnet = AZNet(tcfg).eval()
    tnet.load_state_dict(convert.aznet_state_dict_from_flax(_numpy_tree(jparams), tcfg), strict=True)
    _assert_nets_agree(jcfg, jparams, tnet, _states(n, 16, n))


@pytest.mark.parametrize("name,batch", [("az7_r5_iter120", 32), ("az9_r5_iter100", 32),
                                        ("az19_big128x6_iter830", 6)])
def test_artifact_matches_flax(name, batch):
    path = _ARTIFACTS / f"{name}_params.npz"
    tnet = convert.load_aznet_npz(path, device="cpu", dtype=torch.float32)
    c = tnet.config
    jcfg = jaz.AZNetConfig(board_size=c.board_size, channels=c.channels, blocks=c.blocks,
                           dtype=jnp.float32)
    template = jaz.init_params(jax.random.PRNGKey(0), jcfg)
    jparams = restore_npz(str(path), {"params": template})["params"]
    assert not tnet.training and not any(p.requires_grad for p in tnet.parameters())
    _assert_nets_agree(jcfg, jparams, tnet, _states(c.board_size, batch, 1))


@pytest.mark.parametrize("name", _ALL)
def test_every_artifact_loads_without_jax_in_the_order_its_treedef_names(name):
    path = _ARTIFACTS / name
    tree = convert.read_flax_npz(path)
    with np.load(path) as data:
        text = bytes(data["__def__params"]).decode()
        leaves = [data[f"params::{i}"] for i in range(int(data["__len__params"]))]
    # the names, in the order the treedef's repr writes them
    import re

    names = re.findall(r"'(\w+)': (?=\*)", text)
    flat = []

    def walk(node):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key])
            else:
                flat.append((key, node[key]))

    walk(tree)
    assert [k for k, _ in flat] == names and len(flat) == len(leaves)
    for (_, got), want in zip(flat, leaves):
        assert got is not None and got.shape == want.shape and np.array_equal(got, want)
    net = convert.load_aznet_npz(path, device="cpu")
    blocks = sum(1 for k in tree["params"] if k.startswith("ResBlock_"))
    assert len(leaves) == 13 + 6 * blocks == 13 + 6 * net.config.blocks
    assert net.config.dtype == torch.bfloat16 and net.stem.weight.dtype == torch.bfloat16
    assert net.value_out.weight.dtype == torch.float32
    assert sum(p.numel() for p in net.parameters()) == sum(x.size for x in leaves)


def test_leaf_order_is_lexicographic():
    tree = {"ResBlock_10": {"b": None, "a": None}, "ResBlock_2": None, "Conv_0": None}
    assert convert._leaf_paths(tree) == [("Conv_0",), ("ResBlock_10", "a"), ("ResBlock_10", "b"),
                                         ("ResBlock_2",)]
    assert convert._leaf_paths(tree, order=list)[0] == ("ResBlock_10", "b")


def test_loader_raises_on_a_mismatch(tmp_path):
    tree = convert.read_flax_npz(_ARTIFACTS / "az7_r5_iter120_params.npz")
    cfg = convert.aznet_config_from_flax(tree, torch.float32)
    with pytest.raises(ValueError, match="not of"):
        convert.aznet_state_dict_from_flax(tree, AZNetConfig(board_size=9, channels=64, blocks=3,
                                                             dtype=torch.float32))
    bad = {"params": dict(tree["params"])}
    bad["params"]["Dense_0"] = {"kernel": np.zeros((8 * 49, 51), np.float32), "bias": np.zeros(51, np.float32)}
    with pytest.raises(ValueError, match="square board"):
        convert.aznet_config_from_flax(bad)
    with pytest.raises(ValueError, match="not an AZNet"):
        convert.aznet_config_from_flax({"params": {"Conv_0": {}}})
    # a file whose value head does not fit its trunk
    with np.load(_ARTIFACTS / "az7_r5_iter120_params.npz") as data:
        arrays = {k: data[k] for k in data.files}
    for cut, message in ((8, "does not follow a flatten"), (49, "do not fit")):
        short = dict(arrays, **{"params::8": arrays["params::8"][:-cut]})
        np.savez(tmp_path / "short.npz", **short)
        with pytest.raises(ValueError, match=message):
            convert.load_aznet_npz(tmp_path / "short.npz", device="cpu")
    # and no card, no silent CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.load_aznet_npz(_ARTIFACTS / "az7_r5_iter120_params.npz")
    assert cfg.board_size == 7


def test_bfloat16_net_stays_close_to_float32():
    """bfloat16 rounds every activation to 8 bits of mantissa: the logits move
    by a few percent of their spread, not bit for bit."""
    path = _ARTIFACTS / "az9_r5_iter100_params.npz"
    f32 = convert.load_aznet_npz(path, device="cpu", dtype=torch.float32)
    b16 = convert.load_aznet_npz(path, device="cpu", dtype=torch.bfloat16)
    states = torch.from_numpy(_states(9, 16, 2))
    with torch.no_grad():
        (l32, v32), (l16, v16) = f32(states), b16(states)
    assert l16.dtype == torch.float32 and v16.dtype == torch.float32
    assert (l16 - l32).abs().max() < 0.05 * (l32.max() - l32.min())
    assert (v16 - v32).abs().max() < 0.05
