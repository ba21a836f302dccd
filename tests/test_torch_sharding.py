"""gymgo_tpu_torch.parallel against gymgo_tpu.parallel on the 8 virtual CPU
devices of ``conftest.py``: the sharded step equals JAX's sharded step fed the
same actions, bit for bit; a sharded rollout equals the unsharded one from the
same generator on both flood routes, and JAX's step replays its actions; the
mesh's layout, its errors, ``MeshConfig`` and the tensor-parallel rule of
``param_shardings`` against JAX's ``PartitionSpec``\\ s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu import config as jconfig
from gymgo_tpu.env import BatchGoEnv as JBatchGoEnv
from gymgo_tpu.env import batch_env as jenv
from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.parallel import ShardedGoEnv as JShardedGoEnv
from gymgo_tpu.parallel import make_mesh as jmake_mesh
from gymgo_tpu_torch import config as tconfig
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.core import actions as tactions
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig, param_shardings, shard_state_dict
from gymgo_tpu_torch.parallel import (ShardedGoEnv, env_sharding, fold_env_keys, make_mesh, replicated,
                                      shard_states)
from gymgo_tpu_torch.parallel import mesh as tmesh
from torch_boards import midgame_states

CPU8 = ["cpu"] * 8


def test_sharded_step_matches_jax_sharded_step():
    cfg_kw = dict(board_size=7, batch_size=16, auto_reset=True)
    plain = JBatchGoEnv(jconfig.EnvConfig(**cfg_kw))
    jsharded = JShardedGoEnv(jconfig.EnvConfig(**cfg_kw), jmake_mesh())
    tsharded = ShardedGoEnv(tconfig.EnvConfig(**cfg_kw), make_mesh(devices=CPU8))
    s_jax = jsharded.reset()
    s_port = tsharded.reset()
    assert isinstance(s_port, list) and len(s_port) == 8 and all(s.shape == (2, 6, 7, 7) for s in s_port)
    key = jax.random.PRNGKey(0)
    for _ in range(12):
        key, sub = jax.random.split(key)
        acts = np.asarray(plain.uniform_random_actions(sub, np.asarray(s_jax)))
        s_jax, r_jax = jsharded.step(s_jax, acts)
        s_port, r_port = tsharded.step(s_port, torch.from_numpy(acts.copy()))
        np.testing.assert_array_equal(s_port.numpy(), np.asarray(s_jax))
        np.testing.assert_array_equal(r_port.reward.numpy(), np.asarray(r_jax.reward))
        np.testing.assert_array_equal(r_port.done.numpy(), np.asarray(r_jax.done))


@pytest.mark.parametrize("route", ["bundle", "minmax"])
def test_sharded_rollout_equals_unsharded_and_replays_through_jax(route, monkeypatch):
    n, b, steps = 9, 32, 20
    cfg = tconfig.EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    with monkeypatch.context() as m:
        if route == "minmax":  # the size rule sends these boards to the minmax route
            m.setattr(tflood, "bundle_fits", lambda _n: False)
        start = torch.from_numpy(midgame_states(n, b, 100, 1))
        plain = rollout(torch.Generator().manual_seed(1), start, steps, cfg)
        env = ShardedGoEnv(cfg, make_mesh(devices=CPU8))
        sharded = env.rollout(torch.Generator().manual_seed(1), shard_states(start, env.mesh), steps)
        for field in ("actions", "rewards", "dones", "invalid", "final_states"):
            assert torch.equal(getattr(sharded, field), getattr(plain, field)), field
        # the global draw serves every shard: a second call goes on with one stream
        gen_plain, gen_sharded = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
        again = rollout(gen_plain, plain.final_states, steps, cfg)
        again_sharded = env.rollout(gen_sharded, sharded.final_states, steps)  # the global form
        assert torch.equal(again.actions, again_sharded.actions)
        assert torch.equal(again.final_states, again_sharded.final_states)
        assert torch.equal(env.uniform_random_actions(gen_sharded, again_sharded.final_states),
                           tactions.uniform_random_actions(gen_plain, again.final_states))
    # finished games restarted in place, and others finished
    assert start[:, 4, 0, 0].any() and sharded.dones.any() and not sharded.invalid.any()
    # JAX's batch_step replays the port's actions
    jcfg = jconfig.EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    jstep = jax.jit(functools.partial(jenv.batch_step, config=jcfg))
    states = jnp.asarray(start.numpy())
    for t in range(steps):
        states, res = jstep(states, jnp.asarray(sharded.actions[t].numpy()))
        np.testing.assert_array_equal(np.asarray(res.reward), sharded.rewards[t].numpy())
        np.testing.assert_array_equal(np.asarray(res.done), sharded.dones[t].numpy())
    np.testing.assert_array_equal(np.asarray(states), sharded.final_states.numpy())


def test_fold_env_keys_are_sharding_invariant():
    keys = fold_env_keys(42, 16)
    assert keys.dtype == torch.int64 and len(set(keys.tolist())) == 16 and bool((keys >= 0).all())
    # a key depends on the global index alone: a larger batch extends it
    assert torch.equal(fold_env_keys(42, 32)[:16], keys)
    assert not torch.equal(fold_env_keys(43, 16), keys)
    for k in (1, 2, 8):
        shards = shard_states(keys, make_mesh(devices=["cpu"] * k))
        assert len(shards) == k and torch.equal(torch.cat(shards), keys)


def test_state_sharding_layout():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"env": 8} and mesh.size == 8 and mesh.is_local
    states = torch.arange(8 * 6 * 7 * 7, dtype=torch.int32).reshape(8, 6, 7, 7)
    shards = shard_states(states, mesh)
    # one env shard per device, each its own contiguous row
    assert len(shards) == 8
    for i, s in enumerate(shards):
        assert s.device.type == "cpu" and s.is_contiguous() and torch.equal(s, states[i:i + 1])
    assert env_sharding(mesh, 4).shard_rows(16) == [slice(2 * i, 2 * i + 2) for i in range(8)]
    assert env_sharding(mesh, 1).spec == ("env",) and env_sharding(mesh, 4).spec == ("env", None, None, None)
    assert replicated(mesh).shard_rows(16) == [slice(0, 16)] * 8
    # an actor-learner layout: env shards along "env", replicas along "model"
    mesh2 = make_mesh((2, 4), ("env", "model"), CPU8)
    assert mesh2.shape == {"env": 2, "model": 4}
    assert [i for i, _ in mesh2.local_shards()] == [0, 1]
    assert [s.shape[0] for s in shard_states(states, mesh2)] == [4, 4]
    # across processes each rank owns a contiguous block of the entries; this
    # process (rank 0 of 2) owns the first four shards and only those
    spanning = tmesh.Mesh(mesh.devices, mesh.axis_names, np.repeat(np.arange(2), 4))
    assert not spanning.is_local
    assert [i for i, _ in spanning.local_shards()] == [0, 1, 2, 3]
    assert torch.equal(torch.cat(shard_states(states, spanning)), states[:4])


def test_local_mesh_is_one_shard_of_this_process():
    mesh = tmesh.local_mesh("cpu")
    assert mesh.shape == {"env": 1} and mesh.is_local and mesh.local_shards() == [(0, torch.device("cpu"))]


def test_indivisible_batch_raises_as_jax():
    with pytest.raises(ValueError) as jerr:
        JShardedGoEnv(jconfig.EnvConfig(board_size=7, batch_size=12), jmake_mesh())
    with pytest.raises(ValueError) as terr:
        ShardedGoEnv(tconfig.EnvConfig(board_size=7, batch_size=12), make_mesh(devices=CPU8))
    assert str(terr.value) == str(jerr.value) == "batch_size 12 not divisible by env axis 8"
    with pytest.raises(ValueError, match="batch_size 12 not divisible by env axis 8"):
        shard_states(torch.zeros((12, 6, 7, 7), dtype=torch.int8), make_mesh(devices=CPU8))
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(devices=[])


@pytest.mark.parametrize("device_type, procs, pid, cards, environ, expected", [
    ("cpu", 2, 1, 0, {}, ("gloo", None)),
    ("cuda", 2, 1, 1, {}, ("gloo", None)),  # two ranks on one card: NCCL refuses them
    ("cuda", 2, 1, 2, {}, ("nccl", 1)),
    ("cuda", 4, 3, 1, {"LOCAL_WORLD_SIZE": "1", "LOCAL_RANK": "0"}, ("nccl", 0)),  # 4 hosts, 1 card each
    ("cuda", 8, 5, 4, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, ("nccl", 1)),  # 2 hosts, 4 cards each
    ("cuda", 8, 5, 2, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, ("gloo", None)),
])
def test_backend_follows_the_ranks_on_this_host(device_type, procs, pid, cards, environ, expected, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tmesh.dist, "is_nccl_available", lambda: True)
    assert tmesh._backend(device_type, procs, pid, environ) == expected


def test_mesh_config_matches_jax():
    jfields = [(f.name, f.default) for f in dataclasses.fields(jconfig.MeshConfig)]
    tfields = [(f.name, f.default) for f in dataclasses.fields(tconfig.MeshConfig)]
    assert tfields == jfields == [("axis_names", ("env",)), ("axis_sizes", None)]
    assert tconfig.MeshConfig().axis_names == jconfig.MeshConfig().axis_names


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set_leaf(tree, path, value):
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _set_leaf(tree[path[0]], path[1:], value)
    return out


@pytest.mark.parametrize("channels", [8, 128])
def test_param_shardings_match_jax(channels):
    """On a (2 env x 4 model) mesh: the same tensors are split, on the output
    dim (flax's last, the port's first), and the port's block j is the
    conversion of flax's block j."""
    jcfg = jaz.AZNetConfig(board_size=5, channels=channels, blocks=1, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jaz.init_params(jax.random.PRNGKey(0), jcfg))["params"]
    jspecs = jaz.param_shardings(params, jmake_mesh((2, 4), ("env", "model")))
    tcfg = AZNetConfig(board_size=5, channels=channels, blocks=1, dtype=torch.float32)
    net = AZNet(tcfg)
    tspecs = param_shardings(net, make_mesh((2, 4), ("env", "model"), CPU8))
    assert set(tspecs) == set(net.state_dict())
    # convert's name map, from leaves that each hold their own index
    paths = [p for p, _ in _leaves_with_paths(params)]
    marked = params
    for i, p in enumerate(paths):
        marked = _set_leaf(marked, p, np.full(dict(_leaves_with_paths(params))[p].shape, i, np.float32))
    name_of = {}
    for name, t in convert.aznet_state_dict_from_flax(marked, tcfg).items():
        name_of[paths[int(t.flatten()[0])]] = name
    assert len(name_of) == len(paths) == len(tspecs)
    full = convert.aznet_state_dict_from_flax(params, tcfg)
    n_split = 0
    for path, leaf in _leaves_with_paths(params):
        spec = dict(_leaves_with_paths(jspecs))[path].spec
        name = name_of[path]
        if spec == jax.sharding.PartitionSpec():
            assert tspecs[name] is None, name
            continue
        assert tuple(spec) == (None,) * (leaf.ndim - 1) + ("model",), name
        assert tspecs[name] == 0 and full[name].shape[0] == leaf.shape[-1], name
        n_split += 1
        for j in range(4):
            block = np.zeros_like(leaf)
            keep = np.split(np.arange(leaf.shape[-1]), 4)[j]
            block[..., keep] = leaf[..., keep]
            got = convert.aznet_state_dict_from_flax(_set_leaf(params, path, block), tcfg)[name]
            part = shard_state_dict(full, tspecs, j, 4)[name]
            assert torch.equal(got[keep], part) and not got[np.setdiff1d(np.arange(len(got)), keep)].any()
    # every conv (8 policy and value channels too) and the value hidden layer
    assert n_split == 6
    replicated_part = shard_state_dict(full, tspecs, 3, 4)
    assert replicated_part["stem_norm.weight"] is full["stem_norm.weight"]
