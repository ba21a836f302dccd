"""The sharded step and rollout make no collective (the counterpart of
``tests/test_zero_collective.py``, which finds none in JAX's compiled HLO).

Inside an initialized one-rank gloo group, every collective of
``torch.distributed`` is wrapped in a counter.  The step and the rollout run on
a local 8-shard mesh, and on a mesh that spans two ranks of which this process
is rank 0 (it steps shards 0-3 and returns them as a list): no call either
way, while the checksums' one all-reduce is seen.  Weak scaling: each shard's
call, and each flood inside it, sees batch / 8 rows, never the global batch.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.env import batch_env as tenv
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh
from gymgo_tpu_torch.parallel import mesh as tmesh
from torch_boards import midgame_states

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
               "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
               "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "scatter", "scatter_object_list", "send")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def counted_group(monkeypatch):
    """A one-rank gloo group; yields {collective name: calls}."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    calls = dict.fromkeys(COLLECTIVES, 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in COLLECTIVES:
        monkeypatch.setattr(dist, name, counting(name, getattr(dist, name)))
    try:
        yield calls
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def _two_rank_mesh():
    """An 8-shard mesh over two ranks, seen from rank 0."""
    local = make_mesh(devices=["cpu"] * 8)
    return tmesh.Mesh(local.devices, local.axis_names, np.repeat(np.arange(2), 4))


@pytest.mark.parametrize("spanning", [False, True])
def test_sharded_step_and_rollout_make_no_collective(counted_group, spanning):
    n, b, steps = 9, 32, 16
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    mesh = _two_rank_mesh() if spanning else make_mesh(devices=["cpu"] * 8)
    assert mesh.is_local == (not spanning) and dist.get_world_size() == 1
    env = ShardedGoEnv(cfg, mesh)
    start = torch.from_numpy(midgame_states(n, b, 40, 3))
    states, res = env.step(start, torch.full((b,), n * n, dtype=torch.int32))
    r = env.rollout(torch.Generator().manual_seed(0), states, steps)
    assert sum(counted_group.values()) == 0, counted_group
    # the same rows as the unsharded rollout; a spanning mesh leaves this rank's shards
    plain_states, _ = tenv.batch_step(start, torch.full((b,), n * n, dtype=torch.int32), cfg)
    plain = tenv.rollout(torch.Generator().manual_seed(0), plain_states, steps, cfg)
    if spanning:
        assert isinstance(r.final_states, list) and len(r.final_states) == 4 and len(states) == 4
        assert torch.equal(torch.cat(r.final_states), plain.final_states[: b // 2])
        assert torch.equal(torch.cat(r.actions, dim=1), plain.actions[:, : b // 2])
    else:
        assert torch.equal(r.final_states, plain.final_states) and torch.equal(r.actions, plain.actions)
    # the user-level reduction is the one collective, and only across ranks
    env.checksums(r)
    assert counted_group["all_reduce"] == (1 if spanning else 0)


@pytest.mark.parametrize("batch", [16, 64])
def test_weak_scaling_per_shard_shapes(batch, monkeypatch):
    """Each shard's step, and the flood inside it, takes (batch / 8) rows."""
    cfg = EnvConfig(board_size=7, batch_size=batch, auto_reset=True)
    mesh = make_mesh(devices=["cpu"] * 8)
    step_shapes, flood_shapes = [], []

    def step(s, a):
        step_shapes.append((tuple(s.shape), tuple(a.shape)))
        return tenv.batch_step(s, a, cfg)

    plain_flood = tbundle.bundle_flood_plain
    monkeypatch.setattr(tbundle, "bundle_flood_plain",
                        lambda a, b: flood_shapes.append(tuple(a.shape)) or plain_flood(a, b))
    states = torch.zeros((batch, 6, 7, 7), dtype=torch.int8)
    out, _ = tenv.shard_over_envs(step, mesh)(states, torch.zeros((batch,), dtype=torch.int32))
    per = batch // 8
    assert step_shapes == [((per, 6, 7, 7), (per,))] * 8
    assert flood_shapes and set(flood_shapes) == {(per, 7, 7)}
    assert out.shape == (batch, 6, 7, 7)
    flood_shapes.clear()
    tenv.rollout(torch.Generator().manual_seed(0), states, 3, cfg, mesh=mesh)
    assert len(flood_shapes) == 8 * (3 + 1) and set(flood_shapes) == {(per, 7, 7)}
