"""gymgo_tpu_torch.rl.replay against gymgo_tpu.rl.replay, bit for bit: the
same rows added (wrapping past the capacity), the same indices sampled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.rl.replay import ReplayBuffer as JReplayBuffer
from gymgo_tpu_torch.rl.replay import ReplayBuffer, ReplayState

N = 5


def _rows(rng, m):
    obs = rng.integers(0, 2, (m, 6, N, N)).astype(np.int8)
    policy = rng.random((m, N * N + 1)).astype(np.float32)
    value = rng.choice([-1.0, 1.0], m).astype(np.float32)
    mask = rng.random(m) < 0.8
    return obs, policy, value, mask, mask & (rng.random(m) < 0.5)


def _assert_state_equal(t, j):
    for name, got, want in zip(ReplayState._fields, t, j):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got, want, err_msg=name)
        if got.ndim:
            assert got.dtype == want.dtype, name


@pytest.mark.parametrize("capacity", [32, 50])
def test_add_and_sample_match_jax(capacity):
    rng = np.random.default_rng(capacity)
    jbuf, tbuf = JReplayBuffer(capacity, N), ReplayBuffer(capacity, N, device="cpu")
    js, ts = jbuf.init(), tbuf.init()
    key = jax.random.PRNGKey(capacity)
    for m, with_vmask in ((12, True), (20, False), (17, True), (9, False)):  # wraps past the capacity
        obs, policy, value, mask, vmask = _rows(rng, m)
        js = jbuf.add(js, jnp.asarray(obs), policy, value, mask, vmask if with_vmask else None)
        ts = tbuf.add(ts, *(torch.from_numpy(x) for x in (obs, policy, value, mask)),
                      torch.from_numpy(vmask) if with_vmask else None)
        _assert_state_equal(ts, js)
        key, sub = jax.random.split(key)
        want = jbuf.sample(js, sub, 64)
        idx = np.array(jax.random.randint(sub, (64,), 0, jnp.maximum(js.filled, 1)))  # replay.py's draw
        got = tbuf.sample(ts, None, 64, indices=torch.from_numpy(idx))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(ts.filled) == capacity and int(ts.cursor) == 58 % capacity


def test_add_defaults_and_generator_sample():
    buf = ReplayBuffer(16, N, device="cpu")
    st = buf.init()
    g = torch.Generator().manual_seed(0)
    obs, policy, value, _, _ = _rows(np.random.default_rng(0), 5)
    st = buf.add(st, torch.from_numpy(obs), torch.from_numpy(policy), torch.from_numpy(value))
    assert st.mask[:5].all() and st.vmask[:5].all() and not st.mask[5:].any()
    samples = buf.sample(st, g, 4096)
    seen = {int(x) for x in samples[2].ne(0).nonzero()[:, 0]}
    assert samples[0].shape == (4096, 6, N, N) and samples[0].dtype == torch.int8
    # uniform over the 5 filled rows, none beyond
    rows = (samples[1][:, None, :] == st.policy[None, :, :]).all(-1).to(torch.int64).argmax(1)
    counts = torch.bincount(rows, minlength=16)
    assert (counts[5:] == 0).all() and (counts[:5] > 700).all() and len(seen) > 0
    empty = buf.sample(buf.init(), g, 8)  # an empty buffer samples row 0
    assert empty[0].shape == (8, 6, N, N)


@pytest.mark.parametrize("capacity,adds", [(8, (13,)), (64, (81,)), (8, (3, 13, 21)), (64, (40, 81, 64, 5))])
def test_add_of_more_rows_than_the_capacity_matches_jax(capacity, adds):
    """An add of M > capacity rows keeps, in every slot, the last row of the
    add that reached it (JAX's ``.at[].set`` keeps the last write on the
    CPU), and advances the cursor by M."""
    rng = np.random.default_rng(capacity + len(adds))
    jbuf, tbuf = JReplayBuffer(capacity, N), ReplayBuffer(capacity, N, device="cpu")
    js, ts = jbuf.init(), tbuf.init()
    for m in adds:
        obs, policy, value, mask, vmask = _rows(rng, m)
        js = jbuf.add(js, jnp.asarray(obs), policy, value, mask, vmask)
        ts = tbuf.add(ts, *(torch.from_numpy(x) for x in (obs, policy, value, mask, vmask)))
        _assert_state_equal(ts, js)
    # the last add's final rows sit where the cursor left them
    tail = min(adds[-1], capacity)
    slots = (int(ts.cursor) - tail + np.arange(tail)) % capacity
    np.testing.assert_array_equal(ts.policy.numpy()[slots], policy[-tail:])
    np.testing.assert_array_equal(ts.obs.numpy()[slots], obs[-tail:])
    assert int(ts.cursor) == sum(adds) % capacity and int(ts.filled) == min(sum(adds), capacity)
