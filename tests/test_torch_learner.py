"""gymgo_tpu_torch.rl.learner and the trainer's parameters against
gymgo_tpu.rl.learner and flax.

The loss of the same float32 net on the same batch agrees within atol 1e-5;
three AdamW steps from the same parameters agree with ``optax.adamw`` in the
parameters within atol 2e-6 and in both moments within atol 1e-6 (the
gradients' sums round differently in the two libraries; Adam normalizes each
update to about the learning rate, 1e-3 here).  ``init_params`` draws as flax
does, which the statistics check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.rl import learner as jlearner
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig, acting_copy, init_params, refresh_
from gymgo_tpu_torch.rl import learner as tlearner
from test_torch_search import _nets
from torch_boards import midgame_states

N = 5
LOSS_ATOL = 1e-5
PARAM_ATOL, MOMENT_ATOL = 2e-6, 1e-6


def _batch(m=48, seed=0):
    rng = np.random.default_rng(seed)
    obs = midgame_states(N, m, 12, seed)
    logits = rng.standard_normal((m, N * N + 1)).astype(np.float32) * 2
    valid = np.concatenate([obs[:, 3].reshape(m, -1) == 0, np.ones((m, 1), bool)], 1)
    pi = np.where(valid, np.exp(logits), 0.0)
    pi = (pi / pi.sum(1, keepdims=True)).astype(np.float32)
    v = rng.choice([-1.0, 0.0, 1.0], m).astype(np.float32)
    mask = rng.random(m) < 0.8
    vmask = mask & (rng.random(m) < 0.5)
    return obs, pi, v, mask, vmask


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _state_dict(tree, cfg):
    return {k: v.numpy() for k, v in convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                                                         cfg).items()}


@pytest.mark.parametrize("with_vmask", [False, True])
def test_az_loss_matches_jax(with_vmask):
    apply_fn, params, tnet = _nets(N, seed=31)
    obs, pi, v, mask, vmask = _batch()
    vm = vmask if with_vmask else None
    jl, (jpi, jv) = jlearner.az_loss(params, apply_fn, jnp.asarray(obs), pi, v, mask,
                                     None if vm is None else jnp.asarray(vm))
    tl, (tpi, tv) = tlearner.az_loss(tnet, *_torch(obs, pi, v, mask), None if vm is None else _torch(vm)[0])
    for t, j in ((tl, jl), (tpi, jpi), (tv, jv)):
        assert t.dim() == 0
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=0, atol=LOSS_ATOL)
    # the value mask gates only the value term
    _, (pi_all, v_all) = tlearner.az_loss(tnet, *_torch(obs, pi, v, mask))
    assert float(pi_all) == float(tpi)
    if with_vmask:
        assert float(v_all) != float(tv)
    # no live row: both terms are 0 (denominators max(sum, 1))
    zero = tlearner.az_loss(tnet, *_torch(obs, pi, v, np.zeros_like(mask)))[0]
    assert float(zero) == 0.0


def test_three_adamw_steps_match_optax():
    apply_fn, params, tnet = _nets(N, seed=32)
    tnet.train()
    cfg = tnet.config
    jstate, tx = jlearner.make_train_state(params, learning_rate=1e-3)
    tstate = tlearner.make_train_state(tnet, learning_rate=1e-3)
    group = tstate.optimizer.param_groups[0]
    assert (group["weight_decay"], group["betas"], group["eps"]) == (1e-4, (0.9, 0.999), 1e-8)
    jstep = jax.jit(lambda s, b: jlearner.train_step(s, tx, apply_fn, b))
    for i in range(3):
        batch = _batch(seed=i)
        jstate, jm = jstep(jstate, tuple(jnp.asarray(x) for x in batch))
        tstate, tm = tlearner.train_step(tstate, _torch(*batch))
        for k in ("loss", "policy_loss", "value_loss"):
            assert tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=LOSS_ATOL)
    assert tstate.step == int(jstate.step) == 3
    want = _state_dict(jstate.params, cfg)
    got = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    adam = jstate.opt_state[0]
    mu, nu = _state_dict(adam.mu, cfg), _state_dict(adam.nu, cfg)
    for name, p in tnet.named_parameters():
        st = tstate.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name], rtol=0, atol=MOMENT_ATOL, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name], rtol=0, atol=MOMENT_ATOL, err_msg=name)
        moved = max(moved, float(np.abs(got[name] - _state_dict(params, cfg)[name]).max()))
    assert moved > 1e-3  # the parameters moved by about 3 learning rates


def test_init_params_draws_as_flax():
    cfg = AZNetConfig(board_size=9, channels=64, blocks=2)
    net = init_params(torch.Generator().manual_seed(0), cfg)
    jparams = jaz.init_params(jax.random.PRNGKey(0), jaz.AZNetConfig(board_size=9, channels=64, blocks=2))
    want = _state_dict(jparams, AZNetConfig(board_size=9, channels=64, blocks=2, dtype=torch.float32))
    for name, p in net.named_parameters():
        x = p.detach().numpy()
        assert p.dtype == torch.float32 and x.shape == want[name].shape, name
        if x.ndim > 1:
            fan_in = x[0].size
            bound = 2 * (1 / fan_in) ** 0.5 / 0.87962566103423978
            assert abs(x.std() / (1 / fan_in) ** 0.5 - 1) < 0.1, name
            assert np.abs(x).max() <= bound * (1 + 1e-6), name
            np.testing.assert_allclose(x.std(), want[name].std(), rtol=0.1)
        else:
            np.testing.assert_array_equal(x, want[name])  # ones / zeros, as flax


def test_bfloat16_copy_holds_the_rounded_master_and_trains_in_bfloat16():
    cfg = AZNetConfig(board_size=N, channels=16, blocks=1)
    net = init_params(torch.Generator().manual_seed(1), cfg)
    copy = acting_copy(net)
    for (name, p), q in zip(net.named_parameters(), copy.parameters()):
        want_dtype = torch.float32 if name.startswith("value_out") else torch.bfloat16
        assert q.dtype == want_dtype and not q.requires_grad
        assert torch.equal(q, p.detach().to(want_dtype))
    obs = torch.from_numpy(midgame_states(N, 8, 10, 3))
    with torch.no_grad():
        for a, b in zip(net(obs), copy(obs)):
            assert torch.equal(a, b)  # both compute in bfloat16 from the same rounded values
    state = tlearner.make_train_state(net, learning_rate=1e-2)
    before = [p.detach().clone() for p in net.parameters()]
    tlearner.train_step(state, _torch(*_batch(m=16))[:4])
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert any(not torch.equal(p, q) for p, q in zip(net.parameters(), before))
    refresh_(copy, net)
    assert torch.equal(copy.stem.weight, net.stem.weight.detach().to(torch.bfloat16))
    assert isinstance(copy, AZNet)
