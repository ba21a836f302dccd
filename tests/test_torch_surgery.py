"""gymgo_tpu_torch.models.surgery against gymgo_tpu.models.surgery.

``zero_moments_for`` on moments carried from an optax state, and
``widen_deepen`` at ``noise_scale=0`` on carried weights, are compared bit for
bit (the new blocks' fresh convolutions are random draws, held to their
statistics); the grown net computes its parent's function within atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.models import surgery as jsurgery
from gymgo_tpu.rl import learner as jlearner
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models import surgery as tsurgery
from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
from gymgo_tpu_torch.rl import learner as tlearner
from test_torch_learner import _batch, _state_dict
from torch_boards import midgame_states

N = 5


def _jax_net(channels, blocks, seed):
    cfg = jaz.AZNetConfig(board_size=N, channels=channels, blocks=blocks, dtype=jnp.float32)
    leaves, treedef = jax.tree_util.tree_flatten(jaz.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    tcfg = AZNetConfig(board_size=N, channels=channels, blocks=blocks, dtype=torch.float32)
    tnet = init_params(torch.Generator().manual_seed(0), tcfg)
    tnet.load_state_dict(convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return cfg, params, tcfg, tnet


def test_zero_moments_for_matches_jax_on_carried_moments():
    cfg, params, tcfg, tnet = _jax_net(16, 1, 1)
    apply_fn = jaz.AZNet(cfg).apply
    state, tx = jlearner.make_train_state(params, learning_rate=1e-3)
    step = jax.jit(lambda s, b: jlearner.train_step(s, tx, apply_fn, b))
    for i in range(2):
        state, _ = step(state, tuple(jnp.asarray(x) for x in _batch(m=16, seed=i)))
    adam = state.opt_state[0]
    mu, nu = _state_dict(adam.mu, tcfg), _state_dict(adam.nu, tcfg)
    opt = tlearner.make_train_state(tnet).optimizer
    for name, p in tnet.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": torch.from_numpy(mu[name].copy()),
                        "exp_avg_sq": torch.from_numpy(nu[name].copy())}
    zeroed = jsurgery.zero_moments_for(state.opt_state, state.params)[0]
    tsurgery.zero_moments_for(opt, tnet)
    zmu, znu = _state_dict(zeroed.mu, tcfg), _state_dict(zeroed.nu, tcfg)
    heads = 0
    for name, p in tnet.named_parameters():
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), zmu[name], err_msg=name)
        np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), znu[name], err_msg=name)
        assert float(opt.state[p]["step"]) == 2.0  # the count stays
        if name.split(".")[0] in tsurgery.VALUE_HEAD_KEYS:
            heads += 1
            assert not opt.state[p]["exp_avg"].any()
        else:
            assert opt.state[p]["exp_avg_sq"].any()
    assert heads == 6


@pytest.mark.parametrize("new_ch,new_blocks", [(128, 2), (64, 2), (128, 1)])
def test_widen_deepen_at_zero_noise_matches_jax(new_ch, new_blocks):
    cfg, params, tcfg, tnet = _jax_net(64, 1, 2)
    new_cfg = dataclasses.replace(cfg, channels=new_ch, blocks=new_blocks)
    grown_j = jsurgery.widen_deepen(params, cfg, new_cfg, jax.random.PRNGKey(0), noise_scale=0.0)
    new_tcfg = dataclasses.replace(tcfg, channels=new_ch, blocks=new_blocks)
    grown_t = tsurgery.widen_deepen(tnet, new_tcfg, torch.Generator().manual_seed(0), noise_scale=0.0)
    want = _state_dict(grown_j, new_tcfg)
    got = {k: v.detach().numpy() for k, v in grown_t.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.startswith("blocks.1.") and got[k].ndim > 1:
            # a new block's convolution: a fresh draw in both packages
            assert abs(got[k].std() / want[k].std() - 1) < 0.25, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    obs = torch.from_numpy(midgame_states(N, 16, 10, 5))
    with torch.no_grad():
        for a, b in zip(tnet(obs), grown_t(obs)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-4)


def test_widen_with_noise_breaks_symmetry_and_stays_close():
    _, _, tcfg, tnet = _jax_net(64, 1, 3)
    new = dataclasses.replace(tcfg, channels=128, blocks=2)
    grown = tsurgery.widen_deepen(tnet, new, torch.Generator().manual_seed(1), noise_scale=1e-2)
    w = grown.blocks[0].conv_0.weight
    assert not torch.equal(w[:, 0], w[:, 8])  # channel 8 copies channel 0 (group size 8, r = 2)
    obs = torch.from_numpy(midgame_states(N, 16, 10, 6))
    with torch.no_grad():
        np.testing.assert_allclose(grown(obs)[0].numpy(), tnet(obs)[0].numpy(), rtol=0, atol=0.2)
    with pytest.raises(ValueError):
        tsurgery.widen_deepen(tnet, dataclasses.replace(tcfg, channels=96), torch.Generator())


def test_reinit_value_head_keeps_the_trunk_and_zeroes_the_value():
    _, _, _, tnet = _jax_net(16, 1, 4)
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    obs = torch.from_numpy(midgame_states(N, 8, 10, 7))
    with torch.no_grad():
        logits_before = tnet(obs)[0]
    tsurgery.reinit_value_head(tnet, torch.Generator().manual_seed(3))
    after = tnet.state_dict()
    for k in before:
        head = k.split(".")[0] in tsurgery.VALUE_HEAD_KEYS
        if k.startswith("value_out"):
            assert not after[k].any()
        elif head and k.endswith("weight"):
            assert not torch.equal(after[k], before[k])
        elif not head:
            assert torch.equal(after[k], before[k]), k
    with torch.no_grad():
        logits, value = tnet(obs)
    assert torch.equal(logits, logits_before) and not value.any()
