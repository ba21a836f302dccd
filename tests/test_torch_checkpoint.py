"""Checkpoints: the port's trainer tree round-trips bit for bit, and a
``train.py`` checkpoint of the JAX package (written here with its own
``save_npz``, in both replay layouts) carries into the port, read with numpy
alone: the replay, env states and counters bit for bit, the parameters and
moments through their permutations bit for bit, and one AdamW step from the
carried state within the atols of ``test_torch_learner.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core.state import batch_init_state as jbatch_init_state
from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.rl import learner as jlearner
from gymgo_tpu.rl.replay import ReplayBuffer as JReplayBuffer
from gymgo_tpu.utils import checkpoint as jckpt
from gymgo_tpu_torch import convert
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.rl import learner as tlearner
from gymgo_tpu_torch.train import Trainer, build_parser, restore_learner
from gymgo_tpu_torch.utils import checkpoint as tckpt
from gymgo_tpu_torch.utils import profiling
from test_torch_learner import LOSS_ATOL, MOMENT_ATOL, PARAM_ATOL, _batch, _state_dict
from torch_boards import midgame_states

N, CH, BLOCKS, ENVS, CAP = 5, 16, 1, 6, 40


def _jax_checkpoint(path, old_buf=False, with_target=True):
    """A tree as the JAX package's train.py saves it, after two updates and
    two replay adds; returns what it saved."""
    cfg = jaz.AZNetConfig(board_size=N, channels=CH, blocks=BLOCKS, dtype=jnp.float32)
    apply_fn = jaz.AZNet(cfg).apply
    params = jaz.init_params(jax.random.PRNGKey(1), cfg)
    state, tx = jlearner.make_train_state(params, learning_rate=1e-3)
    step = jax.jit(lambda s, b: jlearner.train_step(s, tx, apply_fn, b))
    buf = JReplayBuffer(CAP, N)
    bs = buf.init()
    for i in range(2):
        batch = _batch(m=24, seed=i)
        state, _ = step(state, tuple(jnp.asarray(x) for x in batch))
        bs = buf.add(bs, jnp.asarray(batch[0]), *batch[1:])
    tree = {"params": state.params, "opt_state": state.opt_state, "step": state.step,
            "buf": (bs.obs, bs.policy, bs.value, bs.mask, bs.cursor, bs.filled) if old_buf else bs,
            "env_states": jnp.asarray(midgame_states(N, ENVS, 8, 2)), "key": jax.random.PRNGKey(5),
            "iteration": jnp.asarray(7)}
    if with_target:
        tree["target_params"] = params
    jckpt.save_npz(str(path), tree)
    return apply_fn, tx, state, bs, tree


def _args(*extra):
    return build_parser().parse_args(["--board", str(N), "--channels", str(CH), "--blocks", str(BLOCKS), "--envs",
                                      str(ENVS), "--replay-capacity", str(CAP), "--cpu", *extra])


@pytest.mark.parametrize("old_buf,with_target", [(False, True), (True, False)])
def test_jax_train_checkpoint_carries_and_trains_on(tmp_path, old_buf, with_target):
    path = tmp_path / "jax.npz"
    apply_fn, tx, jstate, jbuf, jtree = _jax_checkpoint(path, old_buf, with_target)
    tree = convert.trainer_tree_from_jax_npz(path)
    cfg = AZNetConfig(board_size=N, channels=CH, blocks=BLOCKS, dtype=torch.float32)
    for name in ("obs", "policy", "value", "mask", "cursor", "filled"):
        np.testing.assert_array_equal(tree["buf"][name], np.asarray(getattr(jbuf, name)), err_msg=name)
    np.testing.assert_array_equal(tree["buf"]["vmask"], np.asarray(jbuf.mask if old_buf else jbuf.vmask))
    np.testing.assert_array_equal(tree["env_states"], np.asarray(jtree["env_states"]))
    assert int(tree["iteration"]) == 7 and int(tree["step"]) == 2 and float(tree["opt_state"]["step"]) == 2
    assert "generator" not in tree
    adam = jstate.opt_state[0]
    for key, want in (("params", jstate.params), ("target_params", jtree.get("target_params", jstate.params))):
        for k, v in _state_dict(want, cfg).items():
            np.testing.assert_array_equal(tree[key][k], v, err_msg=k)
    for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for k, v in _state_dict(want, cfg).items():
            np.testing.assert_array_equal(tree["opt_state"][key][k], v, err_msg=k)

    # one more step on both sides, from the carried state, on the same sample
    ts = restore_learner(tlearner.make_train_state(AZNet(cfg, torch.float32), learning_rate=1e-3), tree)
    idx = np.array([0, 3, 5, 9, 11, 17, 20, 21, 30, 47, 2, 8], np.int64) % int(tree["buf"]["filled"])
    jvmask = jbuf.mask if old_buf else jbuf.vmask  # the 6-leaf file restores with vmask = mask, in JAX too
    jb = tuple(jnp.asarray(np.asarray(x)[idx]) for x in (jbuf.obs, jbuf.policy, jbuf.value, jbuf.mask, jvmask))
    jstate, jm = jlearner.train_step(jstate, tx, apply_fn, jb)
    ts, tm = tlearner.train_step(ts, tuple(torch.from_numpy(np.asarray(tree["buf"][k])[idx]) for k in
                                         ("obs", "policy", "value", "mask", "vmask")))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0, atol=LOSS_ATOL)
    got = {k: v.detach().numpy() for k, v in ts.net.state_dict().items()}
    for k, v in _state_dict(jstate.params, cfg).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
    mu = _state_dict(jstate.opt_state[0].mu, cfg)
    for name, p in ts.net.named_parameters():
        np.testing.assert_allclose(ts.optimizer.state[p]["exp_avg"].numpy(), mu[name], rtol=0, atol=MOMENT_ATOL)
        assert float(ts.optimizer.state[p]["step"]) == 3.0

    # the CLI's trainer resumes the file and goes on (seeded from --seed)
    logs = []
    trainer = Trainer(_args("--resume", str(path), "--iters", "8", "--rollout-steps", "2", "--gumbel-sims", "2",
                            "--train-batch", "16"), log=lambda *a, **k: logs.append(" ".join(map(str, a))))
    assert trainer.iteration == 7 and "JAX key" in " ".join(logs)
    np.testing.assert_array_equal(trainer.states.numpy(), np.asarray(jtree["env_states"]))
    trainer.run()
    assert trainer.iteration == 8 and trainer.train_state.step == 3 and int(trainer.buf_state.filled) == 40


def test_trainer_tree_round_trips_bit_for_bit(tmp_path):
    trainer = Trainer(_args("--iters", "1", "--rollout-steps", "2", "--gumbel-sims", "2", "--train-batch", "8"),
                      log=lambda *a, **k: None)
    trainer.run()
    tree = trainer.tree()
    path = tmp_path / "port.npz"
    tckpt.save_npz(path, tree)
    back = tckpt.restore_npz(path)
    flat = lambda t, p="": ([x for k, v in t.items() for x in flat(v, f"{p}{k}/")] if isinstance(t, dict)
                            else [(p, np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t))])
    pairs = dict(flat(back))
    assert len(pairs) == len(flat(tree)) > 40
    for name, want in flat(tree):
        np.testing.assert_array_equal(pairs[name], want, err_msg=name)
        assert pairs[name].dtype == want.dtype, name
    other = Trainer(_args("--iters", "1", "--seed", "9"), log=lambda *a, **k: None)
    other.restore(back)
    for name, want in flat(other.tree()):
        np.testing.assert_array_equal(pairs[name], want, err_msg=name)
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.save_npz(tmp_path / "x.npz", {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="'/'"):
        tckpt.save_npz(tmp_path / "x.npz", {"a/b": np.zeros(2)})


def test_profiling_helpers():
    x = torch.arange(6, dtype=torch.int32)
    assert profiling.force({"a": [None, x]}) == 15.0 and profiling.force(3) == 0.0
    assert profiling.time_fn(lambda: x * 2, reps=2) >= 0.0
    meter = profiling.Meter()
    assert meter.update(100) > 0


def test_a_card_generator_resumes_on_the_cpu_seeded_from_seed(tmp_path):
    """A checkpoint whose generator is a card's (a 16-byte state) resumes under
    ``--cpu`` with a note and the generator seeded from ``--seed``; so does
    one that does not say its device type (written before it was stored)."""
    flags = ("--rollout-steps", "2", "--gumbel-sims", "2", "--train-batch", "8", "--seed", "3", "--iters")
    trainer = Trainer(_args(*flags, "1"), log=lambda *a, **k: None)
    trainer.run()
    tree = trainer.tree()
    assert str(tree["generator_device"]) == "cpu"
    card_state = np.arange(16, dtype=np.uint8)
    for marked in (True, False):
        card = dict(tree, generator=card_state)
        if marked:
            card["generator_device"] = np.str_("cuda")
        else:
            del card["generator_device"]
        path = tmp_path / f"card_{marked}.npz"
        tckpt.save_npz(path, card)
        logs = []
        resumed = Trainer(_args(*flags, "2", "--resume", str(path)),
                          log=lambda *a, **k: logs.append(" ".join(map(str, a))))
        fresh = Trainer(_args(*flags, "2"), log=lambda *a, **k: None)
        assert any("not one of a cpu generator" in line and "--seed 3" in line for line in logs), logs
        assert torch.equal(resumed.generator.get_state(), fresh.generator.get_state())
        assert resumed.iteration == 1 and torch.equal(resumed.states, trainer.states)
        resumed.run()
        assert resumed.iteration == 2
