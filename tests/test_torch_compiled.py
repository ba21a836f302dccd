"""The port's compiled forms (``utils.graphs.compiled``) against the JAX
package's jitted ones, on the CPU, where a compiled form calls its function
as it is: ``BatchGoEnv.step`` and ``.rollout`` against JAX's ``BatchGoEnv``
bit for bit (the actions handed across), ``make_jitted_train_step`` against
JAX's within the learner's atols (loss 1e-5, parameters 2e-6: the two
libraries sum the gradients in another order, and Adam normalizes each update
to about the learning rate; the entries whose gradient is 0 but for rounding
within 2 lr a step), and ``gogame``'s six compiled functions against
JAX's ``_*_jit`` bit for bit.  Then the graphs' key and replay with stand-ins
for the capture, which needs a card (``tests/test_torch_cuda.py`` runs it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu import gogame as jgogame
from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.env import batch_env as jenv
from gymgo_tpu.models import az_net as jaz
from gymgo_tpu.rl import learner as jlearner
from gymgo_tpu_torch import convert
from gymgo_tpu_torch import gogame as tgogame
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.env import batch_env as tenv
from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig
from gymgo_tpu_torch.ops import cuda_lib
from gymgo_tpu_torch.parallel.mesh import make_mesh
from gymgo_tpu_torch.parallel.sharded_env import ShardedGoEnv
from gymgo_tpu_torch.rl import learner as tlearner
from gymgo_tpu_torch.utils import graphs, tracing
from torch_boards import midgame_states

LOSS_ATOL, PARAM_ATOL = 1e-5, 2e-6
# The stem's centre tap on the planes that are constant over a board (turn,
# pass, done): GroupNorm removes what they add, so their gradient is 0 but for
# rounding, which Adam scales up to about lr a step in either library.
CONSTANT_PLANES = (2, 4, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(n, b, reward):
    kw = dict(board_size=n, batch_size=b, reward_method=reward, auto_reset=True, komi=0.5)
    return JEnvConfig(**kw), EnvConfig(**kw)


@pytest.mark.parametrize("n,b,steps", [(5, 16, 60), (9, 8, 120)])
@pytest.mark.parametrize("reward", ["heuristic", "real"])
def test_batch_env_rollout_matches_jax(n, b, steps, reward):
    jcfg, tcfg = _configs(n, b, reward)
    start = midgame_states(n, b, n * n // 2, n)
    want = jenv.BatchGoEnv(jcfg).rollout(jax.random.PRNGKey(n), jnp.asarray(start), steps, collect_obs=True)
    assert np.asarray(want.dones).any(), "the window should end and auto-reset some games"
    it = iter(torch.from_numpy(np.array(want.actions)))
    env = tenv.BatchGoEnv(tcfg, device="cpu")
    got = env.rollout(env.generator(0), torch.from_numpy(start), steps, policy_fn=lambda _g, _s: next(it),
                      collect_obs=True)
    for field in ("actions", "rewards", "dones", "obs", "final_states"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    assert not got.invalid.any() and not env.compiled


@pytest.mark.parametrize("n,b", [(5, 16), (9, 8)])
def test_batch_env_step_matches_jax(n, b):
    jcfg, tcfg = _configs(n, b, "heuristic")
    jenv_, env = jenv.BatchGoEnv(jcfg), tenv.BatchGoEnv(tcfg, device="cpu")
    states = midgame_states(n, b, n * n, n + 1)
    key = jax.random.PRNGKey(n)
    for _ in range(3 * n):
        key, sub = jax.random.split(key)
        actions = np.array(jenv_.uniform_random_actions(sub, jnp.asarray(states)))
        actions[0] = n * n + 7  # out of range: rejected, the env frozen
        jstates, jres = jenv_.step(jnp.asarray(states), actions)
        tstates, tres = env.step(torch.from_numpy(states.copy()), actions.tolist())
        np.testing.assert_array_equal(tstates.numpy(), np.asarray(jstates))
        for field in ("obs", "reward", "done", "invalid_action", "num_captured", "black_area", "white_area"):
            np.testing.assert_array_equal(getattr(tres, field).numpy(), np.asarray(getattr(jres, field)),
                                          err_msg=field)
        assert bool(tres.invalid_action[0])
        states = np.asarray(jstates)


def test_uniform_random_actions_are_legal():
    _, tcfg = _configs(9, 32, "heuristic")
    env = tenv.BatchGoEnv(tcfg, device="cpu")
    states = torch.from_numpy(midgame_states(9, 32, 40, 3))
    acts = env.uniform_random_actions(env.generator(0), states)
    assert acts.dtype == torch.int32
    valid = env.valid_moves(states)
    assert bool((valid.gather(1, acts.long()[:, None]) == 1).all())


def _jax_and_port_nets(n, seed):
    """The same random float32 net (8 channels, 1 block) in both packages."""
    jcfg = jaz.AZNetConfig(board_size=n, channels=8, blocks=1, dtype=jnp.float32)
    params = jaz.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = AZNetConfig(board_size=n, channels=8, blocks=1, dtype=torch.float32)
    tnet = AZNet(tcfg)
    tnet.load_state_dict(convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jaz.AZNet(jcfg).apply, params, tnet


def _batch(n, m, seed):
    rng = np.random.default_rng(seed)
    obs = midgame_states(n, m, n * n // 2, seed)
    valid = np.concatenate([obs[:, 3].reshape(m, -1) == 0, np.ones((m, 1), bool)], 1)
    pi = np.where(valid, np.exp(2 * rng.standard_normal((m, n * n + 1))), 0.0)
    pi = (pi / pi.sum(1, keepdims=True)).astype(np.float32)
    v = rng.choice([-1.0, 0.0, 1.0], m).astype(np.float32)
    mask = rng.random(m) < 0.8
    return obs, pi, v, mask, mask & (rng.random(m) < 0.5)


def test_jitted_train_step_matches_jax():
    n = 5
    apply_fn, params, tnet = _jax_and_port_nets(n, seed=41)
    jstate, tx = jlearner.make_train_state(params, learning_rate=1e-3)
    jstep = jlearner.make_jitted_train_step(tx, apply_fn)
    tstate = tlearner.make_train_state(tnet, learning_rate=1e-3)
    tstep_ = tlearner.make_jitted_train_step(tstate)
    for i in range(2):
        batch = _batch(n, 40, i)
        # JAX's step binds tx and apply_fn by keyword, so its batch goes by keyword too
        jstate, jm = jstep(jstate, batch=tuple(jnp.asarray(x) for x in batch))
        tstate, tm = tstep_(tstate, tuple(torch.from_numpy(np.array(x)) for x in batch))
        for k in ("loss", "policy_loss", "value_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=LOSS_ATOL, err_msg=k)
    assert tstate.step == int(jstate.step) == 2
    want = convert.aznet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), tnet.config)
    moot = torch.zeros_like(tnet.stem.weight, dtype=torch.bool)
    moot[:, CONSTANT_PLANES, 1, 1] = True
    for name, p in tnet.state_dict().items():
        got, ref = p.numpy(), np.asarray(want[name])
        if name == "stem.weight":
            np.testing.assert_allclose(got[moot.numpy()], ref[moot.numpy()], rtol=0, atol=2 * 2 * 1e-3)
            got, ref = got[~moot.numpy()], ref[~moot.numpy()]
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL, err_msg=name)
    with pytest.raises(ValueError, match="another TrainState"):
        tstep_(tlearner.make_train_state(_jax_and_port_nets(n, seed=42)[2]), batch)


def test_trainer_learn_samples_and_steps_as_train_step():
    from gymgo_tpu_torch.train import Trainer, build_parser

    flags = ["--board", "5", "--envs", "8", "--channels", "8", "--blocks", "1", "--rollout-steps", "4",
             "--gumbel-sims", "4", "--train-batch", "16", "--replay-capacity", "48", "--cpu"]
    quiet = lambda *a, **k: None
    a, b = (Trainer(build_parser().parse_args(flags), log=quiet) for _ in range(2))
    for t in (a, b):
        t.store(t.selfplay())
    ma = a.learn()
    batch = b.buf.sample(b.buf_state, b.generator, 16)
    b.train_state, mb = tlearner.train_step(b.train_state, batch)
    assert float(ma["loss"]) == float(mb["loss"]) and a.train_state.step == b.train_state.step == 1
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _gogame_inputs(n):
    states = midgame_states(n, 6, n * n // 2, n).astype(np.int8)
    return states, np.random.default_rng(n).integers(0, n * n + 1, 6).astype(np.int32)


@pytest.mark.parametrize("n", [5, 9, 19])
@pytest.mark.parametrize("name", ["_step_states", "_batch_canonical", "_children_jit", "_areas_jit",
                                  "_num_liberties_jit", "_liberties_jit"])
def test_gogame_compiled_functions_match_jax(name, n):
    states, actions = _gogame_inputs(n)
    jfn, tfn = getattr(jgogame, name), getattr(tgogame, name)
    assert isinstance(tfn, graphs.Compiled)
    if name == "_step_states":
        calls = [((states, actions), {})]
    elif name == "_children_jit":
        calls = [((states[i],), {"canonical": c}) for i, c in ((0, False), (1, True))]
    else:
        calls = [((states,), {})]
    for args, kw in calls:
        want = jfn(*(jnp.asarray(x) for x in args), **kw)
        got = tfn(*(torch.from_numpy(x.copy()) for x in args), **kw)
        want_leaves = jax.tree_util.tree_leaves(want)
        got_leaves = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert len(got_leaves) == len(want_leaves) and all(isinstance(g, torch.Tensor) for g in got_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_tensors_call_the_function_as_it_is():
    out = torch.ones(3)
    fn = graphs.compiled(lambda x, k: out, static_argnames=("k",))
    assert fn(torch.zeros(3), k=1) is out and not fn.graphs
    with pytest.raises(ValueError, match="static_argnames"):
        graphs.compiled(lambda x: x, static_argnames=("y",))
    with pytest.raises(TypeError, match="static_argnames"):
        graphs.compiled(lambda x, y: x)(torch.zeros(3), 4.0)


class _Recorded:
    """A stand-in for a captured graph: records its replays."""

    def __init__(self, key):
        self.key = key
        self.replayed = []

    def replay(self, leaves):
        self.replayed.append(leaves)
        return "replayed"


@pytest.fixture
def recording(monkeypatch):
    """Every call takes the graph path (as on a card), and a capture is a
    stand-in: returns the list of captures made."""
    captures = []

    def capture(fn, call, device):
        captures.append(_Recorded(call.key))
        return "captured", captures[-1]

    monkeypatch.setattr(graphs, "_graph_device", lambda leaves: torch.device("cuda", 0))
    monkeypatch.setattr(graphs, "_capture", capture)
    return captures


def _switch(name):
    """A context-free change of one part of the key, undone by the returned
    function."""
    if name == "ablate":
        before = tstep.set_ablate({"areas"})
        return lambda: tstep.set_ablate(before)
    return lambda: None


@pytest.mark.parametrize("change", ["same", "generator", "shape", "dtype", "static", "structure", "ablate"])
def test_the_key_gives_a_new_graph_for_each_change_and_a_hit_otherwise(change, recording):
    fn = graphs.compiled(lambda g, x, steps, extra=None: None, static_argnames=("steps",))
    gen = torch.Generator()
    assert fn(gen, torch.zeros(4, 3), steps=8) == "captured"
    args = {"g": gen, "x": torch.ones(4, 3), "steps": 8}  # other values: the same key
    if change == "generator":  # another generator on the same device: its state is an input
        args["g"] = torch.Generator().manual_seed(5)
    elif change == "shape":
        args["x"] = torch.zeros(5, 3)
    elif change == "dtype":
        args["x"] = torch.zeros(4, 3, dtype=torch.int8)
    elif change == "static":
        args["steps"] = 16
    elif change == "structure":
        args["extra"] = (torch.zeros(2),)
    undo = _switch(change)
    try:
        out = fn(**args)
        again = fn(**args)
    finally:
        undo()
    if change in ("same", "generator"):
        assert out == again == "replayed" and len(recording) == 1 and len(recording[0].replayed) == 2
        assert recording[0].replayed[0][0] is args["g"] and torch.equal(recording[0].replayed[0][1], args["x"])
    else:
        assert out == "captured" and again == "replayed" and len(recording) == 2 and len(fn.graphs) == 2
        assert recording[0].key != recording[1].key


def test_a_replay_copies_its_inputs_in_counts_the_captured_launches_and_returns_clones():
    lib = cuda_lib.CudaKernelLib(cuda_lib.CSRC / "bundle_flood.cu", "unused", ())
    try:
        static_in = [torch.Generator(), torch.zeros(3)]
        seen = []

        class Graph:  # draws from the graph's generator and reads the static tensor, as a replay would
            def replay(self):
                seen.append((static_in[1].clone(), torch.rand(2, generator=static_in[0])))

        static_out = {"y": torch.arange(3.0), "n": None}
        table = tracing.LayerTable(tracing.new_graph_id(), 7, 5, [("", 0, 4)], {lib.counter: 2}, True)
        captured = graphs.CapturedGraph(Graph(), static_in, static_out, table, 0.5)
        caller = torch.Generator().manual_seed(1)
        out = captured.replay([caller, torch.full((3,), 4.0)])
        eager = torch.Generator().manual_seed(1)
        assert torch.equal(seen[0][1], torch.rand(2, generator=eager))  # the caller's draws
        assert torch.equal(caller.get_state(), eager.get_state())  # and the caller advanced as eager would
        assert lib.launches == 2 and torch.equal(seen[0][0], torch.full((3,), 4.0))
        assert out["n"] is None and torch.equal(out["y"], static_out["y"]) and out["y"] is not static_out["y"]
        captured.replay([caller, torch.ones(3)])
        assert lib.launches == 4 and captured.replays == 2 and torch.equal(seen[1][0], torch.ones(3))
        assert captured.nodes == 7 and captured.table.ops == 5
    finally:
        del tracing.counters[lib.counter]


def test_capturable_and_the_envs_compiled_flags():
    assert all(tflood.capturable(n) for n in (9, 19, 22, 23, 25, 32, 33, 181)) and not tflood.capturable(182)
    cfg = EnvConfig(board_size=9, batch_size=8, reward_method="heuristic", auto_reset=True)
    assert not tenv.BatchGoEnv(cfg, device="cpu").compiled
    sharded = ShardedGoEnv(cfg, make_mesh(devices=[torch.device("cpu")] * 2))
    assert not sharded.compiled
    r = sharded.rollout(torch.Generator().manual_seed(0), sharded.reset(), 6)
    want = tenv.rollout(torch.Generator().manual_seed(0), torch.cat(sharded.reset()), 6, cfg)
    assert torch.equal(r.final_states, want.final_states) and torch.equal(r.actions, want.actions)
