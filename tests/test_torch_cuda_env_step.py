"""The env step's hand kernels (``ops/env_step.py``, ``csrc/env_step.cu``) on
a CUDA card against the op-by-op step they replace: every output equal bit
for bit on the carried path (one ``env_fused`` launch a step) and the
stateless path (the chain around the bundle flood), over random games and
hand-built positions; the compiled rollout, from played and from finished
boards, and a graphed Gumbel search equal to themselves with the plain step
in the kernels' place; the launches a step of each kernel; at most 4 device
operations a step in a captured window; the minmax route, boards over 22x22
and the ablations keep the plain step.
Imports no JAX (``python -m pytest --noconftest
tests/test_torch_cuda_env_step.py -m cuda``); every test skips where there is
no card.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from gymgo_tpu_torch.ops import env_step
from gymgo_tpu_torch.utils import graphs
from torch_boards import crafted_state

pytestmark = pytest.mark.cuda

_ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def _plain_step():
    """Every step of the block takes the op-by-op code."""
    saved = tstep.fused_step
    tstep.fused_step = lambda _boards: False
    try:
        yield
    finally:
        tstep.fused_step = saved


@contextlib.contextmanager
def _no_host_sync():
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def _equal(got, want, what):
    """Tensors (or tuples of them, None where one is None) equal bit for bit,
    float32 by their bits."""
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (x, y) in enumerate(zip(got, want)):
            _equal(x, y, f"{what}[{i}]")
        return
    if want is None:
        assert got is None, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if want.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


def _scripts(n):
    """Hand-built positions, each with three actions: ko taken, then refused;
    suicide refused; two groups captured at the edge, then a double pass;
    a pass after a pass; an occupied point and out-of-range actions; a
    finished board; a group without a liberty (which play never makes) and a
    cell of both colours beside it.  Actions as (row, col), "pass" or a flat
    int."""
    ko = crafted_state(n, black=[(1, 2), (2, 1), (3, 2)], white=[(1, 3), (2, 4), (3, 3), (2, 2)])
    suicide = crafted_state(n, black=[(0, 1)])
    edge = crafted_state(n, black=[(1, 0), (1, 2), (0, 3)], white=[(0, 0), (0, 2), (4, 4)])
    passed = crafted_state(n, black=[(2, 2)], white=[(3, 3)], white_to_move=True, prev_passed=True)
    occupied = crafted_state(n, black=[(2, 2)], white=[(2, 3)])
    done = crafted_state(n, black=[(1, 1)], done=True)
    dead = crafted_state(n, black=[(0, 0), (0, 1)], white=[(1, 0), (1, 1), (0, 2)])
    dead[1, 4, 4] = dead[0, 4, 4] = 1
    return [
        (ko, [(2, 3), (2, 2), "pass"]),  # black captures into ko; white may not retake
        (suicide, [(1, 0), (0, 0), "pass"]),  # white's (0, 0) has no liberty and captures nothing
        (edge, [(0, 1), "pass", "pass"]),  # two white groups in one move, then the game ends
        (passed, ["pass", (0, 0), "pass"]),  # the second pass ends the game; a move after it freezes
        (occupied, [(2, 3), -1, n * n + 1]),
        (done, [(0, 0), "pass", 3]),
        (dead, [(2, 2), (3, 0), "pass"]),  # white's move takes the dead group statelessly; carried planes keep it
    ]


def _flat(a, n):
    return n * n if a == "pass" else a if isinstance(a, int) else a[0] * n + a[1]


def _random_games(device, b, n, seed):
    """``b`` boards of random games at every stage (the plain rollout with
    auto-reset, so some boards have just finished)."""
    cfg = EnvConfig(board_size=n, batch_size=b, auto_reset=True)
    with _plain_step():
        return rollout(torch.Generator(device=device).manual_seed(seed), batch_init_state(b, n, device=device),
                       n * n, cfg).final_states


def _actions(rng, states, n, dtype):
    """Mostly valid moves, some passes, some arbitrary cells and out-of-range
    actions (and far out of int32's range as int64)."""
    b = states.shape[0]
    free = (states[:, 3] == 0).reshape(b, -1).cpu().numpy()
    acts = np.array([rng.choice(np.flatnonzero(f)) if f.any() else n * n for f in free], np.int64)
    u = rng.random(b)
    acts = np.where(u < 0.08, n * n, np.where(u > 0.92, rng.integers(-2, n * n + 3, b), acts))
    if dtype == torch.int64:
        acts = np.where(rng.random(b) < 0.02, rng.choice([-(1 << 40), 1 << 40], b), acts)
    return torch.from_numpy(acts).to(dtype)


@pytest.mark.parametrize("n", [5, 7, 9, 13, 19, 22])
@pytest.mark.parametrize("b", [1, 7, 512, 4096])
def test_fused_step_equals_the_op_by_op_step(b, n, cuda_device):
    scripts = _scripts(n)
    hand = torch.from_numpy(np.stack([s for s, _ in scripts])).to(cuda_device)
    states = torch.cat([hand, _random_games(cuda_device, max(b - len(scripts), 1), n, b + n)])[:b]
    rng = np.random.default_rng(b * 100 + n)
    ps, infos = None, []
    for step in range(3):
        dtype = (torch.int32, torch.int64)[step % 2]
        acts = _actions(rng, states, n, dtype)
        acts[:len(scripts)] = torch.tensor([_flat(s[step], n) for _, s in scripts][:b], dtype=dtype)
        acts = acts.to(cuda_device)
        with _no_host_sync():
            got = tstep.step_states(states, acts)
        want = tstep.step_states_plain(states, acts)
        _equal(got, want, f"stateless step {step}")
        # the carried path: seeded from the same states, then stepped
        if ps is None:
            ps = tstep.seed_planes(states)
        with _no_host_sync():
            got_ps = tstep.step_planes(ps, acts)
        want_ps = tstep.step_planes_plain(ps, acts)
        _equal(got_ps, want_ps, f"carried step {step}")
        # the planes path without carried planes
        bare = tstep.planes_from_states(states)
        _equal(tstep.step_planes(bare, acts), tstep.step_planes_plain(bare, acts), f"bare planes step {step}")
        states, ps = want[0], want_ps[0]
        infos.append(want[1])
    if b >= len(scripts):  # the scripts did what they say
        first, second, third = ([x.cpu().tolist() for x in info] for info in infos)
        invalid, was_done, captured = 0, 1, 2
        assert first[captured][0] == 1 and first[captured][2] == 2 and first[invalid][4]
        assert second[invalid][0] and second[invalid][1] and second[was_done][3] and second[invalid][4]
        assert third[invalid][4] and third[was_done][5] and bool(states[2, 5, 0, 0]) and bool(states[3, 5, 0, 0])


@pytest.mark.parametrize("kind,method,auto_reset", [("sampler", "heuristic", True), ("sampler", "real", False),
                                                    ("policy_fn", "real", True), ("finished", "heuristic", True),
                                                    ("finished", "real", False)])
def test_rollout_equals_the_op_by_op_rollout(kind, method, auto_reset, cuda_device):
    """``finished``: the sampler from boards of which every third is
    finished, restarted by the fused step at once under ``auto_reset``,
    frozen without it."""
    from gymgo_tpu_torch.core.actions import uniform_random_actions

    cfg = EnvConfig(board_size=19, batch_size=512, komi=7.5 if method == "real" else 0.0, reward_method=method,
                    auto_reset=auto_reset)
    env = BatchGoEnv(cfg, device=cuda_device)
    start = _random_games(cuda_device, 512, 19, 5)
    if kind == "finished":
        start[0::3, 5] = 1
        start[0::3, 3] = 1
    kw = {} if kind != "policy_fn" else {"policy_fn": uniform_random_actions}
    for _ in range(2):  # the capture, then a replay
        got = env.rollout(torch.Generator(device=cuda_device).manual_seed(9), start, 64, **kw)
    with _plain_step():
        want = rollout(torch.Generator(device=cuda_device).manual_seed(9), start, 64, cfg, **kw)
    for field in ("actions", "rewards", "dones", "invalid", "final_states"):
        _equal(getattr(got, field), getattr(want, field), field)
    assert want.dones.any() and not want.invalid.any()
    if kind == "finished":  # restarted at the first step, or frozen
        assert bool(want.dones[0, 0::3].any()) != auto_reset


_CHAIN = (env_step.ENV_SAMPLE, env_step.ENV_SPLIT, env_step.ENV_RULES, env_step.ENV_SCORE, tbundle.BUNDLE_FLOOD)


def _counts():
    """The launches of sample, split, rules, score and the bundle flood, and
    of the fused step."""
    return [lib.launches for lib in _CHAIN], env_step.ENV_FUSED.launches


def _since(before):
    (chain, fused), (chain0, fused0) = _counts(), before
    return [x - y for x, y in zip(chain, chain0)], fused - fused0


def test_each_kernel_launches_once_a_step(cuda_device):
    cfg = EnvConfig(board_size=9, batch_size=64, auto_reset=True)
    states = _random_games(cuda_device, 64, 9, 1)
    before = _counts()
    rollout(torch.Generator(device=cuda_device).manual_seed(1), states, 20, cfg)
    # sample, split, rules, score, bundle: the seeding floods once; the fused step a step
    assert _since(before) == ([0, 0, 0, 0, 1], 20)
    before = _counts()
    tstep.step_states(states, torch.zeros(64, dtype=torch.int32, device=cuda_device))
    assert _since(before) == ([0, 1, 1, 1, 2], 0)
    ps = tstep.seed_planes(states)
    before = _counts()
    tstep.step_planes(ps, torch.zeros(64, dtype=torch.int32, device=cuda_device))
    assert _since(before) == ([0, 0, 0, 0, 0], 1)


def test_a_captured_window_holds_at_most_8_operations_a_step(cuda_device):
    cfg = EnvConfig(board_size=19, batch_size=512, auto_reset=True, reward_method="heuristic")
    env = BatchGoEnv(cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    states = env.reset()
    for _ in range(2):
        states = env.rollout(g, states, 64).final_states
    (graph,) = env._rollout.graphs.values()
    table = graph.table
    assert graph.replays == 1 and table.chain
    assert table.ops <= 4 * 64, table.ops
    layers = {path.split("/")[-1].removeprefix("gymgo.") for path in table.paths()}
    assert {"env.sampler", "env.fused", "env.flood"} <= layers
    assert table.counts["launches.env_fused_launch"] == 64
    assert not any(table.counts.get(f"launches.env_{name}_launch") for name in ("sample", "rules", "score"))


@pytest.mark.parametrize("b", [1, 256])
def test_graphed_search_equals_it_with_the_plain_step(b, monkeypatch, cuda_device):
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.rl import gumbel_mcts

    net = load_aznet_npz(_ARTIFACTS / "az9_r5_iter100_params.npz", device=cuda_device, dtype=torch.bfloat16)
    states = _random_games(cuda_device, b, 9, 11)
    kw = dict(num_simulations=16, max_considered=8)
    search = gumbel_mcts.run_gumbel_mcts
    for _ in range(2):
        got = search(torch.Generator(device=cuda_device).manual_seed(12), states, net, **kw)
    launches = env_step.ENV_RULES.launches
    search(torch.Generator(device=cuda_device).manual_seed(12), states, net, **kw)
    assert env_step.ENV_RULES.launches - launches == 16  # a fused step a simulation, replayed
    monkeypatch.setattr(tstep, "step_states", tstep.step_states_plain)
    plain = graphs.compiled(search.fn, static_argnames=search.static_argnames, when=search.when)
    for _ in range(2):
        want = plain(torch.Generator(device=cuda_device).manual_seed(12), states, net, **kw)
    assert env_step.ENV_RULES.launches - launches == 16
    _equal(tuple(got), tuple(want), "search")


@pytest.mark.parametrize("case", ["minmax", "ablate", "25x25"])
def test_the_route_keeps_the_plain_step_on_the_card(case, monkeypatch, cuda_device):
    def refuse(*_args, **_kw):
        raise AssertionError("an env_step kernel was launched")

    for lib in env_step.KERNELS:
        monkeypatch.setattr(lib, "launch", refuse)
    n = 25 if case == "25x25" else 9
    if case == "minmax":  # the size rule sends these boards to the minmax route
        monkeypatch.setattr(tflood, "bundle_fits", lambda _n: False)
    previous_ablate = tstep.set_ablate({"ko"} if case == "ablate" else ())
    try:
        states = batch_init_state(32, n, device=cuda_device)
        cfg = EnvConfig(board_size=n, batch_size=32, auto_reset=True)
        r = rollout(torch.Generator(device=cuda_device).manual_seed(3), states, 12, cfg)
        tstep.step_states(r.final_states, torch.zeros(32, dtype=torch.int32, device=cuda_device))
    finally:
        tstep.set_ablate(previous_ablate)
