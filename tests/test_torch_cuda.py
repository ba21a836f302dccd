"""The port on a CUDA card: each flood kernel against its plain version, on the
rollout of its route, and on bad input; the stateless step, the area score,
the net and the search against the CPU plain path.  Imports no JAX, so it runs on a machine without
it (``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``); every
test skips where there is no card.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core.flood import bundle_flood_plain, minmax_flood_plain
from gymgo_tpu_torch.core import score as tscore
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from gymgo_tpu_torch.ops import minmax_flood as tminmax
from torch_boards import (adversarial_boards, component_boards, midgame_states, random_boards,
                          states_on_boards)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _boards_on(device, n, seed):
    """Random, adversarial and component boards at size ``n``: 352 boards, so
    every warp of a block has a board."""
    planes = [random_boards(np.random.default_rng(seed), 333, n), adversarial_boards(n), component_boards(n)]
    return tuple(torch.from_numpy(np.concatenate(x)).to(device) for x in zip(*planes))


def _odd_batches(a, b):
    """One board, one board more than a block's warps, and a contiguous slice
    whose address is no multiple of 16 at N = 19."""
    return [(a[:1], b[:1]), (a[:17], b[:17]), (a[3:], b[3:])]


@pytest.mark.parametrize("n", [5, 9, 19, 22])
def test_kernel_matches_plain(n, cuda_device):
    a, b = _boards_on(cuda_device, n, 4)
    launches = tbundle.BUNDLE_FLOOD.launches
    got = tbundle.bundle_flood_cuda(a, b)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 1
    # bit for bit: integer words
    want = bundle_flood_plain(a.cpu(), b.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tbundle.bundle_flood(a.to(torch.uint8), b.to(torch.uint8)), got)
    if n == 19:
        assert a[3:].data_ptr() % 16 != 0
        for (sa, sb), sw in zip(_odd_batches(a, b), _odd_batches(want, want)):
            assert torch.equal(tbundle.bundle_flood_cuda(sa, sb).cpu(), sw[0])


def test_rollout_goes_through_the_kernel_and_replays_on_cpu(cuda_device):
    cfg = EnvConfig(board_size=9, batch_size=96, reward_method="heuristic", auto_reset=True)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    launches = tbundle.BUNDLE_FLOOD.launches
    r = rollout(g, batch_init_state(96, 9, device=cuda_device), 150, cfg)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 151  # one per step + the seed
    assert r.dones.any() and not r.invalid.any()
    acts = iter(r.actions.cpu())
    rc = rollout(torch.Generator(), batch_init_state(96, 9, device="cpu"), 150, cfg,
                 policy_fn=lambda _g, _s: next(acts))
    for field in ("final_states", "rewards", "dones"):
        assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field


def test_kernel_rejects_bad_input(cuda_device):
    ok = torch.zeros((2, 9, 9), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        tbundle.bundle_flood_cuda(ok.int(), ok.int())
    with pytest.raises(ValueError, match="contiguous"):
        tbundle.bundle_flood_cuda(ok.transpose(1, 2), ok.transpose(1, 2))
    with pytest.raises(ValueError, match="511"):
        big = torch.zeros((1, 23, 23), dtype=torch.bool, device=cuda_device)
        tbundle.bundle_flood_cuda(big, big)
    with pytest.raises(ValueError, match="CUDA"):
        tbundle.bundle_flood_cuda(ok, ok.cpu())


@pytest.mark.parametrize("n", [5, 9, 19, 22, 32])
def test_minmax_kernel_matches_plain(n, cuda_device):
    a, b = _boards_on(cuda_device, n, 5)
    launches = tminmax.MINMAX_FLOOD.launches
    mn, mx = tminmax.minmax_flood_cuda(a, b)
    assert tminmax.MINMAX_FLOOD.launches == launches + 1
    # bit for bit on every cell: int16 (mn, mx), stones and kept seeds alike
    pmn, pmx = minmax_flood_plain(a.cpu(), b.cpu())
    assert torch.equal(mn.cpu(), pmn) and torch.equal(mx.cpu(), pmx)
    wmn, wmx = tminmax.minmax_flood(a.to(torch.uint8), b.to(torch.uint8))
    assert torch.equal(wmn, mn) and torch.equal(wmx, mx)
    if n == 19:
        for (sa, sb), (smn, smx) in zip(_odd_batches(a, b), _odd_batches(pmn, pmx)):
            kmn, kmx = tminmax.minmax_flood_cuda(sa, sb)
            assert torch.equal(kmn.cpu(), smn) and torch.equal(kmx.cpu(), smx)


def test_minmax_route_rollout_goes_through_its_kernel_and_replays_on_cpu(cuda_device):
    cfg = EnvConfig(board_size=9, batch_size=96, reward_method="heuristic", auto_reset=True)
    previous = tflood.set_flood_route("unrolled")
    try:
        g = torch.Generator(device=cuda_device).manual_seed(0)
        minmax, bundle = tminmax.MINMAX_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches
        r = rollout(g, batch_init_state(96, 9, device=cuda_device), 150, cfg)
        assert tminmax.MINMAX_FLOOD.launches == minmax + 151  # one per step + the seed
        assert tbundle.BUNDLE_FLOOD.launches == bundle
        assert r.dones.any() and not r.invalid.any()
        acts = iter(r.actions.cpu())
        rc = rollout(torch.Generator(), batch_init_state(96, 9, device="cpu"), 150, cfg,
                     policy_fn=lambda _g, _s: next(acts))
    finally:
        tflood.set_flood_route(previous)
    for field in ("final_states", "rewards", "dones"):
        assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field


def test_minmax_kernel_rejects_bad_input(cuda_device):
    ok = torch.zeros((2, 9, 9), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        tminmax.minmax_flood_cuda(ok.int(), ok.int())
    with pytest.raises(ValueError, match="contiguous"):
        tminmax.minmax_flood_cuda(ok.transpose(1, 2), ok.transpose(1, 2))
    with pytest.raises(ValueError, match="1024"):
        big = torch.zeros((1, 33, 33), dtype=torch.bool, device=cuda_device)
        tminmax.minmax_flood_cuda(big, big)
    with pytest.raises(ValueError, match="CUDA"):
        tminmax.minmax_flood_cuda(ok, ok.cpu())


@contextlib.contextmanager
def _no_host_sync():
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@pytest.mark.parametrize("n", [5, 9, 19])
def test_stateless_step_matches_cpu_without_a_host_sync(n, cuda_device):
    # hand-made boards (groups without a liberty among them) and positions of
    # real games: the CPU's capture flood against the card's classification
    states = torch.from_numpy(np.concatenate(
        [states_on_boards(n, 7)]
        + [midgame_states(n, 128, plies, plies) for plies in (n, n * n // 2, n * n, 2 * n * n)]))
    rng = np.random.default_rng(n)
    b = states.shape[0]
    empty = (states[:, 3] == 0).reshape(b, -1).numpy()
    # mostly legal moves (captures and ko among them), some passes, some
    # arbitrary cells (occupied, suicide), some out of range
    acts = np.array([rng.choice(np.flatnonzero(e)) if e.any() else n * n for e in empty])
    u = rng.random(b)
    acts = np.where(u < 0.1, n * n, np.where(u > 0.9, rng.integers(-1, n * n + 3, b), acts))
    acts = torch.from_numpy(acts.astype(np.int32))
    want_states, want_info = tstep.step_states(states, acts)
    on_card, acts_card = states.to(cuda_device), acts.to(cuda_device)
    tstep.step_states(on_card, acts_card)  # build the kernel outside the sync check
    launches = tbundle.BUNDLE_FLOOD.launches
    with _no_host_sync():
        got_states, got_info = tstep.step_states(on_card, acts_card)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 2  # the board before the move and after it
    assert torch.equal(got_states.cpu(), want_states)
    for name in want_info._fields:
        assert torch.equal(getattr(got_info, name).cpu(), getattr(want_info, name)), name
    assert int(want_info.num_captured.sum()) > 0 and want_info.invalid_action.any()


@pytest.mark.parametrize("n", [5, 9, 19, 22])
def test_areas_match_cpu_without_a_host_sync(n, cuda_device):
    states = torch.from_numpy(states_on_boards(n, 6))
    on_card = states.to(cuda_device)
    tscore.areas(on_card)  # build the kernel outside the sync check
    launches = tbundle.BUNDLE_FLOOD.launches
    with _no_host_sync():
        got_areas = tscore.areas(on_card)
        got_sign = tscore.winning(on_card, 0.5)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 2
    for got, want in zip(got_areas, tscore.areas(states)):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(got_sign.cpu(), tscore.winning(states, 0.5))
    # a board too large for the bundle word takes the plain flood
    big = torch.zeros((2, 6, 25, 25), dtype=torch.int8, device=cuda_device)
    big[0, 0, 3, 3] = 1
    black_area, white_area = tscore.areas(big)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 2
    assert black_area.tolist() == [625, 0] and white_area.tolist() == [0, 0]
    # the score is the same function on the minmax route
    previous = tflood.set_flood_route("unrolled")
    try:
        for got, want in zip(tscore.areas(on_card), tscore.areas(states)):
            assert torch.equal(got.cpu(), want)
    finally:
        tflood.set_flood_route(previous)


_ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"


@pytest.fixture
def float32_without_tf32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("name,batch", [("az9_r5_iter100", 64), ("az19_big128x6_iter830", 16)])
def test_float32_net_on_the_card_matches_cpu(name, batch, cuda_device, float32_without_tf32):
    from gymgo_tpu_torch.convert import load_aznet_npz

    path = _ARTIFACTS / f"{name}_params.npz"
    cpu = load_aznet_npz(path, device="cpu", dtype=torch.float32)
    card = load_aznet_npz(path, dtype=torch.float32)  # cuda by default
    assert next(card.parameters()).is_cuda
    n = cpu.config.board_size
    states = torch.from_numpy(midgame_states(n, batch, n * n // 2, 3))
    with torch.no_grad():
        want, got = cpu(states), card(states.to(cuda_device))
    # float32 on both sides, TF32 off: only the order of the sums differs
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2e-4)
    bf16 = load_aznet_npz(path, dtype=torch.bfloat16)
    with torch.no_grad():
        logits, value = bf16(states.to(cuda_device))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all() and torch.isfinite(value).all()
    assert (logits.cpu() - want[0]).abs().max() < 0.05 * (want[0].max() - want[0].min())


def test_search_on_the_card_matches_cpu_given_the_noise(cuda_device, float32_without_tf32):
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.rl.gumbel_mcts import run_gumbel_mcts

    path = _ARTIFACTS / "az9_r5_iter100_params.npz"
    cpu = load_aznet_npz(path, device="cpu", dtype=torch.float32)
    card = load_aznet_npz(path, device=cuda_device, dtype=torch.float32)
    states = torch.from_numpy(midgame_states(9, 32, 30, 4))
    noise = torch.from_numpy(np.random.default_rng(0).gumbel(size=(32, 82)).astype(np.float32))
    want = run_gumbel_mcts(None, states, cpu, num_simulations=16, max_considered=8, gumbel=noise)
    launches = tbundle.BUNDLE_FLOOD.launches
    got = run_gumbel_mcts(None, states.to(cuda_device), card, num_simulations=16, max_considered=8,
                          gumbel=noise.to(cuda_device))
    assert tbundle.BUNDLE_FLOOD.launches == launches + 32  # a seed and a step per simulation
    assert torch.equal(got.sampled_actions.cpu(), want.sampled_actions)
    # a float near-tie may flip a visit in an env: at most one of the 32
    differ = (got.actions.cpu() != want.actions) | (got.root_visits.cpu() != want.root_visits).any(1)
    assert int(differ.sum()) <= 1
    same = ~differ
    torch.testing.assert_close(got.improved_policy.cpu()[same], want.improved_policy[same], rtol=0, atol=1e-4)


def test_puct_search_and_selfplay_on_the_card_match_cpu(cuda_device, float32_without_tf32):
    from gymgo_tpu_torch.convert import load_aznet_npz
    from gymgo_tpu_torch.rl.mcts import run_mcts
    from gymgo_tpu_torch.rl.selfplay import selfplay_mcts_rollout

    path = _ARTIFACTS / "az9_r5_iter100_params.npz"
    cpu = load_aznet_npz(path, device="cpu", dtype=torch.float32)
    card = load_aznet_npz(path, device=cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(1)
    states = torch.from_numpy(midgame_states(9, 24, 30, 5))
    dirichlet = torch.from_numpy(rng.dirichlet(np.full(82, 0.3), 24).astype(np.float32))
    gumbel = torch.from_numpy(rng.gumbel(size=(24, 82)).astype(np.float32))
    want = run_mcts(None, states, cpu, num_simulations=16, num_parallel=4, dirichlet=dirichlet, gumbel=gumbel)
    got = run_mcts(None, states.to(cuda_device), card, num_simulations=16, num_parallel=4,
                   dirichlet=dirichlet.to(cuda_device), gumbel=gumbel.to(cuda_device))
    differ = (got.actions.cpu() != want.actions) | (got.root_visits.cpu() != want.root_visits).any(1)
    assert int(differ.sum()) <= 1

    cfg = EnvConfig(board_size=9, batch_size=24, auto_reset=True)
    noise = (torch.from_numpy(rng.dirichlet(np.full(82, 0.3), (3, 24)).astype(np.float32)),
             torch.from_numpy(rng.gumbel(size=(3, 24, 82)).astype(np.float32)))
    fw, bw = selfplay_mcts_rollout(None, states, cpu, 3, cfg, num_simulations=8, tree_reuse="subtree",
                                   dirichlet=noise[0], gumbel=noise[1])
    fg, bg = selfplay_mcts_rollout(None, states.to(cuda_device), card, 3, cfg, num_simulations=8,
                                   tree_reuse="subtree", dirichlet=noise[0].to(cuda_device),
                                   gumbel=noise[1].to(cuda_device))
    env_differs = (bg.actions.cpu() != bw.actions).any(0) | (fg.cpu() != fw).flatten(1).any(1)
    assert int(env_differs.sum()) <= 1 and not bg.invalid.any()


def test_replay_and_learner_step_on_the_card_match_cpu(cuda_device, float32_without_tf32):
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
    from gymgo_tpu_torch.rl.learner import make_train_state, train_step
    from gymgo_tpu_torch.rl.replay import ReplayBuffer

    rng = np.random.default_rng(2)
    m = 80
    obs = torch.from_numpy(midgame_states(9, m, 20, 6))
    policy = torch.softmax(torch.from_numpy(rng.standard_normal((m, 82)).astype(np.float32)), 1)
    value = torch.from_numpy(rng.choice([-1.0, 1.0], m).astype(np.float32))
    mask = torch.from_numpy(rng.random(m) < 0.9)
    out = []
    for device in (torch.device("cpu"), cuda_device):
        buf = ReplayBuffer(64, 9, device=device)
        st = buf.init()
        for rows in (slice(0, 40), slice(40, 80)):  # the second add wraps
            st = buf.add(st, obs[rows].to(device), policy[rows].to(device), value[rows].to(device),
                         mask[rows].to(device))
        batch = buf.sample(st, None, 48, indices=torch.arange(48) * 5 % 64)
        net = init_params(torch.Generator().manual_seed(0), AZNetConfig(board_size=9, channels=32, blocks=2,
                                                                         dtype=torch.float32)).to(device)
        ts, metrics = train_step(make_train_state(net, learning_rate=1e-3), batch)
        out.append((st, batch, ts, float(metrics["loss"])))
        assert buf.sample(st, torch.Generator(device=device).manual_seed(0), 8)[0].device.type == device.type
    (st_c, batch_c, ts_c, loss_c), (st_g, batch_g, ts_g, loss_g) = out
    for x, y in zip(st_c, st_g):
        assert torch.equal(x, y.cpu())
    for x, y in zip(batch_c, batch_g):
        assert torch.equal(x, y.cpu())
    assert abs(loss_c - loss_g) < 2e-5
    for p, q in zip(ts_c.net.parameters(), ts_g.net.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=0, atol=2e-3)  # Adam's first step: ~lr sign(g)


def test_trainer_resumes_bit_for_bit_on_the_card(cuda_device, tmp_path):
    from gymgo_tpu_torch.train import Trainer, build_parser

    flags = ["--board", "7", "--envs", "16", "--channels", "16", "--blocks", "1", "--rollout-steps", "4",
             "--gumbel-sims", "8", "--gumbel-m", "4", "--augment", "--train-batch", "64",
             "--replay-capacity", "96"]
    quiet = lambda *a, **k: None
    whole = Trainer(build_parser().parse_args(flags + ["--iters", "3"]), log=quiet)
    assert whole.device.type == "cuda"
    whole.run_iteration(0)
    whole.run_iteration(1)
    path = tmp_path / "cut.npz"
    from gymgo_tpu_torch.utils.checkpoint import save_npz

    save_npz(path, whole.tree())
    whole.run_iteration(2)
    again = Trainer(build_parser().parse_args(flags + ["--iters", "3", "--resume", str(path)]), log=quiet)
    again.run()
    assert torch.equal(whole.states, again.states)
    for x, y in zip(whole.buf_state, again.buf_state):
        assert torch.equal(x, y)
    for p, q in zip(whole.net.parameters(), again.net.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=1e-6)


def test_replay_add_of_more_rows_than_the_capacity_on_the_card(cuda_device):
    """The 19x19 recipe's add: 512 envs x 160 moves = 81,920 rows into a
    65,536-row replay.  Every slot must hold one whole row (its obs, policy,
    value and masks all of that row), the rows must be the last 65,536, each
    at the slot it reached, and the card must equal the CPU."""
    from gymgo_tpu_torch.rl.replay import ReplayBuffer

    n, capacity, m, start = 19, 65536, 81920, 1000
    ids = torch.arange(m, dtype=torch.int64)
    bits = (ids[:, None] >> torch.arange(17)) & 1
    obs = torch.zeros((m, 6 * n * n), dtype=torch.int8)
    obs[:, :17] = bits.to(torch.int8)
    obs = obs.view(m, 6, n, n)
    policy = torch.zeros((m, n * n + 1))
    policy[:, 0] = ids.to(torch.float32)
    value, mask, vmask = ids.to(torch.float32), ids % 2 == 0, ids % 3 == 0
    out = []
    for device in (torch.device("cpu"), cuda_device):
        buf = ReplayBuffer(capacity, n, device=device)
        st = buf.init()
        st = buf.add(st, *(x[:start].to(device) for x in (obs, policy, value, mask, vmask)))
        st = buf.add(st, *(x.to(device) for x in (obs, policy, value, mask, vmask)))
        out.append(st)
    cpu, card = out
    for x, y in zip(cpu, card):
        assert torch.equal(x, y.cpu())
    row = card.value.cpu().to(torch.int64)
    assert torch.equal(card.policy[:, 0].cpu().to(torch.int64), row)
    assert torch.equal(((card.obs.cpu().view(capacity, -1)[:, :17].to(torch.int64)) << torch.arange(17)).sum(1), row)
    assert torch.equal(card.mask.cpu(), row % 2 == 0) and torch.equal(card.vmask.cpu(), row % 3 == 0)
    slots = (start + torch.arange(m - capacity, m)) % capacity
    assert torch.equal(row[slots], torch.arange(m - capacity, m))
    assert int(card.cursor) == (start + m) % capacity and int(card.filled) == capacity


def test_go_env_on_the_card_matches_native_and_cpu(cuda_device):
    from gymgo_tpu_torch.env import GoEnv

    envs = [GoEnv(9, reward_method="heuristic", backend="torch", device=cuda_device),
            GoEnv(9, reward_method="heuristic", backend="native"),
            GoEnv(9, reward_method="heuristic", backend="torch", device="cpu")]
    assert [e.backend for e in envs] == ["torch", "native", "torch"]
    rng = np.random.RandomState(0)
    launches = tbundle.BUNDLE_FLOOD.launches
    for t in range(400):
        valid = np.flatnonzero(envs[0].valid_moves())
        a = int(rng.choice(valid))
        (obs, reward, done, info), *others = [e.step(a) for e in envs]
        for o, r, d, i in others:
            assert np.array_equal(o, obs) and r == reward and d == done
            assert i["turn"] == info["turn"] and i["prev_player_passed"] == info["prev_player_passed"]
            assert np.array_equal(i["invalid_moves"], info["invalid_moves"])
        if done:
            break
    assert tbundle.BUNDLE_FLOOD.launches >= launches + 2 * (t + 1)  # each step classifies, then floods
    for canonical in (False, True):
        want = envs[1].children(canonical)
        assert np.array_equal(envs[0].children(canonical), want) and np.array_equal(envs[2].children(canonical), want)


def test_gtp_genmove_with_gumbel_search_on_the_card_is_legal(cuda_device):
    from gymgo_tpu_torch.native import NativeGoEngine
    from gymgo_tpu_torch.utils.gtp import GTPEngine, _vertex_to_action, make_net_genmove

    mover = make_net_genmove(str(_ARTIFACTS / "az9_r5_iter100_params.npz"), 9, 64, 3, simulations=8, komi=7.5,
                             seed=1)  # cuda and bfloat16 by default
    assert next(mover._net.parameters()).is_cuda
    eng = GTPEngine(9, 7.5, mover, match_pass_rule=True, backend="native")
    referee = NativeGoEngine(9)
    state = np.zeros((6, 9, 9), np.int8)
    launches = tbundle.BUNDLE_FLOOD.launches
    for ply in range(8):
        resp, err, _ = eng.handle(f"genmove {'b' if ply % 2 == 0 else 'w'}")
        assert not err and resp.startswith("= ")
        state, status = referee.next_state(state, _vertex_to_action(resp[2:].strip(), 9))
        assert status == 0
    np.testing.assert_array_equal(eng.state, state)
    assert tbundle.BUNDLE_FLOOD.launches >= launches + 8 * 8  # the search steps on the card


def test_gtp_engine_on_the_card_matches_native(cuda_device):
    from gymgo_tpu_torch.utils.gtp import GTPEngine

    session = (["fixed_handicap 4", "showboard"] + [f"genmove {'w' if i % 2 == 0 else 'b'}" for i in range(160)]
               + ["final_score", "showboard", "undo", "genmove b", "final_score"])
    card = GTPEngine(9, 6.5, seed=3, match_pass_rule=True, backend="torch", device=cuda_device)
    native = GTPEngine(9, 6.5, seed=3, match_pass_rule=True, backend="native")
    assert card.backend == "torch" and card.device.type == "cuda"
    launches = tbundle.BUNDLE_FLOOD.launches
    for line in session:
        assert card.handle(line) == native.handle(line), line
    assert tbundle.BUNDLE_FLOOD.launches > launches
    np.testing.assert_array_equal(card.state, native.state)


def test_checked_step_on_the_card_raises_on_a_bad_batch(cuda_device):
    from gymgo_tpu_torch.core.debug import checked_step

    states = batch_init_state(8, 9, device=cuda_device)
    centre, passes = torch.full((8,), 40, device=cuda_device), torch.full((8,), 81, device=cuda_device)
    got, info = checked_step(states, centre)
    want, _ = tstep.step_states(states, centre)
    assert torch.equal(got, want) and not info.invalid_action.any()
    with pytest.raises(RuntimeError, match="invalid action"):
        checked_step(got, centre)  # the point is taken
    ended, _ = checked_step(checked_step(got, passes)[0], passes)
    assert bool(ended[:, 5].all())
    with pytest.raises(RuntimeError, match="finished game"):
        checked_step(ended, passes)
