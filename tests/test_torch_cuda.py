"""The port on a CUDA card: each flood kernel (bundle, min/max, claim) against
its plain version, on the rollout of its route, and on bad input, the min/max
and claim kernels up to 181x181; the stateless step, the area score,
the net and the search against the CPU plain path; the served net's fused
GroupNorm kernel against the library's operations; the step's ablation
switches and ``measure_convergence``'s kernel check; the compiled forms
(CUDA graphs) against their eager functions, the search, the self-play move
and the match ply among them.  Imports no JAX, so it runs on a machine without
it (``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``); every
test skips where there is no card.
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core.flood import bundle_flood_plain, claim_flood_plain, minmax_flood_plain
from gymgo_tpu_torch.core import score as tscore
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from gymgo_tpu_torch.ops import claim_flood as tclaim
from gymgo_tpu_torch.ops import minmax_flood as tminmax
from gymgo_tpu_torch.utils import graphs
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
        claim = tclaim.CLAIM_FLOOD.launches
        r = rollout(g, batch_init_state(96, 9, device=cuda_device), 150, cfg)
        assert tminmax.MINMAX_FLOOD.launches == minmax + 151  # one per step + the seed
        assert tclaim.CLAIM_FLOOD.launches == claim + 150  # the step's claims
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
    with pytest.raises(ValueError, match="32761"):
        big = torch.zeros((1, 182, 182), dtype=torch.bool, device=cuda_device)
        tminmax.minmax_flood_cuda(big, big)
    with pytest.raises(ValueError, match="CUDA"):
        tminmax.minmax_flood_cuda(ok, ok.cpu())


@pytest.mark.parametrize("n", range(1, 33))
def test_claim_kernel_matches_plain(n, cuda_device):
    a, b = _boards_on(cuda_device, n, 40 + n)
    launches = tclaim.CLAIM_FLOOD.launches
    got = tclaim.claim_flood_cuda(a, b)
    assert tclaim.CLAIM_FLOOD.launches == launches + 1
    # bit for bit on every cell: the region's word on empty cells, 0 on stones
    want = claim_flood_plain(a.cpu(), b.cpu())
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    assert torch.equal(tclaim.claim_flood(a.to(torch.uint8), b.to(torch.uint8)), got)
    for (sa, sb), sw in zip(_odd_batches(a, b), _odd_batches(want, want)):
        assert torch.equal(tclaim.claim_flood_cuda(sa, sb).cpu(), sw[0])


def test_claim_kernel_rejects_bad_input(cuda_device):
    ok = torch.zeros((2, 9, 9), dtype=torch.bool, device=cuda_device)
    launches = tclaim.CLAIM_FLOOD.launches
    with pytest.raises(ValueError, match="CUDA"):
        tclaim.claim_flood_cuda(ok.cpu(), ok.cpu())
    with pytest.raises(TypeError):
        tclaim.claim_flood_cuda(ok.int(), ok.int())
    with pytest.raises(ValueError, match="contiguous"):
        tclaim.claim_flood_cuda(ok.transpose(1, 2), ok.transpose(1, 2))
    with pytest.raises(ValueError, match="32761"):
        big = torch.zeros((1, 182, 182), dtype=torch.bool, device=cuda_device)
        tclaim.claim_flood_cuda(big, big)
    assert tclaim.CLAIM_FLOOD.launches == launches


# Boards over 32x32: one block a board; int32 arrays in shared memory up to 133x133 (min/max) and
# 160x160 (claim) on an H100, int16 ones above; 124/125 and 145/146 are where the arrays of one board
# would stop fitting with a place table beside them, 181 where int16 indices stop.
_BIG_SIZES = [33, 37, 45, 63, 64, 65, 100, 124, 125, 133, 134, 145, 146, 160, 161, 181]


@pytest.mark.parametrize("n", _BIG_SIZES)
def test_kernels_match_plain_over_32x32(n, cuda_device):
    planes = [random_boards(np.random.default_rng(60 + n), 21, n), adversarial_boards(n), component_boards(n)]
    a, b = (torch.from_numpy(np.concatenate(x)).to(cuda_device) for x in zip(*planes))
    launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches)
    mn, mx = tminmax.minmax_flood_cuda(a, b)
    claims = tclaim.claim_flood_cuda(a, b)
    assert (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches) == (launches[0] + 1, launches[1] + 1)
    # bit for bit on every cell, against the plain versions on the same card (by rounds: the long
    # chains of the serpentine, comb and spiral boards take thousands)
    pmn, pmx = minmax_flood_plain(a, b)
    pclaims = claim_flood_plain(a, b)
    assert torch.equal(mn, pmn) and torch.equal(mx, pmx)
    assert torch.equal(claims, pclaims)
    # one board, 17, and all of them at an address that is no multiple of 16 (at N = 64 every
    # slice of the batch is aligned, so the planes are copied one byte into a buffer)
    def misaligned(x):
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape).copy_(x)

    ma, mb = misaligned(a), misaligned(b)
    assert ma.data_ptr() % 16 != 0 and ma.is_contiguous()
    for sa, sb, cut in ((a[:1], b[:1], slice(0, 1)), (a[:17], b[:17], slice(0, 17)), (ma, mb, slice(None))):
        kmn, kmx = tminmax.minmax_flood_cuda(sa, sb)
        assert torch.equal(kmn, pmn[cut]) and torch.equal(kmx, pmx[cut])
        assert torch.equal(tclaim.claim_flood_cuda(sa, sb), pclaims[cut])


@pytest.mark.parametrize("n", [37, 64, 181])
def test_areas_over_32x32_match_cpu_without_a_host_sync(n, cuda_device):
    states = torch.from_numpy(states_on_boards(n, 8))
    on_card = states.to(cuda_device)
    tscore.areas(on_card)  # build the kernel outside the sync check
    claim = tclaim.CLAIM_FLOOD.launches
    with _no_host_sync():
        got_areas = tscore.areas(on_card)
    assert tclaim.CLAIM_FLOOD.launches == claim + 1
    for got, want in zip(got_areas, tscore.areas(states)):
        assert torch.equal(got.cpu(), want)


def test_64x64_compiled_window_equals_eager_without_a_host_sync(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    n, b, steps = 64, 64, 24
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    previous = tflood.set_flood_route("unrolled")
    try:
        assert env.compiled
        start = env.rollout(torch.Generator(device=cuda_device).manual_seed(11), env.reset(), steps).final_states
        gc, ge = (torch.Generator(device=cuda_device).manual_seed(12) for _ in range(2))
        launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
        with _no_host_sync():
            got = env.rollout(gc, start, steps)
        counted = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
        assert tuple(x - y for x, y in zip(counted, launches)) == (steps + 1, steps, 0)
        with graphs.eager():
            want = env.rollout(ge, start, steps)
        (graph,) = env._rollout.graphs.values()
        assert graph.replays == 1
    finally:
        tflood.set_flood_route(previous)
    for field in _FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert torch.equal(gc.get_state(), ge.get_state())
    assert not got.invalid.any() and (got.rewards != 0).any()


def test_181x181_compiled_window_replays_on_cpu(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    n, b, steps = 181, 2, 12
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    assert not env.compiled  # the bundle word holds no 181x181 board
    previous = tflood.set_flood_route("unrolled")
    try:
        assert env.compiled
        g = torch.Generator(device=cuda_device).manual_seed(13)
        first = env.rollout(g, env.reset(), steps)  # runs eagerly and captures
        launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches)
        with _no_host_sync():
            r = env.rollout(g, first.final_states, steps)
        counted = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches)
        assert (counted[0] - launches[0], counted[1] - launches[1]) == (steps + 1, steps)
        acts = iter(r.actions.cpu())
        rc = rollout(torch.Generator(), first.final_states.cpu(), steps, cfg, policy_fn=lambda _g, _s: next(acts))
    finally:
        tflood.set_flood_route(previous)
    assert not r.invalid.any()
    for field in ("final_states", "rewards", "dones"):
        assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field


def test_go_env_over_32x32_on_the_card_matches_cpu(cuda_device):
    from gymgo_tpu_torch.env import GoEnv

    previous = tflood.set_flood_route("unrolled")
    try:
        envs = [GoEnv(37, reward_method="heuristic", backend="torch", device=cuda_device),
                GoEnv(37, reward_method="heuristic", backend="torch", device="cpu")]
        rng = np.random.RandomState(1)
        launches = tminmax.MINMAX_FLOOD.launches
        for t in range(120):
            valid = np.flatnonzero(envs[0].valid_moves())
            a = int(rng.choice(valid))
            (obs, reward, done, info), (o, r, d, i) = [e.step(a) for e in envs]
            assert np.array_equal(o, obs) and r == reward and d == done
            assert np.array_equal(i["invalid_moves"], info["invalid_moves"])
            if done:
                break
        assert tminmax.MINMAX_FLOOD.launches >= launches + 2 * (t + 1)  # each step classifies twice
    finally:
        tflood.set_flood_route(previous)


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
    claim = tclaim.CLAIM_FLOOD.launches
    black_area, white_area = tscore.areas(big)
    assert tbundle.BUNDLE_FLOOD.launches == launches + 2 and tclaim.CLAIM_FLOOD.launches == claim + 1
    assert black_area.tolist() == [625, 0] and white_area.tolist() == [0, 0]
    # the score is the same function on the minmax route
    previous = tflood.set_flood_route("unrolled")
    try:
        for got, want in zip(tscore.areas(on_card), tscore.areas(states)):
            assert torch.equal(got.cpu(), want)
    finally:
        tflood.set_flood_route(previous)


@pytest.mark.parametrize("n", [23, 25, 32])
def test_areas_over_22x22_match_cpu_without_a_host_sync(n, cuda_device):
    states = torch.from_numpy(states_on_boards(n, 6))
    on_card = states.to(cuda_device)
    tscore.areas(on_card)  # build the kernel outside the sync check
    launches, claim = tbundle.BUNDLE_FLOOD.launches, tclaim.CLAIM_FLOOD.launches
    with _no_host_sync():
        got_areas = tscore.areas(on_card)
        got_sign = tscore.winning(on_card, 0.5)
    assert tclaim.CLAIM_FLOOD.launches == claim + 2 and tbundle.BUNDLE_FLOOD.launches == launches
    for got, want in zip(got_areas, tscore.areas(states)):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(got_sign.cpu(), tscore.winning(states, 0.5))


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


@pytest.mark.parametrize("k", [1, 2, 4])
def test_logical_shards_on_the_card_equal_the_unsharded_rollout(k, cuda_device):
    """k logical shards of one card: the same rollout bit for bit from the same
    generator, the bundle kernel launched once per shard per step plus once
    per shard for the seeding."""
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh

    cfg = EnvConfig(board_size=19, batch_size=512, reward_method="heuristic", auto_reset=True)
    start = rollout(torch.Generator(device=cuda_device).manual_seed(5), batch_init_state(512, 19, device=cuda_device),
                    200, cfg).final_states
    plain = rollout(torch.Generator(device=cuda_device).manual_seed(7), start, 32, cfg)
    env = ShardedGoEnv(cfg, make_mesh(devices=[cuda_device] * k))
    launches = tbundle.BUNDLE_FLOOD.launches
    sharded = env.rollout(torch.Generator(device=cuda_device).manual_seed(7), start, 32)
    assert tbundle.BUNDLE_FLOOD.launches - launches == k * (32 + 1)
    for field in ("actions", "rewards", "dones", "invalid", "final_states"):
        assert torch.equal(getattr(sharded, field), getattr(plain, field)), field


def test_fuzz_soak_on_the_card(cuda_device):
    from gymgo_tpu_torch.scripts.fuzz_parity import fuzz

    launches = tbundle.BUNDLE_FLOOD.launches
    checked = fuzz(9, 8, 120, cuda_device)
    assert checked >= 8 * 50 and tbundle.BUNDLE_FLOOD.launches - launches == 2 * checked // 8


_ABLATIONS = [("hit",), ("ko",), ("capsum",), ("bundle",), ("areas",), ("invd",),
              ("hit", "ko", "capsum", "bundle", "areas", "invd"), ("sampler",)]


@pytest.mark.parametrize("tokens", _ABLATIONS, ids="+".join)
def test_ablated_step_on_the_card_matches_cpu(tokens, cuda_device):
    """Under each GYMGO_ABLATE switch (results wrong by design): the rollout
    on the card replayed on the CPU with its actions, and the stateless step
    on the card against the CPU's; the bundle kernel launched once a step plus
    the seeding, none a step under ``bundle``, and the stateless step's
    classification of the board before the move kept."""
    cfg = EnvConfig(board_size=9, batch_size=96, reward_method="heuristic", auto_reset=True)
    start = rollout(torch.Generator(device=cuda_device).manual_seed(3), batch_init_state(96, 9, device=cuda_device),
                    40, cfg).final_states
    acts_cpu = torch.from_numpy(np.random.default_rng(3).integers(0, 82, 96).astype(np.int32))
    previous = tstep.set_ablate(tokens)
    try:
        launches = tbundle.BUNDLE_FLOOD.launches
        r = rollout(torch.Generator(device=cuda_device).manual_seed(4), start, 48, cfg)
        per_step = 0 if "bundle" in tokens else 1
        assert tbundle.BUNDLE_FLOOD.launches - launches == 48 * per_step + 1
        acts = iter(r.actions.cpu())
        rc = rollout(torch.Generator(), start.cpu(), 48, cfg, policy_fn=lambda _g, _s: next(acts))
        for field in ("final_states", "rewards", "dones", "invalid"):
            assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field
        launches = tbundle.BUNDLE_FLOOD.launches
        got, got_info = tstep.step_states(start, acts_cpu.to(cuda_device))
        assert tbundle.BUNDLE_FLOOD.launches - launches == 1 + per_step
        want, want_info = tstep.step_states(start.cpu(), acts_cpu)
    finally:
        tstep.set_ablate(previous)
    assert torch.equal(got.cpu(), want)
    for name in want_info._fields:
        assert torch.equal(getattr(got_info, name).cpu(), getattr(want_info, name)), name


def test_fixed_only_raises_on_cuda_tensors(cuda_device):
    """The kernel has no substeps to truncate: under GYMGO_BITPACK_FIXED_ONLY
    the bundle flood refuses CUDA tensors, and so does every step over it."""
    a, b = _boards_on(cuda_device, 9, 5)
    states = batch_init_state(4, 9, device=cuda_device)
    previous = tflood.set_bitpack_fixed_only(2)
    try:
        launches = tbundle.BUNDLE_FLOOD.launches
        for call in (lambda: tflood.flood_bundle(a, b), lambda: tbundle.bundle_flood(a, b),
                     lambda: tstep.step_states(states, torch.zeros(4, dtype=torch.int32, device=cuda_device))):
            with pytest.raises(ValueError, match="FIXED_ONLY"):
                call()
        assert tbundle.BUNDLE_FLOOD.launches == launches
        truncated = tflood.flood_bundle(a.cpu(), b.cpu())  # the CPU's plain flood takes the switch
    finally:
        tflood.set_bitpack_fixed_only(previous)
    whole = tflood.flood_bundle(a, b)
    assert any(not torch.equal(x.cpu(), y) for x, y in zip(whole, truncated))


def test_measure_convergence_kernel_word_equals_the_counted_fixpoint(cuda_device, capsys):
    from gymgo_tpu_torch.scripts import measure_convergence

    rc = measure_convergence.main(["--board", "19", "--batch", "512", "--warmup-steps", "200",
                                   "--measure-steps", "8"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["kernel_checked_steps"] == 8 and rec["kernel_mismatch_steps"] == 0
    assert rec["step_launches"] == 8 + 1  # one a step, one seeding
    assert rec["per_env"]["max"] < rec["maxk"] - 2


# --- the compiled forms (utils.graphs): each against its eager function ---

_FIELDS = ("actions", "rewards", "dones", "invalid", "final_states")


def _device_policy(generator, states):
    """A policy of the card alone (a graph may hold it): the uniform sampler."""
    from gymgo_tpu_torch.core.actions import uniform_random_actions

    return uniform_random_actions(generator, states)


def _midgame(device, n, b, steps=60):
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    return rollout(torch.Generator(device=device).manual_seed(n), batch_init_state(b, n, device=device), steps,
                   cfg).final_states


@pytest.mark.parametrize("policy", [None, _device_policy], ids=["sampler", "policy_fn"])
def test_compiled_rollout_equals_eager_over_replays_and_a_shape_change(policy, cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    cfg = EnvConfig(board_size=9, batch_size=96, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    assert env.compiled
    states = _midgame(cuda_device, 9, 96)
    kw = {} if policy is None else {"policy_fn": policy}
    gc, ge = (torch.Generator(device=cuda_device).manual_seed(3) for _ in range(2))
    for rows in (96, 96, 96, 40, 40, 40):  # a first call, two replays; then a new shape
        launches = tbundle.BUNDLE_FLOOD.launches
        got = env.rollout(gc, states[:rows], 30, **kw)
        assert tbundle.BUNDLE_FLOOD.launches - launches == 30 + 1  # one a step, one seeding
        want = rollout(ge, states[:rows], 30, cfg, **kw)
        for field in _FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        assert torch.equal(gc.get_state(), ge.get_state())
        states = torch.cat([got.final_states, states[rows:]])
    assert [g.replays for g in env._rollout.graphs.values()] == [2, 2]
    # another generator of the same seed: the same graph, the same draws
    got = env.rollout(torch.Generator(device=cuda_device).manual_seed(11), states[:40], 30, **kw)
    want = rollout(torch.Generator(device=cuda_device).manual_seed(11), states[:40], 30, cfg, **kw)
    assert torch.equal(got.actions, want.actions) and torch.equal(got.final_states, want.final_states)
    assert [g.replays for g in env._rollout.graphs.values()] == [2, 3]
    # collect_obs is static: a graph of its own, equal to the eager one
    got = env.rollout(gc, states, 8, collect_obs=True, **kw)
    got = env.rollout(gc, states, 8, collect_obs=True, **kw)
    want = rollout(ge, states, 8, cfg, collect_obs=True, **kw)
    want = rollout(ge, states, 8, cfg, collect_obs=True, **kw)
    assert torch.equal(got.obs, want.obs) and torch.equal(got.final_states, want.final_states)


def test_compiled_step_and_sampler_equal_eager(cuda_device):
    from gymgo_tpu_torch.core.actions import uniform_random_actions
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, batch_step

    cfg = EnvConfig(board_size=19, batch_size=64, reward_method="real", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    states = _midgame(cuda_device, 19, 64, 300)
    gc, ge = (torch.Generator(device=cuda_device).manual_seed(4) for _ in range(2))
    for rows in (64, 64, 64, 17, 17, 17):
        got_a, want_a = env.uniform_random_actions(gc, states[:rows]), uniform_random_actions(ge, states[:rows])
        assert torch.equal(got_a, want_a)
        launches = tbundle.BUNDLE_FLOOD.launches
        got_s, got_r = env.step(states[:rows], got_a)
        assert tbundle.BUNDLE_FLOOD.launches - launches == 2  # the stateless step: before and after the move
        want_s, want_r = batch_step(states[:rows], want_a, cfg)
        assert torch.equal(got_s, want_s) and all(torch.equal(x, y) for x, y in zip(got_r, want_r))
        states = torch.cat([got_s, states[rows:]])
    assert [g.replays for g in env._step.graphs.values()] == [2, 2]


def test_replayed_windows_make_no_host_sync(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    cfg = EnvConfig(board_size=19, batch_size=256, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    states = _midgame(cuda_device, 19, 256)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    first = env.rollout(g, states, 16)  # runs eagerly and captures
    actions = env.uniform_random_actions(g, first.final_states)
    env.step(first.final_states, actions)
    launches = tbundle.BUNDLE_FLOOD.launches
    with _no_host_sync():
        r = env.rollout(g, first.final_states, 16)
        env.uniform_random_actions(g, r.final_states)
        env.step(r.final_states, actions)
    assert tbundle.BUNDLE_FLOOD.launches - launches == 16 + 1 + 2
    assert not r.invalid.any()


def test_minmax_route_keeps_the_eager_rollout_on_the_card(cuda_device):
    # the minmax route's compiled window equals its eager form (graphs.eager)
    # over the first call and two replays, and the bundle route's window
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    cfg = EnvConfig(board_size=9, batch_size=64, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    states = _midgame(cuda_device, 9, 64)
    previous = tflood.set_flood_route("unrolled")
    try:
        assert env.compiled
        for i in range(3):
            launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
            got = env.rollout(torch.Generator(device=cuda_device).manual_seed(6 + i), states, 20)
            counted = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
            assert tuple(x - y for x, y in zip(counted, launches)) == (20 + 1, 20, 0)
            with graphs.eager():
                want = env.rollout(torch.Generator(device=cuda_device).manual_seed(6 + i), states, 20)
            for field in _FIELDS:
                assert torch.equal(getattr(got, field), getattr(want, field)), field
        (graph,) = env._rollout.graphs.values()
        assert graph.replays == 2
    finally:
        tflood.set_flood_route(previous)
    assert env.compiled
    bundle = env.rollout(torch.Generator(device=cuda_device).manual_seed(8), states, 20)
    assert len(env._rollout.graphs) == 2  # the route is part of the key
    for field in _FIELDS:
        assert torch.equal(getattr(got, field), getattr(bundle, field)), field


def test_minmax_route_replays_windows_and_steps_without_a_host_sync(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv, batch_step

    cfg = EnvConfig(board_size=19, batch_size=256, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    states = _midgame(cuda_device, 19, 256)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    previous = tflood.set_flood_route("unrolled")
    try:
        first = env.rollout(g, states, 16)  # runs eagerly and captures
        actions = env.uniform_random_actions(g, first.final_states)
        env.step(first.final_states, actions)
        launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
        with _no_host_sync():
            r = env.rollout(g, first.final_states, 16)
            got_s, got_r = env.step(r.final_states, actions)
        counted = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches, tbundle.BUNDLE_FLOOD.launches)
        # the window: a min/max classification a step and one seeding, a claim flood a step; the
        # stateless step: two classifications (before and after the move) and one claim flood
        assert tuple(x - y for x, y in zip(counted, launches)) == (16 + 1 + 2, 16 + 1, 0)
        want_s, want_r = batch_step(r.final_states, actions, cfg)
    finally:
        tflood.set_flood_route(previous)
    assert not r.invalid.any()
    assert torch.equal(got_s, want_s) and all(torch.equal(x, y) for x, y in zip(got_r, want_r))


def test_25x25_compiled_rollout_on_the_minmax_route_replays_on_cpu(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    n, b, steps = 25, 64, 40
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    assert not env.compiled  # the bundle word holds no 25x25 board
    with pytest.raises(ValueError, match="511"):
        env.rollout(torch.Generator(device=cuda_device).manual_seed(10), env.reset(), 2)
    previous = tflood.set_flood_route("unrolled")
    try:
        assert env.compiled
        g = torch.Generator(device=cuda_device).manual_seed(10)
        first = env.rollout(g, env.reset(), steps)  # runs eagerly and captures
        launches = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches)
        with _no_host_sync():
            r = env.rollout(g, first.final_states, steps)
        counted = (tminmax.MINMAX_FLOOD.launches, tclaim.CLAIM_FLOOD.launches)
        assert (counted[0] - launches[0], counted[1] - launches[1]) == (steps + 1, steps)
        acts = iter(r.actions.cpu())
        rc = rollout(torch.Generator(), first.final_states.cpu(), steps, cfg, policy_fn=lambda _g, _s: next(acts))
    finally:
        tflood.set_flood_route(previous)
    assert not r.invalid.any() and (r.rewards != 0).any()
    for field in ("final_states", "rewards", "dones"):
        assert torch.equal(getattr(r, field).cpu(), getattr(rc, field)), field


def test_a_capture_that_syncs_raises_and_leaves_the_generator_usable(cuda_device):
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv

    def syncing_policy(generator, states):
        n_done = int(states[:, 5, 0, 0].sum())  # a host sync
        return torch.full((states.shape[0],), states.shape[-1] ** 2 + n_done * 0, dtype=torch.int32,
                          device=states.device)

    cfg = EnvConfig(board_size=9, batch_size=32, reward_method="heuristic", auto_reset=True)
    env = BatchGoEnv(cfg, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        env.rollout(g, env.reset(), 4, policy_fn=syncing_policy)
    assert not env._rollout.graphs
    r = env.rollout(g, env.reset(), 4)
    assert r.actions.shape == (4, 32) and torch.rand(2, device=cuda_device).shape == (2,)


@pytest.mark.parametrize("k", [1, 2])
def test_compiled_sharded_env_equals_the_eager_unsharded_one(k, cuda_device):
    from gymgo_tpu_torch.env.batch_env import batch_step
    from gymgo_tpu_torch.parallel import ShardedGoEnv, make_mesh

    cfg = EnvConfig(board_size=19, batch_size=128, reward_method="heuristic", auto_reset=True)
    env = ShardedGoEnv(cfg, make_mesh(devices=[cuda_device] * k))
    assert env.compiled
    states = _midgame(cuda_device, 19, 128)
    gc, ge = (torch.Generator(device=cuda_device).manual_seed(8) for _ in range(2))
    for _ in range(3):
        launches = tbundle.BUNDLE_FLOOD.launches
        got = env.rollout(gc, states, 16)
        assert tbundle.BUNDLE_FLOOD.launches - launches == k * (16 + 1)
        want = rollout(ge, states, 16, cfg)
        for field in _FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
        acts = got.actions[-1]
        got_s, got_r = env.step(got.final_states, acts)
        want_s, want_r = batch_step(want.final_states, acts, cfg)
        assert torch.equal(got_s, want_s) and all(torch.equal(x, y) for x, y in zip(got_r, want_r))
        states = got_s
    assert [g.replays for g in env._rollout.graphs.values()] == [2]
    assert [g.replays for g in env._step.graphs.values()] == [2]


def test_jitted_train_step_on_the_card_matches_eager(cuda_device, float32_without_tf32):
    """Three AdamW steps of the compiled step against ``train_step`` on a
    copy of the net whose optimizer is capturable too (the same arithmetic),
    the batch shape changed at the third: bit for bit."""
    from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
    from gymgo_tpu_torch.rl.learner import make_jitted_train_step, make_train_state, train_step

    cfg = AZNetConfig(board_size=9, channels=32, blocks=2, dtype=torch.float32)
    nets = [init_params(torch.Generator().manual_seed(0), cfg).to(cuda_device) for _ in range(2)]
    eager, jit_state = make_train_state(nets[0], 1e-3), make_train_state(nets[1], 1e-3)
    for group in eager.optimizer.param_groups:
        group["capturable"] = True
    step = make_jitted_train_step(jit_state)
    rng = np.random.default_rng(9)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i, rows in enumerate((48, 48, 48, 32)):
            obs = torch.from_numpy(midgame_states(9, rows, 20, i)).to(cuda_device)
            pi = torch.softmax(torch.from_numpy(rng.standard_normal((rows, 82)).astype(np.float32)), 1)
            v = torch.from_numpy(rng.choice([-1.0, 1.0], rows).astype(np.float32))
            mask = torch.from_numpy(rng.random(rows) < 0.9)
            batch = tuple(x.to(cuda_device) for x in (obs, pi, v, mask, mask))
            eager, want = train_step(eager, batch)
            jit_state, got = step(jit_state, batch)
            for k in want:
                assert torch.equal(got[k], want[k]), (i, k)
            for p, q in zip(eager.net.parameters(), jit_state.net.parameters()):
                assert torch.equal(p, q), i
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert jit_state.step == 4
    nets[1].zero_grad(set_to_none=True)
    with pytest.raises(RuntimeError, match="replaced"):
        step(jit_state, batch)


def test_compiled_gogame_functions_equal_eager_on_the_card(cuda_device):
    from gymgo_tpu_torch import gogame

    states = torch.from_numpy(midgame_states(19, 8, 120, 10)).to(cuda_device)
    actions = torch.arange(8, dtype=torch.int32, device=cuda_device) * 40
    calls = [(gogame._step_states, (states, actions), {}), (gogame._batch_canonical, (states,), {}),
             (gogame._children_jit, (states[0],), {"canonical": True}), (gogame._areas_jit, (states,), {}),
             (gogame._num_liberties_jit, (states,), {}), (gogame._liberties_jit, (states,), {})]
    for fn, args, kw in calls:
        want = fn.fn(*args, **kw)
        for _ in range(3):
            got = fn(*args, **kw)
            flat = (lambda t: list(t) if isinstance(t, tuple) else [t])
            got_l = [y for x in flat(got) for y in flat(x)]
            want_l = [y for x in flat(want) for y in flat(x)]
            assert all(torch.equal(a, b) for a, b in zip(got_l, want_l)), fn.__name__
        assert any(g.replays >= 2 for g in fn.graphs.values()), fn.__name__
    # a game through the facade, GoEnv's path: the card equals the CPU
    np.random.seed(0)
    state = gogame.init_state(19)
    for _ in range(40):
        action = gogame.random_action(state)
        on_card = gogame.next_state(state, action, device=cuda_device)
        assert np.array_equal(on_card, gogame.next_state(state, action, device="cpu"))
        state = on_card


def _search_setup(device, b, n=9):
    """The 9x9 net in bfloat16, as GTP and the eval tools run it, and ``b``
    mid-game boards."""
    from gymgo_tpu_torch.convert import load_aznet_npz

    net = load_aznet_npz(_ARTIFACTS / "az9_r5_iter100_params.npz", device=device, dtype=torch.bfloat16)
    return net, _midgame(device, n, b, 40)


def _search(kind, gen, states, net, fn=None):
    """A Gumbel or a PUCT search (with a warm tree of 12 slots), compiled, or
    eager with ``fn="eager"``."""
    from gymgo_tpu_torch.rl import gumbel_mcts, mcts

    if kind == "gumbel":
        run = gumbel_mcts.run_gumbel_mcts
        kw = dict(num_simulations=16, max_considered=8)
    else:
        run = mcts.run_mcts
        warm = mcts.empty_tree(states.shape[0], 12, 82, states.shape[1:], states.dtype, device=states.device)
        kw = dict(num_simulations=16, num_parallel=2, warm_tree=warm, return_tree=True)
    return (run.fn if fn == "eager" else run)(gen, states, net, **kw)


def _flat(tree):
    return [y for x in tree for y in (_flat(x) if isinstance(x, tuple) else [x])]


@pytest.mark.parametrize("kind", ["gumbel", "puct"])
def test_compiled_search_equals_eager_over_replays_and_a_batch_change(kind, cuda_device):
    from gymgo_tpu_torch.rl import gumbel_mcts, mcts

    compiled_fn = gumbel_mcts.run_gumbel_mcts if kind == "gumbel" else mcts.run_mcts
    net, states = _search_setup(cuda_device, 48)
    gc, ge = (torch.Generator(device=cuda_device).manual_seed(21) for _ in range(2))
    per_search = 2 * 16 if kind == "gumbel" else 2 * 16 // 2  # a step (2 launches) a simulation / a wave
    for rows in (48, 48, 48, 20, 20):  # a first call, two replays; then a new batch
        launches = tbundle.BUNDLE_FLOOD.launches
        got = _search(kind, gc, states[:rows], net)
        assert tbundle.BUNDLE_FLOOD.launches - launches == per_search
        want = _search(kind, ge, states[:rows], net, fn="eager")
        assert all(torch.equal(x, y) for x, y in zip(_flat(got), _flat(want)))
        assert torch.equal(gc.get_state(), ge.get_state())
    assert sorted(g.replays for k, g in compiled_fn.graphs.items() if _holds(k, net)) == [1, 2]


def _holds(key, net):
    return any(part == ("net", net) for part in key[0])


def test_replayed_search_and_move_make_no_host_sync(cuda_device):
    from gymgo_tpu_torch.rl import selfplay

    net, states = _search_setup(cuda_device, 32)
    g = torch.Generator(device=cuda_device).manual_seed(22)
    cfg = EnvConfig(board_size=9, batch_size=32, auto_reset=True)
    for kind in ("gumbel", "puct"):
        _search(kind, g, states, net)  # eager first run, then the capture
        with _no_host_sync():
            _search(kind, g, states, net)
    kw = dict(num_simulations=8, max_considered=4)
    selfplay.selfplay_gumbel_rollout(g, states, net, 1, cfg, **kw)  # the move's capture
    launches = tbundle.BUNDLE_FLOOD.launches
    with _no_host_sync():
        _, rows, _ = selfplay._move(g, states, (None,), None, net=net, config=cfg, act=selfplay._act_gumbel,
                                    settings=tuple(sorted(dict(pass_min_stones=0, **kw).items())))
    assert tbundle.BUNDLE_FLOOD.launches - launches == 2 * 8 + 2  # the search's steps and the move's
    assert not rows[6].any()  # no invalid action


def test_a_gumbel_layout_switch_captures_a_new_graph(cuda_device):
    from gymgo_tpu_torch.rl import gumbel_mcts

    net, states = _search_setup(cuda_device, 16)
    g = torch.Generator(device=cuda_device).manual_seed(23)
    before_graphs = len(gumbel_mcts.run_gumbel_mcts.graphs)
    _search("gumbel", g, states, net)
    before = gumbel_mcts.set_gumbel_pack({"i16", "logp"})
    try:
        got = _search("gumbel", torch.Generator(device=cuda_device).manual_seed(24), states, net)
        want = _search("gumbel", torch.Generator(device=cuda_device).manual_seed(24), states, net, fn="eager")
    finally:
        gumbel_mcts.set_gumbel_pack(before)
    assert len(gumbel_mcts.run_gumbel_mcts.graphs) == before_graphs + 2
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_compiled_window_and_match_equal_eager(cuda_device):
    from gymgo_tpu_torch.core.actions import uniform_random_actions
    from gymgo_tpu_torch.rl import evaluate, selfplay
    from gymgo_tpu_torch.rl.gumbel_mcts import make_gumbel_mcts_policy

    net, states = _search_setup(cuda_device, 24)
    cfg = EnvConfig(board_size=9, batch_size=24, auto_reset=True)
    kw = dict(num_simulations=8, tree_reuse="subtree", reuse_cap=6)
    gc, ge = (torch.Generator(device=cuda_device).manual_seed(25) for _ in range(2))
    fc, bc = selfplay.selfplay_mcts_rollout(gc, states, net, 3, cfg, **kw)
    with graphs.eager():
        fe, be = selfplay.selfplay_mcts_rollout(ge, states, net, 3, cfg, **kw)
    assert torch.equal(fc, fe) and all(torch.equal(x, y) for x, y in zip(bc, be))
    policy = evaluate.with_pass_to_win(make_gumbel_mcts_policy(net, num_simulations=8, max_considered=4))
    results = []
    for context in (contextlib.nullcontext, graphs.eager):
        with context():
            results.append(evaluate.play_match(torch.Generator(device=cuda_device).manual_seed(26), policy,
                                               uniform_random_actions, EnvConfig(board_size=9), num_games=8,
                                               max_steps=30, opening_moves=2, with_states=True,
                                               device=cuda_device))
    (rc, sc), (re, se) = results
    assert torch.equal(sc, se) and all(torch.equal(x, y) for x, y in zip(rc, re))
    assert any(g.replays for g in evaluate._ply.graphs.values())


def _gna_case(device, dtype, b, n, c, seed):
    """A convolution-like activation (per-channel offset and scale), a
    residual, GroupNorm's weight and bias; the activations channels-last."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = (torch.randn(b, c, n, n, device=device, generator=g) * (0.5 + torch.rand(c, 1, 1, device=device, generator=g))
         + torch.randn(c, 1, 1, device=device, generator=g)).to(dtype)
    res = torch.randn(b, c, n, n, device=device, generator=g).to(dtype)
    weight = (1 + 0.1 * torch.randn(c, device=device, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(c, device=device, generator=g)).to(dtype)
    return tuple(t.contiguous(memory_format=torch.channels_last) for t in (h, res)) + (weight, bias)


def _gna_exact(h, weight, bias, eps, res):
    """The kernel's arithmetic with float64 statistics: mean and rstd rounded
    to the working type as the library keeps them, then its float32 affine,
    roundings and relu.  Also the largest term of each element's sum."""
    b, c = h.shape[:2]
    hg = h.double().reshape(b, 8, -1)
    mean, var = hg.mean(-1).float(), hg.var(-1, unbiased=False)
    rstd = (var.float() + eps).rsqrt().to(h.dtype).float()
    mean = mean.to(h.dtype).float()
    a = (rstd.repeat_interleave(c // 8, 1) * weight.float())[:, :, None, None]
    shift = (-a * mean.repeat_interleave(c // 8, 1)[:, :, None, None] + bias.float()[:, None, None])
    y = (h.float() * a + shift).to(h.dtype)
    terms = torch.maximum((h.float() * a).abs(), shift.abs())
    if res is not None:
        y = (res.float() + y.float()).to(h.dtype)
        terms = torch.maximum(terms, res.float().abs())
    return torch.relu(y), torch.maximum(terms, y.float().abs())


FP32_GNA_ULPS = 8  # the float32 kernel's distance from the float64-statistics result, in ulps of the largest term


def _ulp(dtype, magnitude):
    return torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(magnitude.clamp_min(1.0))))


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("n", [9, 19, 64])
@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_group_norm_act_kernel_matches_plain(dtype, b, n, c, cuda_device):
    """bfloat16: each element within 1 ulp of the plain path (the library's
    group_norm, relu and add), or of the same arithmetic with float64
    statistics where the library's own float32 sums lie further off (64x64 at
    batch 256, which takes the streamed form).  float32: 1 ulp of the output
    is below the error of any float32 sum of the statistics (the plain path
    itself reads 2-6 ulps of each element's largest term from the float64
    statistics on these inputs), so the kernel is held within 8 ulps of the
    largest term of the float64-statistics result; the plain path's reading
    is printed beside it."""
    from gymgo_tpu_torch.ops import group_norm_act as gna

    h, res, weight, bias = _gna_case(cuda_device, dtype, b, n, c, b * n + c)
    for r in (None, res):
        launches = gna.GROUP_NORM_ACT.launches
        got = gna.group_norm_act_cuda(h, 8, weight, bias, 1e-6, r)
        assert gna.GROUP_NORM_ACT.launches == launches + 1
        assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
        want = gna.group_norm_act_plain(h, 8, weight, bias, 1e-6, r)
        assert torch.equal(gna.group_norm_act_cuda(h, 8, weight, bias, 1e-6, r), got)  # the same sums each call
        exact, terms = _gna_exact(h, weight, bias, 1e-6, r)
        off = (got.float() - want.float()).abs()
        got_err = ((got.float() - exact.float()).abs() / _ulp(dtype, terms)).max().item()
        want_err = ((want.float() - exact.float()).abs() / _ulp(dtype, terms)).max().item()
        print(f"{dtype} B={b} N={n} C={c} residual={r is not None}: unequal {(got != want).float().mean().item():.3e}"
              f", max {(off / _ulp(dtype, want.float().abs())).max().item():.1f} ulps of the plain path; from the "
              f"float64 statistics, at the largest term: kernel {got_err:.1f}, plain {want_err:.1f} ulps")
        if dtype == torch.bfloat16:
            scale = want.float().abs() if r is None else torch.maximum(want.float().abs(), r.float().abs())
            near_exact = (got.float() - exact.float()).abs() <= _ulp(dtype, scale)
            assert ((off <= _ulp(dtype, scale)) | near_exact).all()
        else:
            assert got_err <= FP32_GNA_ULPS
        assert (got == 0).any() and (got > 0).any()


def test_group_norm_act_kernel_rejects_bad_input(cuda_device):
    from gymgo_tpu_torch.ops import group_norm_act as gna

    h, res, weight, bias = _gna_case(cuda_device, torch.bfloat16, 2, 9, 32, 0)
    with pytest.raises(ValueError, match="channels-last"):
        gna.group_norm_act_cuda(h.contiguous(), 8, weight, bias, 1e-6)
    with pytest.raises(TypeError):
        gna.group_norm_act_cuda(h.half(), 8, weight.half(), bias.half(), 1e-6)
    with pytest.raises(ValueError, match="weight"):
        gna.group_norm_act_cuda(h, 8, weight.float(), bias, 1e-6)
    with pytest.raises(ValueError, match="residual"):
        gna.group_norm_act_cuda(h, 8, weight, bias, 1e-6, res.contiguous())
    with pytest.raises(ValueError, match="groups"):
        gna.group_norm_act_cuda(h, 7, weight, bias, 1e-6)


def _agz20_served_net(device):
    """The 20-block AlphaGo Zero net (256 filters) in bfloat16, built as the
    benchmark builds it: on ``meta``, ``to_empty``, then ``copy_`` into each
    parameter."""
    from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig

    cfg = AZNetConfig(board_size=19, channels=256, blocks=19, policy_channels=2, value_channels=1)
    with torch.device("meta"):
        net = AZNet(cfg)
    net = net.to_empty(device=device).eval().requires_grad_(False)
    g = torch.Generator(device=device).manual_seed(5)
    for name, p in net.named_parameters():
        if p.dim() > 1:
            p.copy_(torch.randn(p.shape, device=device, generator=g) * p[0].numel() ** -0.5)
        else:
            p.copy_(1 + 0.1 * torch.randn(p.shape, device=device, generator=g) if name.endswith("norm.weight") else
                    0.1 * torch.randn(p.shape, device=device, generator=g))
    return net


def test_served_20_block_net_converts_no_layout_and_launches_39_norms(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from gymgo_tpu_torch.ops import group_norm_act as gna

    net = _agz20_served_net(cuda_device)
    assert all(m.weight.is_contiguous(memory_format=torch.channels_last)
               for m in net.modules() if isinstance(m, torch.nn.Conv2d))
    states = _midgame(cuda_device, 19, 256, 120)
    with torch.no_grad():
        net(states)  # cuDNN's choice of algorithms, outside the profile
        torch.cuda.synchronize()
        launches = gna.GROUP_NORM_ACT.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            logits, value = net(states)
            torch.cuda.synchronize()
    assert gna.GROUP_NORM_ACT.launches == launches + 39
    names = [e.key for e in prof.key_averages()]
    assert any("resident_kernel" in k for k in names)
    assert not [k for k in names if "nchwToNhwc" in k or "nhwcToNchw" in k]
    # the library's NCHW forward, as autograd records it, on the same weights
    with torch.enable_grad():
        launches = gna.GROUP_NORM_ACT.launches
        plain_logits, plain_value = net(states)
        assert gna.GROUP_NORM_ACT.launches == launches
    assert (logits - plain_logits).abs().max() <= 0.02 * (plain_logits.max() - plain_logits.min())
    assert (value - plain_value).abs().max() <= 0.02


def test_served_forward_follows_refreshed_weights(cuda_device):
    from gymgo_tpu_torch.models.az_net import AZNetConfig, acting_copy, init_params, refresh_

    cfg = AZNetConfig(board_size=9, channels=32, blocks=2, policy_channels=2, value_channels=1)
    master = init_params(torch.Generator(device=cuda_device).manual_seed(9), cfg)
    served = acting_copy(master)
    states = _midgame(cuda_device, 9, 16, 30)
    with torch.no_grad():
        before = served(states)
        for p in master.parameters():
            p.add_(0.2 * torch.randn(p.shape, device=cuda_device, generator=torch.Generator(device=cuda_device)
                                     .manual_seed(p.numel())))
        refresh_(served, master)
        after = served(states)
        fresh = acting_copy(master)(states)
    assert not torch.equal(before[0], after[0])
    assert all(torch.equal(x, y) for x, y in zip(after, fresh))
    assert all(w.is_contiguous(memory_format=torch.channels_last)
               for w in (m.weight for m in served.modules() if isinstance(m, torch.nn.Conv2d)))
