"""The flood kernels on a CUDA card: each against its plain version, on the
rollout of its route, and on bad input.  Imports no JAX, so it runs on a machine without
it (``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``); every
test skips where there is no card.
"""

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core.flood import bundle_flood_plain, minmax_flood_plain
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from gymgo_tpu_torch.ops import minmax_flood as tminmax
from torch_boards import adversarial_boards, component_boards, random_boards

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
