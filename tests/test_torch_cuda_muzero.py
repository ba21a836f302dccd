"""MuZero's network and Gumbel MuZero on a CUDA card: the served bfloat16
``MuZeroNet`` at 19x19 and 256 wide against the plain float32 reference
(``tests/muzero_reference.py``, TF32 off), the store's gather on the card
against its meaning, and the learned search captured into one CUDA graph
against its eager form.  Imports no JAX (``python -m pytest --noconftest
tests/test_torch_cuda_muzero.py -m cuda``); every test skips where there is
no card.
"""

import contextlib

import numpy as np
import pytest
import torch

import muzero_reference as ref
from gymgo_tpu_torch.core.transform import batch_canonical_form
from gymgo_tpu_torch.models import muzero_net
from gymgo_tpu_torch.models.muzero_net import MuZeroNetConfig
from gymgo_tpu_torch.rl import gumbel_mcts
from gymgo_tpu_torch.utils import tracing
from torch_boards import midgame_states

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def no_host_sync():
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def served_net(device, n=19, channels=256, blocks=15, seed=0):
    """The served bfloat16 net, its float32 weights by name."""
    g = torch.Generator(device=device).manual_seed(seed)
    master = muzero_net.init_params(g, MuZeroNetConfig(n, channels, blocks))
    return muzero_net.acting_copy(master), {k: p.detach() for k, p in master.named_parameters()}


def test_the_served_net_at_full_size_stays_within_bfloat16_of_the_reference(cuda_device):
    """19x19, 256 wide, 15 blocks a tower: the scaled states within 0.06 of
    the float32 reference's (15 bfloat16 steps near 1, after 31 rounded
    layers), the logits within 3% of their range and the value within
    0.02."""
    net, w = served_net(cuda_device)
    states = torch.from_numpy(midgame_states(19, 16, 60, 1)).to(cuda_device)
    actions = torch.tensor([0, 18, 180, 360, 361, 7] + list(range(40, 50)), device=cuda_device)
    with torch.no_grad():
        s = net.represent(batch_canonical_form(states))
        assert s.dtype == torch.bfloat16 and s.is_contiguous(memory_format=torch.channels_last)
        s_ref = ref.represent(w, states)
        assert float((s.float() - s_ref).abs().max()) < 0.06
        d = net.dynamics(s, actions)
        d_ref = ref.dynamics(w, s_ref, actions)
        assert ((d >= 0) & (d <= 1)).all() and float((d.float() - d_ref).abs().max()) < 0.06
        logits, value = net.predict(d)
        want_logits, want_value = ref.predict(w, d_ref)
    span = float(want_logits.max() - want_logits.min())
    assert float((logits - want_logits).abs().max()) < 0.03 * span
    assert float((value - want_value).abs().max()) < 0.02


def test_the_store_gather_on_the_card_reads_each_boards_parent(cuda_device):
    net, _ = served_net(cuda_device, 19, 256, 1)
    b = 12
    parent = torch.tensor([0, 4, 2, 1, 3, 0, 4, 4, 2, 1, 0, 3], device=cuda_device)
    actions = torch.tensor([0, 361, 18, 342, 360, 180, 5, 6, 7, 8, 361, 100], device=cuda_device)
    with torch.no_grad():  # the served path
        store = net.latent_store(5, b, cuda_device)
        assert store[3].is_contiguous(memory_format=torch.channels_last)
        store.copy_(torch.rand(store.shape, device=cuda_device))
        s, a = net.dynamics_input(store, parent, actions)
    assert s.is_contiguous(memory_format=torch.channels_last) and a is actions
    assert torch.equal(s, store[parent, torch.arange(b, device=cuda_device)])


def test_the_stamped_action_equals_the_convolution_over_the_action_plane(cuda_device):
    """The served ``g`` convolves the state alone and stamps the action's
    filter: in float32 (TF32 off) equal to the 257-plane convolution to
    rounding, at the corners, the edges, the middle and for a pass."""
    torch.manual_seed(0)
    w = torch.randn(32, 33, 3, 3, device=cuda_device)
    s = torch.randn(9, 32, 19, 19, device=cuda_device).contiguous(memory_format=torch.channels_last)
    actions = torch.tensor([0, 18, 342, 360, 361, 9, 171, 189, 180], device=cuda_device)
    with ref.no_tf32():
        want = torch.nn.functional.conv2d(torch.cat([s, ref.action_plane(actions, 19)], 1), w, padding=1)
        got = torch.nn.functional.conv2d(s, w[:, :32].contiguous(memory_format=torch.channels_last), padding=1)
        muzero_net._stamp_(got, w[:, 32], actions)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_the_graphed_learned_search_equals_its_eager_form_without_a_host_sync(cuda_device):
    net, _ = served_net(cuda_device, 19, 64, 2)
    states = torch.from_numpy(midgame_states(19, 24, 50, 2)).to(cuda_device)
    noise = torch.from_numpy(np.random.default_rng(3).gumbel(size=(24, 362)).astype(np.float32)).to(cuda_device)
    run = gumbel_mcts.run_gumbel_mcts
    before = len(run.graphs)
    kw = dict(num_simulations=16, max_considered=8, gumbel=noise, latent_rows=torch.tensor([5, 0], device=cuda_device))
    run(None, states, net, **kw)  # the eager first run, then the capture
    assert len(run.graphs) == before + 1
    rows = tracing.counters["search.dynamics_rows"]
    with no_host_sync():
        got = run(None, states, net, **kw)
    assert tracing.counters["search.dynamics_rows"] - rows == 16 * 24  # the replay counts its g rows
    want = run.fn(None, states, net, **kw)
    assert isinstance(got, gumbel_mcts.LearnedMCTSResult)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert got.node_latents.shape == (2, 17, 64, 19, 19)
    assert (got.node_parent[:, 1:] > 0).any()


def test_a_captured_learned_search_follows_weights_refreshed_in_place(cuda_device):
    """``g``'s first convolution splits its weight inside the graph, so a
    replay after ``refresh_`` reads the new weights, as the eager search
    does."""
    from gymgo_tpu_torch.models.az_net import refresh_

    g = torch.Generator(device=cuda_device).manual_seed(4)
    master = muzero_net.init_params(g, MuZeroNetConfig(19, 64, 1))
    net = muzero_net.acting_copy(master)
    states = torch.from_numpy(midgame_states(19, 8, 40, 4)).to(cuda_device)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(size=(8, 362)).astype(np.float32)).to(cuda_device)
    run = gumbel_mcts.run_gumbel_mcts
    kw = dict(num_simulations=8, max_considered=4, gumbel=noise)
    run(None, states, net, **kw)
    before = run(None, states, net, **kw)
    with torch.no_grad():
        master.g.stem.weight.mul_(-1.5)
    refresh_(net, master)
    after = run(None, states, net, **kw)
    want = run.fn(None, states, net, **kw)
    assert not torch.equal(before.node_logits, after.node_logits)
    assert all(torch.equal(x, y) for x, y in zip(after, want) if x is not None)
