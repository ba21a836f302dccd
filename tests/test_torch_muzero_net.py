"""MuZero's Go network in the port (``models/muzero_net.py``) against the
plain float32 reference (``tests/muzero_reference.py``) on the CPU, at a
small size with seeded random weights."""

import pytest
import torch

import muzero_reference as ref
from gymgo_tpu_torch.core.transform import batch_canonical_form
from gymgo_tpu_torch.models import muzero_net
from gymgo_tpu_torch.models.muzero_net import MuZeroNetConfig
from torch_boards import midgame_states

N, C = 9, 32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_net(seed=0, dtype=torch.float32):
    """A net of float32 parameters computing in ``dtype``, every parameter
    drawn (norm scales and biases too, so none is a no-op), and its weights
    by name."""
    g = torch.Generator().manual_seed(seed)
    net = muzero_net.init_params(g, MuZeroNetConfig(N, C, 2, dtype=dtype))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 + (1.0 if "norm" in name and "weight" in name else 0))
    weights = {name: p.detach().clone() for name, p in net.named_parameters()}
    return net.eval(), weights


def states(b=8, seed=3):
    return torch.from_numpy(midgame_states(N, b, 20 + seed, seed))


def close(got, want, ulps=64):
    """Equal to float32 rounding: the two forwards run the same operations
    but for the order of some sums (the action plane's channel, the norm's
    statistics); ``ulps`` float32 ulps of the largest magnitude."""
    tol = ulps * torch.finfo(torch.float32).eps * max(1.0, float(want.abs().max()))
    assert float((got.float() - want).abs().max()) <= tol, float((got.float() - want).abs().max())


@torch.no_grad()
def test_represent_matches_the_reference_and_lies_in_the_unit_range():
    net, w = random_net()
    st = states()
    got = net.represent(batch_canonical_form(st))
    want = ref.represent(w, st)
    close(got, want)
    assert got.min() == 0 and got.amax(dim=(1, 2, 3)).eq(1).all()


@pytest.mark.parametrize("where", ["pass", "corner", "edge", "interior"])
@torch.no_grad()
def test_dynamics_matches_the_reference_for_each_kind_of_move(where):
    net, w = random_net(1)
    st = states(6, 4)
    s = ref.represent(w, st)
    move = {"pass": N * N, "corner": N * N - 1, "edge": 4, "interior": 4 * N + 5}[where]
    actions = torch.full((len(st),), move)
    got = net.dynamics(s, actions)
    want = ref.dynamics(w, s, actions)
    close(got, want)
    assert ((got >= 0) & (got <= 1)).all()
    if where != "pass":  # the action reaches the hidden state
        assert not torch.equal(got, net.dynamics(s, torch.full_like(actions, N * N)))


@torch.no_grad()
def test_predict_and_the_whole_forward_match_the_reference():
    net, w = random_net(2)
    st = states(8, 5)
    s = ref.represent(w, st)
    logits, value = net.predict(s)
    want_logits, want_value = ref.predict(w, s)
    assert logits.shape == (8, N * N + 1) and logits.dtype == value.dtype == torch.float32
    close(logits, want_logits)
    close(value, want_value)
    f_logits, f_value = net(batch_canonical_form(st))  # forward is f(h(obs))
    close(f_logits, ref.predict(w, ref.represent(w, st))[0])


@torch.no_grad()
def test_the_dynamics_input_gathers_each_boards_parent_slot():
    net, w = random_net(3)
    st = states(5, 6)
    store = net.latent_store(3, 5, "cpu")
    net.represent(batch_canonical_form(st), out=store[0])
    net.dynamics(store[0], torch.arange(5), out=store[1])
    net.dynamics(store[0], torch.arange(5) + 10, out=store[2])
    parent = torch.tensor([0, 2, 1, 2, 0])
    actions = torch.tensor([3, N * N, 7, 0, 80])
    s, a = net.dynamics_input(store, parent, actions)
    assert torch.equal(s, store[parent, torch.arange(5)]) and a is actions
    close(net.dynamics_from_input((s, a)), ref.dynamics(w, s, actions))
    assert torch.equal(muzero_net.action_plane(actions, N, torch.float32), ref.action_plane(actions, N))


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_the_stamped_action_equals_the_convolution_over_the_action_plane(layout):
    """The served ``g``'s first convolution: the state convolved alone, the
    action's filter stamped at its point (clipped at the edge, nothing for a
    pass), equal to the convolution over the action plane to rounding."""
    g = torch.Generator().manual_seed(9)
    w = torch.randn(16, 17, 3, 3, generator=g)
    s = torch.randn(9, 16, N, N, generator=g).contiguous(memory_format=layout)
    actions = torch.tensor([0, N - 1, N * N - N, N * N - 1, N * N, 3, 4 * N, 5 * N - 1, 4 * N + 4])
    want = torch.nn.functional.conv2d(torch.cat([s, ref.action_plane(actions, N)], 1), w, padding=1)
    got = torch.nn.functional.conv2d(s, w[:, :16].contiguous(memory_format=torch.channels_last), padding=1)
    got = got.contiguous(memory_format=torch.channels_last)
    muzero_net._stamp_(got, w[:, 16], actions)
    close(got, want)


def test_scale_clamps_a_flat_state_and_rounds_to_the_working_type():
    flat = torch.full((2, 4, 3, 3), 0.25)
    assert torch.equal(muzero_net.scale(flat), torch.zeros_like(flat))  # (x - min) / 1e-5
    x = torch.randn(3, 4, 5, 5).to(torch.bfloat16).to(memory_format=torch.channels_last)
    got = muzero_net.scale(x)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref.scale(x.float()).to(torch.bfloat16))


@torch.no_grad()
def test_bfloat16_stays_within_its_rounding_of_the_reference():
    """The served type: every layer rounds its output to bfloat16 (8 bits of
    mantissa, a step of 2**-8 near 1), through 5 convolutions and norms of
    ``h`` and 5 of ``g`` here.  Over seeds 4-8 the scaled states lay 0.010 to
    0.025 from the float32 reference's (three to six steps near 1), the
    logits within 0.5% of their range and the value within 0.0014; the
    limits give twice that and more: 0.05, 2% and 0.01."""
    net32, w = random_net(4, torch.bfloat16)
    net16 = muzero_net.acting_copy(net32)
    assert next(net16.h.parameters()).dtype == torch.bfloat16
    st = states(8, 7)
    s16 = net16.represent(batch_canonical_form(st))
    s32 = ref.represent(w, st)
    assert s16.dtype == torch.bfloat16 and float((s16.float() - s32).abs().max()) < 0.05
    actions = torch.arange(8) * 7
    d16 = net16.dynamics(s16, actions)
    d32 = ref.dynamics(w, s32, actions)
    assert float((d16.float() - d32).abs().max()) < 0.05
    logits, value = net16.predict(d16)
    want_logits, want_value = ref.predict(w, d32)
    span = float(want_logits.max() - want_logits.min())
    assert float((logits - want_logits).abs().max()) < 0.02 * span
    assert float((value - want_value).abs().max()) < 0.01
