"""The fused GroupNorm + relu (+ residual) of ``gymgo_tpu_torch.ops.group_norm_act``
and the served ``AZNet`` around it, on the CPU.

The wrapper's plain path is the library's ``group_norm``, ``relu`` and add, bit
for bit.  ``AZNet``'s CPU forward equals, bit for bit, a frozen copy of the
forward the port had before the card's forward became channels-last and fused
(``_frozen_forward``), on a net whose convolution kernels are laid out as they
were then (contiguous).  A forward on the CPU, or with autograd recording,
never reaches the kernel.  The kernel itself is held against the plain path on
the card (``tests/test_torch_cuda.py``).  One intra-op thread.
"""

import pytest
import torch
import torch.nn.functional as F

from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig, acting_copy, init_params, refresh_
from gymgo_tpu_torch.ops import group_norm_act as gna
from torch_boards import midgame_states


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _activation(b, c, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    # a per-channel offset and scale, as a convolution's output has
    x = torch.randn(b, c, n, n, generator=g) * (0.5 + torch.rand(c, 1, 1, generator=g)) + torch.randn(c, 1, 1,
                                                                                                          generator=g)
    return x.to(dtype)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_plain_path_is_the_library_ops(dtype, c, n, b):
    h, x = _activation(b, c, n, dtype, 1), _activation(b, c, n, dtype, 2)
    g = torch.Generator().manual_seed(3)
    weight, bias = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype), (0.1 * torch.randn(c, generator=g)).to(dtype)
    norm = F.group_norm(h, 8, weight, bias, 1e-6)
    got = gna.group_norm_act_plain(h, 8, weight, bias, 1e-6)
    assert got.dtype == dtype and torch.equal(got, F.relu(norm))
    assert torch.equal(gna.group_norm_act_plain(h, 8, weight, bias, 1e-6, residual=x), F.relu(x + norm))
    assert (F.relu(norm) == 0).any() and (F.relu(norm) > 0).any()


def test_the_kernel_path_refuses_cpu_tensors():
    h = _activation(1, 32, 9, torch.float32, 0)
    with pytest.raises(ValueError, match="CUDA"):
        gna.group_norm_act_cuda(h, 8, torch.ones(32), torch.zeros(32), 1e-6)


def _conv(conv, x):
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, padding=conv.padding)


def _norm(norm, x):
    return F.group_norm(x, norm.num_groups, norm.weight.to(x.dtype), norm.bias.to(x.dtype), norm.eps)


def _dense(dense, x):
    return F.linear(x, dense.weight.to(x.dtype), dense.bias.to(x.dtype))


def _frozen_forward(net, states):
    """``AZNet.forward`` as it was before the served path: NCHW, the library's
    operations."""
    x = states.to(net.config.dtype)
    x = F.relu(_norm(net.stem_norm, _conv(net.stem, x)))
    for block in net.blocks:
        h = F.relu(_norm(block.norm_0, _conv(block.conv_0, x)))
        h = _norm(block.norm_1, _conv(block.conv_1, h))
        x = F.relu(x + h)
    p = F.relu(_conv(net.policy_conv, x)).flatten(1)
    policy_logits = _dense(net.policy_out, p)
    v = F.relu(_conv(net.value_conv, x)).flatten(1)
    v = F.relu(_dense(net.value_hidden, v))
    value = torch.tanh(_dense(net.value_out, v.to(torch.float32)))[:, 0]
    return policy_logits.to(torch.float32), value


def _kernels(net):
    return [m.weight for m in net.modules() if isinstance(m, torch.nn.Conv2d)]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cpu_forward_equals_the_frozen_forward(dtype, grad):
    cfg = AZNetConfig(board_size=9, channels=32, blocks=2, policy_channels=2, value_channels=1, dtype=dtype)
    master = init_params(torch.Generator().manual_seed(4), cfg)
    with torch.no_grad():
        for p in master.parameters():  # every leaf away from its init, so each shows in the output
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    served = acting_copy(master)
    assert all(w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous()
               for w in _kernels(served) if w.shape[-1] > 1)
    assert all(w.is_contiguous() for w in _kernels(master))
    # the same rounded parameters, laid out as before
    old_layout = AZNet(cfg, dtype).eval().requires_grad_(False)
    refresh_(old_layout, master)
    states = torch.from_numpy(midgame_states(9, 6, 30, 5))
    launches = gna.GROUP_NORM_ACT.launches
    with torch.set_grad_enabled(grad):
        for net in (served, master):
            got = net(states)
            want = _frozen_forward(old_layout if net is served else net, states)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert gna.GROUP_NORM_ACT.launches == launches


def test_grad_forward_keeps_autograd_and_never_launches():
    cfg = AZNetConfig(board_size=5, channels=16, blocks=1, policy_channels=2, value_channels=2, dtype=torch.float32)
    net = init_params(torch.Generator().manual_seed(6), cfg)
    launches = gna.GROUP_NORM_ACT.launches
    logits, value = net(torch.from_numpy(midgame_states(5, 4, 6, 7)))
    (logits.square().sum() + value.sum()).backward()
    assert all(p.grad is not None for p in net.parameters())
    assert gna.GROUP_NORM_ACT.launches == launches


def test_weights_made_on_meta_and_copied_in_come_out_channels_last():
    """The way a benchmark or loader builds a serving net: on ``meta``, then
    ``to_empty``, then ``copy_`` into each parameter."""
    cfg = AZNetConfig(board_size=9, channels=32, blocks=2, policy_channels=2, value_channels=1)
    with torch.device("meta"):
        net = AZNet(cfg)
    net = net.to_empty(device="cpu").eval().requires_grad_(False)
    for name, p in net.named_parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape).to(p.dtype))
    for w in _kernels(net):
        assert w.is_contiguous(memory_format=torch.channels_last)
    assert [tuple(p.shape) for p in net.parameters()] == [tuple(p.shape) for p in AZNet(cfg, torch.float32).parameters()]
