"""The network's weights, made by the benchmark from the seed on the device,
and the program's network built around them.

One normal draw in bfloat16 (the type the network is served in) covers every
convolution and dense kernel, each slice scaled to variance 1 / fan_in
(fan_in = kernel height x width x inputs for a convolution, inputs for a
dense layer) and each filter's weights shifted to sum to zero; GroupNorm
scales are 1 and every bias 0.  The reference gets the same values in
float32.
"""

from __future__ import annotations

import torch

from portbench.lib import seeds


def program_net(config: dict, seed: int, device):
    """``(net, weights)``: the program's ``AZNet`` for ``config`` in eval mode
    with the benchmark's weights, and those weights as a dict of float32
    tensors by parameter name."""
    from gymgo_tpu_torch.models.az_net import AZNet, AZNetConfig

    dtype = getattr(torch, config["dtype"])
    cfg = AZNetConfig(board_size=config["board_size"], channels=config["channels"], blocks=config["blocks"],
                      policy_channels=config["policy_channels"], value_channels=config["value_channels"],
                      dtype=dtype)
    with torch.device("meta"):
        net = AZNet(cfg)
    net = net.to_empty(device=device).eval().requires_grad_(False)
    named = list(net.named_parameters())
    kernels = [(name, p) for name, p in named if p.dim() > 1]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    draw = torch.randn(sum(p.numel() for _, p in kernels), generator=gen, device=device, dtype=dtype)
    weights, at = {}, 0
    for name, p in named:
        if p.dim() > 1:
            fan_in = p[0].numel()
            w = draw[at:at + p.numel()].view(p.shape).to(torch.float32) * fan_in ** -0.5
            # zero-mean filters: a head's 1x1 convolution or dense layer reads non-negative
            # (relu'd) inputs, and a filter whose weights sum far from zero is on or off
            # at every cell alike, a dead head on some seeds
            w = (w - w.mean(dim=tuple(range(1, w.dim())), keepdim=True)).to(dtype)
            at += p.numel()
        elif "norm" in name and name.endswith("weight"):
            w = torch.ones(p.shape, device=device, dtype=dtype)
        else:
            w = torch.zeros(p.shape, device=device, dtype=dtype)
        with torch.no_grad():
            p.copy_(w)
        weights[name] = w.to(torch.float32)
    return net, weights
