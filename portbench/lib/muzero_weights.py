"""MuZero's network with the benchmark's weights, made from the seed on the
device as ``weights.py`` makes AZNet's: one normal draw in bfloat16 (the type
the network is served in) covers every convolution and dense kernel, each
slice scaled to variance 1 / fan_in (kernel height x width x inputs for a
convolution, so 257 x 9 for ``g``'s first, inputs for a dense layer) and
each filter's weights shifted to sum to zero; GroupNorm scales are 1 and
every bias 0.  The reference gets the same values in float32.
"""

from __future__ import annotations

import torch

from portbench.lib import seeds


def program_net(config: dict, seed: int, device):
    """``(net, weights)``: the program's ``MuZeroNet`` for ``config`` in eval
    mode with the benchmark's weights, and those weights as a dict of
    float32 tensors by parameter name."""
    from gymgo_tpu_torch.models.muzero_net import MuZeroNet, MuZeroNetConfig

    dtype = getattr(torch, config["dtype"])
    cfg = MuZeroNetConfig(board_size=config["board_size"], channels=config["channels"], blocks=config["blocks"],
                          policy_channels=config["policy_channels"], value_channels=config["value_channels"],
                          value_hidden=config["value_hidden"], dtype=dtype)
    with torch.device("meta"):
        net = MuZeroNet(cfg)
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
            # zero-mean filters, as weights.py's: a head reading relu'd inputs stays alive on every seed
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
