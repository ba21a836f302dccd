"""GroupNorm, relu and the residual add in one pass over channels-last
activations: the hand CUDA kernel (``csrc/group_norm_act.cu``) and its wrapper.

Replaces no Pallas kernel: it is the counterpart of the fusion XLA makes of the
JAX package's conv + GroupNorm + relu blocks (``gymgo_tpu/models/az_net.py``,
``ResBlock``).  The served ``AZNet`` calls it after each tower convolution on
the card (``models/az_net.py``).  Built and loaded at first use by
``gymgo_tpu_torch.ops.cuda_lib``.

``group_norm_act_plain`` is the plain PyTorch version (the library's
``group_norm``, ``relu`` and add), which the CPU and autograd take;
``group_norm_act_cuda`` launches the kernel on CUDA tensors or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gymgo_tpu_torch.ops.cuda_lib import CSRC, CudaKernelLib

__all__ = ["GROUP_NORM_ACT", "group_norm_act_cuda", "group_norm_act_plain"]

SOURCE = CSRC / "group_norm_act.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# (x, res, gamma, beta, out, dtype, batch, hw, channels, groups, eps, sms, stream)
GROUP_NORM_ACT = CudaKernelLib(SOURCE, "group_norm_act_launch",
                               (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP_CHANNELS = 512  # a block takes at least one cell of a group a pass, a thread a vector


def group_norm_act_plain(h: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(group_norm(h))``, or ``relu(residual + group_norm(h))``: the
    library's three operations, in any layout, with autograd."""
    y = F.group_norm(h, groups, weight, bias, eps)
    return F.relu(y if residual is None else residual + y)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_norm_act_cuda(h: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """``group_norm_act_plain`` from the hand kernel, in the layout it takes:
    ``h`` (and ``residual``) ``(B, C, H, W)`` channels-last (NHWC in memory)
    bfloat16 or float32 on one CUDA device, ``weight``/``bias`` ``(C,)`` of
    the same type.  Returns a new channels-last tensor; launches on the
    current stream and does not synchronise.  Statistics in float32, rounded
    where the library rounds them: equal to the plain version but for the
    order of the sums."""
    if not h.is_cuda:
        raise ValueError("group_norm_act_cuda needs a CUDA tensor")
    if h.dtype not in _DTYPES:
        raise TypeError(f"group_norm_act_cuda takes bfloat16 or float32, got {h.dtype}")
    if h.dim() != 4 or not h.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group_norm_act_cuda takes a channels-last (B, C, H, W) tensor, got {tuple(h.shape)} "
                         f"with strides {h.stride()}")
    b, c, hh, ww = h.shape
    if groups < 1 or c % groups or c // groups > _MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm_act_cuda: {c} channels in {groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.dtype != h.dtype or p.device != h.device or not p.is_contiguous():
            raise ValueError(f"group_norm_act_cuda: {name} must be a contiguous ({c},) {h.dtype} tensor on "
                             f"{h.device}, got {tuple(p.shape)} {p.dtype} on {p.device}")
    if residual is not None and (residual.shape != h.shape or residual.dtype != h.dtype or
                                 residual.device != h.device or
                                 not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("group_norm_act_cuda: the residual must be laid out as the input, of its type and device")
    out = torch.empty_like(h, memory_format=torch.channels_last)
    GROUP_NORM_ACT.launch(h.data_ptr(), None if residual is None else residual.data_ptr(), weight.data_ptr(),
                          bias.data_ptr(), out.data_ptr(), _DTYPES[h.dtype], b, hh * ww, c, groups, eps,
                          _sms(h.device.index), device=h.device)
    return out

