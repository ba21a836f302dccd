"""The min/max liberty flood's hand CUDA kernel (``csrc/minmax_flood.cu``) and
its wrapper.

Replaces ``gymgo_tpu/ops/pallas_flood.py:_kernel`` (``minmax_liberty_flood_pallas``).
Built and loaded at first use by ``gymgo_tpu_torch.ops.cuda_lib``.

``minmax_flood`` takes the plain PyTorch version
(``gymgo_tpu_torch.core.flood.minmax_flood_plain``) only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from gymgo_tpu_torch.core.flood import MAX_KERNEL_BOARD, minmax_flood_plain
from gymgo_tpu_torch.ops.cuda_lib import CSRC, CudaKernelLib, check_planes

__all__ = ["MINMAX_FLOOD", "MAX_MINMAX_CELLS", "minmax_flood", "minmax_flood_cuda"]

SOURCE = CSRC / "minmax_flood.cu"
# One warp a board up to 32x32, one block a board up to 181x181: the largest
# board whose indices and N*N the int16 output holds.
MAX_MINMAX_CELLS = MAX_KERNEL_BOARD * MAX_KERNEL_BOARD
_P, _I = ctypes.c_void_p, ctypes.c_int
# (mover, opp, mn, mx, batch, n, stream)
MINMAX_FLOOD = CudaKernelLib(SOURCE, "minmax_flood_launch", (_P, _P, _P, _P, _I, _I, _P))


def minmax_flood_cuda(mover: torch.Tensor, opp: torch.Tensor):
    """``(mn, mx)``, int16 ``(B, N, N)`` each, from the hand kernel.

    ``mover``/``opp`` are contiguous ``(B, N, N)`` bool or uint8 CUDA tensors
    on one device, N <= 181.  Launches on the current stream and does not
    synchronise.
    """
    check_planes("minmax_flood_cuda", mover, opp, MAX_MINMAX_CELLS)
    b, n, _ = mover.shape
    mn = torch.empty((b, n, n), dtype=torch.int16, device=mover.device)
    mx = torch.empty_like(mn)
    MINMAX_FLOOD.launch(mover.data_ptr(), opp.data_ptr(), mn.data_ptr(), mx.data_ptr(), b, n,
                        device=mover.device)
    return mn, mx


def minmax_flood(mover: torch.Tensor, opp: torch.Tensor):
    """``(mn, mx)`` of two stone planes: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if mover.is_cuda:
        return minmax_flood_cuda(mover, opp)
    return minmax_flood_plain(mover, opp)
