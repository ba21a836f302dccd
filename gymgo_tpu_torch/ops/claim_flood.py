"""The claim flood's hand CUDA kernel (``csrc/claim_flood.cu``) and its wrapper.

Replaces no Pallas kernel: it is the counterpart of the JAX package's XLA
``lax.while_loop`` ``gymgo_tpu/core/flood.py:flood_or_unrolled`` on the
two-bit touch word of the minmax route and the area score.  Built and loaded
at first use by ``gymgo_tpu_torch.ops.cuda_lib``.

``claim_flood`` takes the plain PyTorch version
(``gymgo_tpu_torch.core.flood.claim_flood_plain``) only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from gymgo_tpu_torch.core.flood import MAX_KERNEL_BOARD, claim_flood_plain
from gymgo_tpu_torch.ops.cuda_lib import CSRC, CudaKernelLib, check_planes

__all__ = ["CLAIM_FLOOD", "MAX_CLAIM_CELLS", "claim_flood", "claim_flood_cuda"]

SOURCE = CSRC / "claim_flood.cu"
# One warp a board up to 32x32, one block a board up to 181x181, the min/max
# flood's largest board (the minmax route's).
MAX_CLAIM_CELLS = MAX_KERNEL_BOARD * MAX_KERNEL_BOARD
_P, _I = ctypes.c_void_p, ctypes.c_int
# (mover, opp, out, batch, n, stream)
CLAIM_FLOOD = CudaKernelLib(SOURCE, "claim_flood_launch", (_P, _P, _P, _I, _I, _P))


def claim_flood_cuda(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """uint8 ``(B, N, N)`` from the hand kernel: on each empty cell, bit 0 if
    its empty region touches ``mover``, bit 1 if it touches ``opp``; 0 on
    stones.

    ``mover``/``opp`` are contiguous ``(B, N, N)`` bool or uint8 CUDA tensors
    on one device, N <= 181.  Launches on the current stream and does not
    synchronise.
    """
    check_planes("claim_flood_cuda", mover, opp, MAX_CLAIM_CELLS)
    b, n, _ = mover.shape
    out = torch.empty((b, n, n), dtype=torch.uint8, device=mover.device)
    CLAIM_FLOOD.launch(mover.data_ptr(), opp.data_ptr(), out.data_ptr(), b, n, device=mover.device)
    return out


def claim_flood(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """The claim word of two stone planes: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if mover.is_cuda:
        return claim_flood_cuda(mover, opp)
    return claim_flood_plain(mover, opp)
