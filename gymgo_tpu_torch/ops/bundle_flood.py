"""The bundle flood's hand CUDA kernel (``csrc/bundle_flood.cu``) and its wrapper.

Replaces ``gymgo_tpu/ops/pallas_flood.py:_bundle_kernel`` (``bundle_flood_pallas``).
Built and loaded at first use by ``gymgo_tpu_torch.ops.cuda_lib``.

``bundle_flood`` takes the plain PyTorch version
(``gymgo_tpu_torch.core.flood.bundle_flood_plain``) only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.  It raises too
while ``GYMGO_BITPACK_FIXED_ONLY`` truncates the plain flood: the kernel has no
substeps to truncate, and its converged word would not be what was asked for.
"""

from __future__ import annotations

import ctypes

import torch

from gymgo_tpu_torch.core import flood as _flood
from gymgo_tpu_torch.core.flood import MAX_BUNDLE_CELLS, bundle_flood_plain
from gymgo_tpu_torch.ops.cuda_lib import CSRC, CudaKernelLib, check_planes

__all__ = ["BUNDLE_FLOOD", "bundle_flood", "bundle_flood_cuda"]

SOURCE = CSRC / "bundle_flood.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# (mover, opp, out, batch, n, stream)
BUNDLE_FLOOD = CudaKernelLib(SOURCE, "bundle_flood_launch", (_P, _P, _P, _I, _I, _P))


def bundle_flood_cuda(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Converged bundle word, int32 ``(B, N, N)``, from the hand kernel.

    ``mover``/``opp`` are contiguous ``(B, N, N)`` bool or uint8 CUDA tensors
    on one device.  Launches on the current stream and does not synchronise.
    """
    check_planes("bundle_flood_cuda", mover, opp, MAX_BUNDLE_CELLS)
    b, n, _ = mover.shape
    out = torch.empty((b, n, n), dtype=torch.int32, device=mover.device)
    BUNDLE_FLOOD.launch(mover.data_ptr(), opp.data_ptr(), out.data_ptr(), b, n, device=mover.device)
    return out


def bundle_flood(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Bundle word of two stone planes: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if mover.is_cuda:
        if _flood.fixed_only_prefix is not None:
            raise ValueError(
                "GYMGO_BITPACK_FIXED_ONLY truncates the plain bundle flood to a fixed prefix of "
                "substeps; the CUDA kernel labels components and has no substeps to truncate: "
                "unset it (core.flood.set_bitpack_fixed_only(None)) to flood CUDA tensors")
        return bundle_flood_cuda(mover, opp)
    return bundle_flood_plain(mover, opp)
