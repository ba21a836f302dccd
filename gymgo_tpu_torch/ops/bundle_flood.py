"""The bundle flood's hand CUDA kernel (``csrc/bundle_flood.cu``) and its wrapper.

Replaces ``gymgo_tpu/ops/pallas_flood.py:_bundle_kernel`` (``bundle_flood_pallas``).
The kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, into ``gymgo_tpu_torch/_build/`` (named by a
hash of the source, so an edited source builds anew), and loaded with
``ctypes``.  Nothing is compiled or loaded when this module is imported.

``bundle_flood`` takes the plain PyTorch version
(``gymgo_tpu_torch.core.flood.bundle_flood_plain``) only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from gymgo_tpu_torch.core.flood import MAX_BUNDLE_CELLS, bundle_flood_plain

__all__ = ["BUNDLE_FLOOD", "bundle_flood", "bundle_flood_cuda", "build"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bundle_flood.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


class CudaKernelLib:
    """A CUDA source built into a ctypes library on first use, with a count
    of the kernel launches made through it."""

    def __init__(self, source: Path, symbol: str):
        self.source = source
        self.symbol = symbol
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""  # nvcc's output: registers, shared memory, spills
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source.name}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        self.build_log = proc.stdout + proc.stderr
        os.replace(tmp, lib)
        return lib

    def function(self):
        """The loaded C entry point; builds the library on the first call."""
        with self._lock:
            if self._fn is None:
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(self.build()))
                self.build_seconds = time.perf_counter() - t0
                fn = getattr(lib, self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ]
                self._fn = fn
            return self._fn


BUNDLE_FLOOD = CudaKernelLib(SOURCE, "bundle_flood_launch")


def build() -> float:
    """Build and load the kernel library now; returns the seconds it took."""
    BUNDLE_FLOOD.function()
    return BUNDLE_FLOOD.build_seconds


def bundle_flood_cuda(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Converged bundle word, int32 ``(B, N, N)``, from the hand kernel.

    ``mover``/``opp`` are contiguous ``(B, N, N)`` bool or uint8 CUDA tensors
    on one device.  Launches on the current stream and does not synchronise.
    """
    if not (mover.is_cuda and opp.is_cuda) or mover.device != opp.device:
        raise ValueError("bundle_flood_cuda needs both planes on one CUDA device")
    if mover.dtype not in (torch.bool, torch.uint8) or opp.dtype != mover.dtype:
        raise TypeError(f"bundle_flood_cuda takes bool or uint8 planes, got {mover.dtype}, {opp.dtype}")
    if mover.dim() != 3 or mover.shape[1] != mover.shape[2] or opp.shape != mover.shape:
        raise ValueError(f"bundle_flood_cuda takes two (B, N, N) planes, got {tuple(mover.shape)}, {tuple(opp.shape)}")
    if not (mover.is_contiguous() and opp.is_contiguous()):
        raise ValueError("bundle_flood_cuda takes contiguous planes")
    b, n, _ = mover.shape
    if n * n > MAX_BUNDLE_CELLS:
        raise ValueError(f"bundle flood needs N*N <= {MAX_BUNDLE_CELLS}, got N={n}")
    fn = BUNDLE_FLOOD.function()
    out = torch.empty((b, n, n), dtype=torch.int32, device=mover.device)
    with torch.cuda.device(mover.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(mover.data_ptr(), opp.data_ptr(), out.data_ptr(), b, n, stream)
    if err != 0:
        raise RuntimeError(f"bundle_flood kernel launch failed: CUDA error {err}")
    BUNDLE_FLOOD.launches += 1
    return out


def bundle_flood(mover: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Bundle word of two stone planes: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if mover.is_cuda:
        return bundle_flood_cuda(mover, opp)
    return bundle_flood_plain(mover, opp)
