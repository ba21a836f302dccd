"""Build, load and count the package's hand CUDA kernels.

Each kernel is a ``csrc/*.cu`` source with a plain C launcher.  It is compiled
by ``nvcc`` for ``sm_90a`` into a shared library at first use, into
``gymgo_tpu_torch/_build/`` (named by a hash of the source and of every file
it includes with quotes, so an edited source or header builds anew), and
loaded with ``ctypes``.  Nothing is compiled or loaded when this module is
imported.  Every wrapper of a kernel keeps its own
``CudaKernelLib``, and so its own launch count: a counter of
``utils.tracing``, which a CUDA graph (``utils.graphs``) adds the launches it
captured to each time it replays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from gymgo_tpu_torch.utils import tracing

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CudaKernelLib", "check_planes", "source_files"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list[Path]:
    """``source`` and every file it includes with quotes, transitively, each
    looked up beside the file that includes it, in a fixed order."""
    found, todo = [], [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for name in _QUOTED_INCLUDE.findall(path.read_text()):
            included = (path.parent / name).resolve()
            if included.is_file():
                todo.append(included)
    return sorted(found)


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


class CudaKernelLib:
    """A CUDA source built into a ctypes library on first use, with a count
    of the kernel launches made through it.

    ``argtypes`` are the C launcher's argument types: ``ctypes.c_void_p`` for
    each pointer and the stream, ``ctypes.c_int`` for each int.  The launcher
    returns a ``cudaError_t`` as an int.  ``launches`` counts the kernels run
    through ``launch``, and those a CUDA graph replays (``utils.graphs``): the
    counter ``launches.<symbol>`` of ``utils.tracing``.
    """

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.counter = f"launches.{symbol}"
        self.build_seconds = None
        self.build_log = ""  # nvcc's output: registers, shared memory, spills
        self._fn = None
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        return tracing.counters[self.counter]

    @launches.setter
    def launches(self, n: int) -> None:
        tracing.counters[self.counter] = n

    def library_path(self) -> Path:
        digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
        for path in source_files(self.source):
            digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source and
        headers exists."""
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
                fn.argtypes = self.argtypes
                self._fn = fn
            return self._fn

    def launch(self, *args, device: torch.device) -> None:
        """Call the launcher on ``device``'s current stream (appended as the
        last argument), raise on a refused launch, and count it."""
        fn = self.function()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")
        tracing.count(self.counter)


def check_planes(name: str, mover: torch.Tensor, opp: torch.Tensor, max_cells: int) -> None:
    """Raise unless ``mover``/``opp`` are contiguous ``(B, N, N)`` bool or
    uint8 planes on one CUDA device with N*N <= ``max_cells``."""
    if not (mover.is_cuda and opp.is_cuda) or mover.device != opp.device:
        raise ValueError(f"{name} needs both planes on one CUDA device")
    if mover.dtype not in (torch.bool, torch.uint8) or opp.dtype != mover.dtype:
        raise TypeError(f"{name} takes bool or uint8 planes, got {mover.dtype}, {opp.dtype}")
    if mover.dim() != 3 or mover.shape[1] != mover.shape[2] or opp.shape != mover.shape:
        raise ValueError(f"{name} takes two (B, N, N) planes, got {tuple(mover.shape)}, {tuple(opp.shape)}")
    if not (mover.is_contiguous() and opp.is_contiguous()):
        raise ValueError(f"{name} takes contiguous planes")
    n = mover.shape[-1]
    if n * n > max_cells:
        raise ValueError(f"{name} needs N*N <= {max_cells}, got N={n}")
