"""Build and load the native C++ host engine through ctypes (counterpart of
``gymgo_tpu.native``, over its own copy of ``go_engine.cc``).

The shared library is compiled with ``g++ -O3`` at first use, never at
import, into ``gymgo_tpu_torch/_build/``.  Its name hashes the source, the
compiler flags and the host's CPU model (the build targets ``-march=native``),
so an edited source builds anew and a library built on another machine is not
loaded.  Each build writes a file of its own and renames it into place, so
processes that build at once never load a half-written library.  See
``go_engine.cc`` for the semantics; ``tests/test_torch_native.py`` holds it
against the JAX package's engine and the port's ``gogame``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["NativeGoEngine", "NativeUnavailable", "load", "library_path", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "go_engine.cc"
BUILD_DIR = SOURCE.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return platform.processor()


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU lies."""
    digest = hashlib.sha256(repr(_FLAGS).encode() + _cpu_model().encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgo_engine_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    base = ["g++", *_FLAGS, "-o", str(tmp), str(SOURCE)]
    last = None
    # OpenMP enables the batch-parallel path; build serial if the toolchain lacks it.
    for cmd in (base + ["-fopenmp"], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            last = e
            continue
        os.replace(tmp, lib)
        return lib
    detail = getattr(last, "stderr", str(last))
    raise NativeUnavailable(f"native engine build failed: {detail}") from last


def load():
    """The loaded ctypes library (one per process), built if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            i8p = ctypes.POINTER(ctypes.c_int8)
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.gogo_next_state.argtypes = [i8p, ctypes.c_int, ctypes.c_int, i8p]
            lib.gogo_next_state.restype = ctypes.c_int
            lib.gogo_areas.argtypes = [i8p, ctypes.c_int, i32p, i32p]
            lib.gogo_areas.restype = ctypes.c_int
            lib.gogo_batch_next_states.argtypes = [i8p, ctypes.c_int, ctypes.c_int, i32p, i8p, i32p]
            lib.gogo_batch_next_states.restype = ctypes.c_int
            lib.gogo_batch_areas.argtypes = [i8p, ctypes.c_int, ctypes.c_int, i32p, i32p]
            lib.gogo_batch_areas.restype = ctypes.c_int
            lib.gogo_max_threads.argtypes = []
            lib.gogo_max_threads.restype = ctypes.c_int
            lib.gogo_set_threads.argtypes = [ctypes.c_int]
            lib.gogo_set_threads.restype = None
            threads = os.environ.get("GYMGO_NATIVE_THREADS")
            if threads:
                lib.gogo_set_threads(int(threads))
            _LIB = lib
    return _LIB


def _as_i8(state) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(state), dtype=np.int8)


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class NativeGoEngine:
    """Single and batch Go stepping on the host in microseconds.

    States are ``(6, N, N)`` or ``(B, 6, N, N)`` numpy arrays of 0/1 values,
    N <= 32.
    """

    def __init__(self, board_size: int):
        if board_size > 32:
            raise ValueError("native engine supports N <= 32")
        self.n = board_size
        self._lib = load()

    def next_state(self, state, action: int):
        """(new_state int8 (6, N, N), status): status 0 ok, 1 invalid move,
        2 game already over (the state is returned unchanged then)."""
        s = _as_i8(state)
        out = np.empty_like(s)
        status = self._lib.gogo_next_state(_i8p(s), self.n, int(action), _i8p(out))
        if status != 0:
            return s, status
        return out, 0

    def batch_next_states(self, states, actions):
        """(new states int8 (B, 6, N, N), status int32 (B,)), with the
        status codes of ``next_state``."""
        s = _as_i8(states)
        b = s.shape[0]
        acts = np.ascontiguousarray(np.asarray(actions), dtype=np.int32)
        out = np.empty_like(s)
        status = np.empty((b,), dtype=np.int32)
        rc = self._lib.gogo_batch_next_states(_i8p(s), b, self.n, _i32p(acts), _i8p(out), _i32p(status))
        if rc != 0:
            raise RuntimeError(f"gogo_batch_next_states returned {rc}")
        return out, status

    def areas(self, state):
        """Trump-Taylor (black_area, white_area) of one state, as ints."""
        s = _as_i8(state)
        ba, wa = ctypes.c_int(), ctypes.c_int()
        self._lib.gogo_areas(_i8p(s), self.n, ctypes.byref(ba), ctypes.byref(wa))
        return ba.value, wa.value

    def batch_areas(self, states):
        """Trump-Taylor areas of a (B, 6, N, N) batch: two int32 (B,)."""
        s = _as_i8(states)
        b = s.shape[0]
        ba = np.empty((b,), dtype=np.int32)
        wa = np.empty((b,), dtype=np.int32)
        rc = self._lib.gogo_batch_areas(_i8p(s), b, self.n, _i32p(ba), _i32p(wa))
        if rc != 0:
            raise RuntimeError(f"gogo_batch_areas returned {rc}")
        return ba, wa

    @staticmethod
    def max_threads() -> int:
        """OpenMP worker count of the batch paths (1 = serial build).

        Set with GYMGO_NATIVE_THREADS or OMP_NUM_THREADS."""
        return int(load().gogo_max_threads())
