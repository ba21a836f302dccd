"""Timing helpers (counterpart of ``gymgo_tpu.utils.profiling``).

``force`` waits for a result by fetching a scalar checksum; ``time_fn`` times
a call with CUDA events on the card (host clock on the CPU); ``trace`` writes
a ``torch.profiler`` Chrome trace of a block (``jax.profiler.trace``'s
counterpart); ``Meter`` keeps a rolling env-steps/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["force", "time_fn", "trace", "Meter"]


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def force(tree) -> float:
    """Wait for ``tree``'s first tensor leaf by fetching its float32 sum (one
    leaf serializes on the stream that made it); 0.0 when it has none."""
    t = _first_tensor(tree)
    return 0.0 if t is None else float(t.detach().to(torch.float32).sum())


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1, device=None, **kw) -> float:
    """Best-of-``reps`` seconds of ``fn(*args, **kw)``, completion forced by
    ``force``.  On a CUDA ``device`` each call is timed by CUDA events, else by
    the host clock."""
    for _ in range(warmup):
        force(fn(*args, **kw))
    cuda = device is not None and torch.device(device).type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            force(out)
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            force(fn(*args, **kw))
            best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host's operators, and
    the card's kernels when CUDA is available) and write its Chrome trace,
    ``trace.json`` in ``log_dir`` (view it in Perfetto or chrome://tracing).
    Yields ``log_dir``; the trace is written when the block ends, also when
    it raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Meter:
    """Rolling env-steps/s meter for host-side loop logging."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def update(self, env_steps: int) -> float:
        self.steps += env_steps
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else 0.0
