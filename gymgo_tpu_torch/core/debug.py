"""Debug-mode wrappers (counterpart of ``gymgo_tpu.core.debug``): checked
stepping and NaN guards.

The production step freezes and flags bad input (an invalid action, a move in
a finished game) instead of failing.  ``checked_step`` promotes those flags to
errors raised on the host, for tests and debugging sessions; it costs one
device-to-host sync per call.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch.core import step as _step

__all__ = ["checked_step", "enable_nan_debugging"]


def checked_step(states: torch.Tensor, actions: torch.Tensor):
    """``step_states`` that raises ``RuntimeError`` on an invalid action or on
    stepping a finished game, with the JAX package's checkify messages;
    otherwise returns what ``step_states`` returns."""
    new_states, info = _step.step_states(states, actions)
    invalid, was_done = torch.stack([info.invalid_action.any(), info.was_done.any()]).tolist()
    if invalid:
        raise RuntimeError("invalid action(s) in batch")
    if was_done:
        raise RuntimeError("stepped finished game(s) in batch")
    return new_states, info


def enable_nan_debugging():
    """Turn on autograd's anomaly detection (tests and debugging only; it
    slows every backward pass): a backward pass that produces NaN raises, and
    names the forward operation that made it.  This is the nearest PyTorch
    switch to ``jax_debug_nans``; unlike it, it does not catch a NaN made in a
    forward pass that autograd does not record (``torch.no_grad``, inference,
    the search)."""
    torch.autograd.set_detect_anomaly(True)
