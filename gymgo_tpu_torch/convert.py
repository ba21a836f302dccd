"""Carry state across between numpy (and so the JAX package) and this port.

States are int8 ``(B, 6, N, N)`` in both packages, with the same channels, so
they convert by a copy.  A ``PlanesState`` converts field by field, its carried
``atari`` (int16) and ``ko_surr`` (bool) planes included.
"""

from __future__ import annotations

import numpy as np
import torch

from gymgo_tpu_torch.core.step import PlanesState

__all__ = ["states_to_torch", "states_to_numpy", "planes_to_torch", "planes_to_numpy"]

_PLANE_DTYPES = {
    "black": torch.bool,
    "white": torch.bool,
    "invd": torch.bool,
    "white_to_move": torch.bool,
    "prev_passed": torch.bool,
    "done": torch.bool,
    "atari": torch.int16,
    "ko_surr": torch.bool,
}


def states_to_torch(states, device) -> torch.Tensor:
    """int8 ``(B, 6, N, N)`` array-like -> int8 tensor on ``device``."""
    arr = np.asarray(states)
    if arr.ndim != 4 or arr.shape[1] != 6 or arr.shape[2] != arr.shape[3]:
        raise ValueError(f"states must be (B, 6, N, N), got {arr.shape}")
    return torch.from_numpy(arr.astype(np.int8, copy=True)).to(device)


def states_to_numpy(states: torch.Tensor) -> np.ndarray:
    return states.detach().to("cpu", torch.int8).numpy()


def planes_to_torch(ps, device) -> PlanesState:
    """Any PlanesState-like tuple with the same field names (numpy or JAX
    arrays) -> the port's ``PlanesState`` on ``device``."""
    fields = {}
    for name, dtype in _PLANE_DTYPES.items():
        v = getattr(ps, name, None)
        fields[name] = None if v is None else torch.from_numpy(np.array(v)).to(device, dtype)
    return PlanesState(**fields)


def planes_to_numpy(ps: PlanesState) -> dict:
    """The port's ``PlanesState`` -> a dict of numpy arrays (None kept)."""
    return {
        name: None if getattr(ps, name) is None else getattr(ps, name).detach().cpu().numpy()
        for name in PlanesState._fields
    }
