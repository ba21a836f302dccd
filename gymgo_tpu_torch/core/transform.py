"""State transforms: canonical form and the 8 dihedral board symmetries
(counterpart of ``gymgo_tpu.core.transform``).

The orientation encoding is the reference's: bit0 flips the last axis, bit1
the middle axis, bit2 turns by ``rot90`` over the board axes, applied in that
order, so augmentation pipelines compare index for index.
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch import govars

__all__ = [
    "canonical_form",
    "batch_canonical_form",
    "apply_symmetry",
    "all_symmetries",
    "random_symmetry",
]

def batch_canonical_form(states: torch.Tensor) -> torch.Tensor:
    """Make the player to move always be channel BLACK with turn 0.

    For envs where white is to move: swap the colour planes and flip the turn
    plane.  Idempotent."""
    white_to_move = states[:, govars.TURN_CHNL, 0, 0] != 0
    # slices, not an index list: a list would be copied to the device per call
    swapped = torch.cat(
        [states[:, govars.WHITE:govars.WHITE + 1], states[:, govars.BLACK:govars.BLACK + 1],
         1 - states[:, govars.TURN_CHNL:govars.TURN_CHNL + 1], states[:, govars.INVD_CHNL:]], dim=1)
    return torch.where(white_to_move[:, None, None, None], swapped, states)


def canonical_form(state: torch.Tensor) -> torch.Tensor:
    """Single-state canonical form: ``(6, N, N) -> (6, N, N)``."""
    return batch_canonical_form(state[None])[0]


def apply_symmetry(image: torch.Tensor, orientation: int) -> torch.Tensor:
    """Apply dihedral symmetry ``orientation`` in [0, 8) over the last 2 axes:
    bit0 flips axis -1, bit1 flips axis -2, bit2 turns with
    ``torch.rot90(x, 1, (-2, -1))``, composed in that order."""
    orientation = int(orientation)
    out = image
    if orientation & 1:
        out = out.flip(-1)
    if orientation & 2:
        out = out.flip(-2)
    if orientation & 4:
        out = torch.rot90(out, 1, (-2, -1))
    return out


def all_symmetries(image: torch.Tensor) -> torch.Tensor:
    """All 8 orientations, stacked on a new leading axis."""
    return torch.stack([apply_symmetry(image, i) for i in range(8)], dim=0)


def random_symmetry(generator: torch.Generator, image: torch.Tensor) -> torch.Tensor:
    """One of the 8 orientations, drawn from ``generator`` (the draw is read on
    the host: one sync)."""
    orientation = torch.randint(0, 8, (), generator=generator, device=generator.device)
    return apply_symmetry(image, int(orientation))
