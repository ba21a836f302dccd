"""State constructors and accessors for the batched 6-channel Go state.

The representation is ``int8`` with 0/1 values, shaped ``(B, NUM_CHNLS, N, N)``.
TURN/PASS/DONE planes are uniform (whole-plane indicators), so scalar reads use
element [0, 0].
"""

from __future__ import annotations

import torch

from gymgo_tpu_torch import govars

STATE_DTYPE = torch.int8


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and no card is
    present, rather than carrying on on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gymgo_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def init_state(size: int, dtype=STATE_DTYPE, device=None) -> torch.Tensor:
    """Fresh single-game state ``(NUM_CHNLS, N, N)`` of zeros."""
    return torch.zeros(
        (govars.NUM_CHNLS, size, size), dtype=dtype, device=resolve_device(device)
    )


def batch_init_state(
    batch_size: int, board_size: int, dtype=STATE_DTYPE, device=None
) -> torch.Tensor:
    """Fresh batch of states ``(B, NUM_CHNLS, N, N)`` of zeros."""
    return torch.zeros(
        (batch_size, govars.NUM_CHNLS, board_size, board_size),
        dtype=dtype,
        device=resolve_device(device),
    )


def board_size(states) -> int:
    return states.shape[-1]


def black(states):
    return states[..., govars.BLACK, :, :].bool()


def white(states):
    return states[..., govars.WHITE, :, :].bool()


def invalid_channel(states):
    return states[..., govars.INVD_CHNL, :, :].bool()


def turn(states):
    """0 = black to move, 1 = white to move; shape = batch dims."""
    return states[..., govars.TURN_CHNL, 0, 0].to(torch.int32)


def prev_player_passed(states):
    return states[..., govars.PASS_CHNL, 0, 0].bool()


def game_ended(states):
    return states[..., govars.DONE_CHNL, 0, 0].bool()


def action_size(board_size: int) -> int:
    return board_size * board_size + 1
