"""The work a cell's operations must do, from shapes alone, and the card's
peaks that shares of a roofline divide by.

Peaks: NVIDIA's data sheet for one H100 SXM at its full 700 W, dense rates:
989 TFLOP/s in bfloat16, 3.35 TB/s of HBM.  A card set below 700 W runs
slower under load; the harness prints the card's power limit beside them.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
PLANES = 6


def aznet_flops(board_size: int, channels: int, blocks: int, policy_channels: int, value_channels: int,
                value_hidden: int) -> int:
    """Forward FLOPs of one board through the AlphaGo Zero network, 2 per
    multiply-add of its convolutions and dense layers (GroupNorm,
    activations and bias adds not counted)."""
    cells = board_size * board_size
    conv3 = 2 * cells * 9 * channels
    flops = conv3 * PLANES + 2 * blocks * conv3 * channels
    flops += 2 * cells * channels * policy_channels + 2 * cells * policy_channels * (cells + 1)
    flops += 2 * cells * channels * value_channels + 2 * cells * value_channels * value_hidden + 2 * value_hidden
    return flops


def search_evaluations(num_simulations: int) -> int:
    """Network evaluations a Gumbel search makes per root: the root, then one
    leaf per simulation."""
    return 1 + num_simulations


def env_step_bytes(board_size: int) -> int:
    """Bytes one env-step must move whatever computes it: the six int8
    planes read and written once, the int32 action read, the float32 reward
    and the bool done written."""
    return 2 * PLANES * board_size * board_size + 4 + 4 + 1


def bundle_flood_bytes(board_size: int, batch: int) -> int:
    """Bytes of one bundle-flood launch: two uint8 stone planes in and one
    int32 word out per cell."""
    return (2 + 4) * board_size * board_size * batch
