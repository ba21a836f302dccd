"""The work of MuZero's network and of its search's store of hidden states,
from shapes alone (2 FLOPs per multiply-add of a convolution or a dense
layer; GroupNorm, ``scale``, activations and bias adds not counted).  The
peaks are ``counts.py``'s."""

from __future__ import annotations

from portbench.lib.counts import PLANES


def tower_flops(board_size: int, inputs: int, channels: int, blocks: int) -> int:
    """One board through a tower: a 3x3 convolution of ``inputs`` planes to
    ``channels``, then ``blocks`` residual blocks of two 3x3 convolutions."""
    conv3 = 2 * board_size * board_size * 9 * channels
    return conv3 * inputs + 2 * blocks * conv3 * channels


def represent_flops(c: dict) -> int:
    """``h`` of one board: the tower over the 6 input planes."""
    return tower_flops(c["board_size"], PLANES, c["channels"], c["blocks"])


def dynamics_flops(c: dict) -> int:
    """``g`` of one board: the tower over the hidden state and the action
    plane (``channels + action_planes`` inputs; the served path's zero
    planes add no work)."""
    return tower_flops(c["board_size"], c["channels"] + c["action_planes"], c["channels"], c["blocks"])


def predict_flops(c: dict) -> int:
    """``f`` of one board: AlphaZero's policy and value heads."""
    cells = c["board_size"] ** 2
    pc, vc, vh = c["policy_channels"], c["value_channels"], c["value_hidden"]
    return (2 * cells * c["channels"] * pc + 2 * cells * pc * (cells + 1)
            + 2 * cells * c["channels"] * vc + 2 * cells * vc * vh + 2 * vh)


def search_flops(c: dict, simulations: int) -> int:
    """One root's search: ``h`` and ``f`` at the root, then ``g`` and ``f``
    a simulation."""
    return represent_flops(c) + predict_flops(c) + simulations * (dynamics_flops(c) + predict_flops(c))


def latent_bytes(c: dict, batch: int, element: int = 2) -> int:
    """Bytes a simulation's gather must move: each board's parent hidden
    state read from the store and written as ``g``'s input, ``element``
    bytes a value (the action plane is no tensor: ``g`` adds its part)."""
    return 2 * batch * c["board_size"] ** 2 * c["channels"] * element


def store_bytes(c: dict, batch: int, nodes: int, element: int = 2) -> int:
    """The tree's store of hidden states: one per node and board."""
    return nodes * batch * c["channels"] * c["board_size"] ** 2 * element
