"""gymgo_tpu_torch: the batched Go environment of ``gymgo_tpu`` in PyTorch, for
an NVIDIA H100.

The same 6-channel int8 state ``(B, 6, N, N)`` is stepped in lockstep for
thousands of games; the flood that classifies groups and claims areas every
step runs hand CUDA kernels: the bundle flood (``csrc/bundle_flood.cu``) on the
default route, the min/max liberty flood (``csrc/minmax_flood.cu``) on the
minmax route (``GYMGO_FLOOD``, as in the JAX package).  On top of the env:
the AZNet (``models``) with a loader of the JAX package's checkpoints
(``convert``), search, match play, self-play, replay and the learner
(``rl``), and the training loop (``train``, ``python -m
gymgo_tpu_torch.train``).  The host surface: the numpy ``gogame``, the
single-env ``env.GoEnv`` (the C++ engine of ``native`` or the port's step on a
device), registered with gymnasium as ``go-torch-v0`` and
``go-extrahard-torch-v0``, and the rollout counters of ``utils.metrics``.
The front ends: the GTP engine (``utils.gtp``), SGF (``utils.sgf``), the
pyglet window, checked stepping (``core.debug``), the tools of ``scripts``
(``python -m gymgo_tpu_torch.scripts.<name>``) and ``demo``.
Entry points run on ``cuda`` unless the caller passes another device, and
raise when there is no card.  This package imports nothing of JAX or of
``gymgo_tpu``.
"""

from gymgo_tpu_torch import govars
from gymgo_tpu_torch.config import HEURISTIC, REAL, EnvConfig

__version__ = "0.1.0"


def _register_gym_envs():
    """Register the port's envs with gymnasium under ids of their own, beside
    the JAX package's ``go-v0`` / ``go-extrahard-v0`` (one registry serves
    both packages in a process)."""
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:  # pragma: no cover - gymnasium is optional
        return
    if "go-torch-v0" not in registry:
        register(id="go-torch-v0", entry_point="gymgo_tpu_torch.env:GoEnv")
    if "go-extrahard-torch-v0" not in registry:
        register(id="go-extrahard-torch-v0", entry_point="gymgo_tpu_torch.env:GoExtraHardEnv")


_register_gym_envs()
