"""gymgo_tpu_torch: the batched Go environment of ``gymgo_tpu`` in PyTorch, for
an NVIDIA H100.

The same 6-channel int8 state ``(B, 6, N, N)`` is stepped in lockstep for
thousands of games; the flood that classifies groups and claims areas every
step runs hand CUDA kernels: the bundle flood (``csrc/bundle_flood.cu``) on
boards up to 22x22, the min/max liberty flood (``csrc/minmax_flood.cu``) and the
claim flood (``csrc/claim_flood.cu``) on larger ones (``core.flood``).  On top
of the env: the AZNet (``models``) with a loader of the JAX package's
checkpoints (``convert``), search, match play, self-play, replay and the learner
(``rl``), and the training loop (``train``, ``python -m
gymgo_tpu_torch.train``).  The host surface: the numpy ``gogame``, the
single-env ``env.GoEnv`` (the C++ engine of ``native`` or the port's step on a
device), registered with gymnasium as ``go-torch-v0`` and
``go-extrahard-torch-v0``, and the rollout counters of ``utils.metrics``.
The front ends: the GTP engine (``utils.gtp``), SGF (``utils.sgf``), the
pyglet window, checked stepping (``core.debug``), the tools of ``scripts``
(``python -m gymgo_tpu_torch.scripts.<name>``) and ``demo``.  The parallel
layer: meshes of devices over ``torch.distributed`` ranks and the env-sharded
``ShardedGoEnv`` (``parallel``), and the data-parallel learner step.
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
