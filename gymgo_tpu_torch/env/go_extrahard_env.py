"""The reference's empty ``GoExtraHardEnv``, registered but unimplemented
(counterpart of ``gymgo_tpu.env.go_extrahard_env``)."""

try:
    import gymnasium as _gym
    _ENV_BASE = _gym.Env
except ImportError:  # pragma: no cover - gymnasium is optional
    _ENV_BASE = object


class GoExtraHardEnv(_ENV_BASE):
    metadata = {"render.modes": ["human", "terminal"]}
