"""Checkpoints and timing (counterpart of ``gymgo_tpu.utils``, its
``checkpoint`` and ``profiling`` modules)."""
