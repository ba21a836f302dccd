"""Checkpoints, timing, rollout counters and the terminal board (counterpart
of ``gymgo_tpu.utils``: its ``checkpoint``, ``profiling``, ``metrics`` and
``render`` modules)."""
