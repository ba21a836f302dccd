"""Checkpoints, timing, rollout counters, the terminal board and the front
ends (counterpart of ``gymgo_tpu.utils``: its ``checkpoint``, ``profiling``,
``metrics``, ``render``, ``sgf``, ``gtp``, ``faulttol``, ``gui_math`` and
``gui`` modules), and ``graphs``, the compiled forms (``jax.jit``'s
counterpart)."""
