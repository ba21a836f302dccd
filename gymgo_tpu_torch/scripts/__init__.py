"""The port's tools, each run as ``python -m gymgo_tpu_torch.scripts.<name>``
(counterparts of the JAX package's ``scripts/``): ``gtp_match``,
``elo_ladder``, ``eval_ckpt``, ``export_params``, ``net2net``,
``value_probe``, ``multiproc_worker``, ``multihost_bench``, ``scaling_proxy``
and ``fuzz_parity``.  Importing a module runs nothing."""
