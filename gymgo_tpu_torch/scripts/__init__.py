"""The port's tools, each run as ``python -m gymgo_tpu_torch.scripts.<name>``
(counterparts of the JAX package's ``scripts/``): ``gtp_match``,
``elo_ladder``, ``eval_ckpt``, ``export_params``, ``net2net`` and
``value_probe``.  Importing a module runs nothing."""
