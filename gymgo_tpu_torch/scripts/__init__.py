"""The port's tools, each run as ``python -m gymgo_tpu_torch.scripts.<name>``
(counterparts of the JAX package's ``scripts/``): ``gtp_match``,
``elo_ladder``, ``eval_ckpt``, ``export_params``, ``net2net``,
``value_probe``, ``multiproc_worker``, ``multihost_bench``, ``scaling_proxy``,
``fuzz_parity``, ``measure_convergence``, ``search_cost_ablation`` and
``walk_depth_study``.  Importing a module runs nothing."""
