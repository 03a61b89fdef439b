"""Command-line tools of the port, each runnable as ``python -m
imbalanced_regression_tpu_torch.tools.<name>``: ``export_model`` and
``serve_bench`` (serving), ``bench`` (the flagship train step), ``sweep``
and ``aggregate_results`` (the ablation grid), ``sts_seeds`` (the STS-B
arms over seeds), and the dataset tools ``create_age_meta``,
``make_balanced_splits``, ``preprocess_nyud2``, ``corpus_embeddings`` and
``make_synth_corpus``. None imports jax or pandas."""
