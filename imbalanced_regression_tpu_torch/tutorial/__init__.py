"""The DIR tutorial of the port: ``tutorial.py``, a percent-format (``# %%``)
script, run as ``python -m imbalanced_regression_tpu_torch.tutorial.tutorial
[--device cuda|cpu]`` or rendered into ``tutorial.ipynb`` by
``python -m imbalanced_regression_tpu_torch.tools.make_notebook``."""
