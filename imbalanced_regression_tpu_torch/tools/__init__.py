"""Command-line tools of the port. Each module is runnable:
``python -m imbalanced_regression_tpu_torch.tools.export_model <store dir> <out.pt2> ...``,
``python -m imbalanced_regression_tpu_torch.tools.serve_bench [--task age] ...``"""
