"""Task drivers. Each module is runnable:
``python -m imbalanced_regression_tpu_torch.tasks.age --synthetic_size 640 --fds --lds ...``"""
