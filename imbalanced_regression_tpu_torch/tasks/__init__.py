"""Task drivers. Each module is runnable:
``python -m imbalanced_regression_tpu_torch.tasks.age --synthetic_size 640 --fds --lds ...``,
``python -m imbalanced_regression_tpu_torch.tasks.nyud2 --synthetic_size 160 --fds --lds ...``,
``python -m imbalanced_regression_tpu_torch.tasks.stsb --data_dir <STS-B TSVs> --fds --lds ...``"""
