"""Host-side utilities: shot-partitioned evaluation metrics, config, metrics
logging, checkpoints and meters."""
