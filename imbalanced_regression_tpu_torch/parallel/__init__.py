"""Data parallelism over ``torch.distributed``: the mesh (``mesh.py``), the
launch of local ranks (``launch.py``) and a multi-rank dry run of every
task family (``dryrun.py``).

Exports the JAX ``parallel`` package's names but ``batch_sharding`` and
``replicated``: those return ``jax.sharding.NamedSharding`` objects, which
``torch.distributed`` has no counterpart of; ``shard_batch`` and
``replicate`` do their work here."""

from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh, shard_batch  # noqa: F401
