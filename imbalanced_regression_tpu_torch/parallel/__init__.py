"""Data parallelism over ``torch.distributed``: the mesh (``mesh.py``), the
launch of local ranks (``launch.py``) and a multi-rank dry run of every
task family (``dryrun.py``)."""
