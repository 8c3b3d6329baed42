"""Multi-process training (``isaacgym_tpu/parallel``): ``mesh.py`` sets up
``torch.distributed`` and places env batches by rank, ``data_parallel.py``
is the data-parallel PPO epoch."""
