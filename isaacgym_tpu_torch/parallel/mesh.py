"""Process group and placement by rank (``isaacgym_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(dp, mdl)`` device mesh: the env
batch sharded over ``dp``, the parameters replicated. The port runs one
process per rank under ``torchrun`` (or processes started with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set): each rank holds its
slice of the env batch (:func:`shard_env_tree`) and a copy of the parameters
(:func:`replicate_tree`), and the data-parallel epoch all-reduces the
gradients and the batch statistics over ``torch.distributed``.

The backend is the caller's: ``nccl`` across cards, ``gloo`` on the CPU.
NCCL does not take two ranks on one card; ``gloo`` does, and all-reduces
CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist


def world() -> tuple:
    """``(rank, world_size, local_rank)`` from the launcher's environment
    (``(0, 1, 0)`` outside ``torchrun``)."""
    return (int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(backend: str = "nccl", device: str = "cuda",
                     timeout_s: float = 600.0) -> tuple:
    """Join the process group the environment describes (``env://``) when
    ``WORLD_SIZE > 1``, each rank on card ``LOCAL_RANK`` modulo the cards
    there are (so several ranks may share one card under gloo) when
    ``device`` is ``"cuda"``; a single process joins nothing. Returns
    ``(rank, world_size, local_rank)``."""
    rank, size, local = world()
    if size > 1 and not dist.is_initialized():
        if device == "cuda":
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return rank, size, local


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Dict[str, int]:
    """The JAX ``make_mesh``'s shape: ``{"dp": n // model_parallel, "mdl":
    model_parallel}`` over ``n_devices`` ranks (default: the world size)."""
    n = int(n_devices or (dist.get_world_size() if dist.is_initialized() else 1))
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return {"dp": n // model_parallel, "mdl": model_parallel}


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_env_tree(tree, rank: int, world_size: int):
    """Every tensor leaf with a leading env axis cut to this rank's slice:
    rows ``[rank * b, (rank + 1) * b)``, ``b = B / world_size`` (the JAX
    ``shard_env_tree``'s ``P("dp")`` placement). 0-d leaves stay whole."""
    def cut(x):
        if x.dim() == 0:
            return x
        if x.shape[0] % world_size:
            raise ValueError(f"env axis {x.shape[0]} not divisible by {world_size} ranks")
        b = x.shape[0] // world_size
        return x[rank * b:(rank + 1) * b].clone()
    return _tree_map(cut, tree)


def replicate_tree(tree, src: int = 0):
    """Every tensor leaf overwritten in place with rank ``src``'s copy (the
    JAX ``replicate_tree``'s ``P()`` placement); returns the tree."""
    def bcast(x):
        if dist.is_initialized():
            dist.broadcast(x, src)
        return x
    return _tree_map(bcast, tree)
