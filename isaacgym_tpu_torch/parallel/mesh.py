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

:func:`device_mesh` is the JAX ``make_mesh``'s ``(dp, mdl)`` mesh as a
``torch.distributed`` ``DeviceMesh``, and :func:`shard_params_tp` the
tensor-parallel placement of the MLP trunks over its ``mdl`` axis with
``torch.distributed.tensor.parallel`` (``parallel/tensor_parallel.py`` has
the sharded epoch).
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


def device_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """The 2-D ``DeviceMesh`` of shape :func:`make_mesh` over the process
    group's ranks, ``mesh_dim_names=("dp", "mdl")``: rank ``d * mdl + m`` is
    ``dp`` index ``d``, ``mdl`` index ``m`` (the JAX mesh's row-major
    layout)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = make_mesh(model_parallel=model_parallel)
    return init_device_mesh(device_type, (shape["dp"], shape["mdl"]),
                            mesh_dim_names=("dp", "mdl"))


def shard_params_tp(net, mesh, layers=("actor_mlp", "critic_mlp")):
    """Tensor-parallel placement of the MLP trunks over ``mesh``'s ``mdl``
    axis (``isaacgym_tpu/parallel/mesh.py:75-101``): in each trunk the even
    layers shard their output dimension (``ColwiseParallel``), the odd ones
    their input dimension (``RowwiseParallel``); a trunk that ends on a
    column-parallel layer gathers its output. The heads and everything else
    stay replicated plain tensors. The JAX kernels are ``(in, out)``, the
    torch weights ``(out, in)``: the column-parallel weight is cut along dim
    0, the row-parallel along dim 1. Each rank cuts its shard from its own
    copy (``src_data_rank=None``): the ranks hold equal copies, seeded alike.
    With ``mdl == 1`` every parameter is replicated (:func:`replicate_tree`).
    Changes ``net`` in place and returns it; build the optimizer state from
    its parameters afterwards.

    DTensor's all-gather crashes over gloo on CUDA tensors (torch 2.11), so
    there a trunk that ends column-parallel is refused."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                   parallelize_module)
    mdl = mesh["mdl"]
    if mdl.size() == 1:
        replicate_tree(list(net.parameters()))
        return net
    for name in layers:
        mlp = getattr(net, name, None)
        if mlp is None:
            continue
        n = len(mlp.layers)
        if n % 2 and mesh.device_type == "cuda" and dist.get_backend(mdl.get_group()) == "gloo":
            raise ValueError(f"{name} ends on a column-parallel layer ({n} layers), whose "
                             "output gather DTensor cannot run over gloo on CUDA")
        plan = {f"layers.{i}": ColwiseParallel() if i % 2 == 0 else RowwiseParallel()
                for i in range(n)}
        if n % 2:
            plan[f"layers.{n - 1}"] = ColwiseParallel(output_layouts=Replicate())
        parallelize_module(mlp, mdl, plan, src_data_rank=None)
    return net


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
            dist.broadcast(x.data, src)
        return x
    return _tree_map(bcast, tree)
