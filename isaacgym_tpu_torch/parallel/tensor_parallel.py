"""Tensor parallelism of the MLP trunks over the mesh's ``mdl`` axis
(``isaacgym_tpu/parallel/mesh.py:75-101``, ``shard_params_tp``).

The JAX package places the trunks' Dense kernels alternately over ``mdl``:
even layers shard their output dimension (column-parallel), odd layers their
input dimension (row-parallel), and GSPMD inserts the collectives. Here
``mesh.shard_params_tp`` does the same with ``torch.distributed.tensor``:
``parallelize_module`` with ``ColwiseParallel`` and ``RowwiseParallel`` over
the ``mdl`` sub-mesh turns the trunk weights into ``DTensor`` shards, and
DTensor inserts the collectives (an ``all_reduce`` after each row-parallel
layer forward, one after each column-parallel layer's input gradient
backward). The flagship's six trunk layers end on a row-parallel layer, so
the heads see a replicated trunk output.

The sharded PPO epoch is :class:`TensorParallelPPOTrainer`: the data-parallel
trainer over the mesh's ``dp`` group (its draws, slices and reductions keyed
by the ``dp`` index, so the ranks of one ``dp`` index step the same envs and
draw the same actions and permutations). Its update runs under DTensor's
``implicit_replication``, so the clip's global norm
(``rl/ppo.py`` ``global_norm``) is the norm of the whole logical parameters
and the Adam step takes the sharded and the replicated parameters in one
list; the Adam state is built from the shards (:func:`shard_train_state`).

    torchrun --nproc_per_node=2 -m isaacgym_tpu_torch.parallel.tensor_parallel \\
        task=HumanoidPingpongTiltNoEarlyStopG1 num_envs=4096 model_parallel=2 \\
        epochs=1 backend=gloo out=runs/tp [compute_dtype=float32] [key=value ...]

Each rank writes ``result_rank<r>.json`` (its seconds per epoch, metrics,
kernel launches, the first minibatch's clip norm and the placements after
the update) and
``params_rank<r>.npz`` (the gathered logical parameters after the run and
the first minibatch's reduced gradients, by parameter name).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from isaacgym_tpu_torch.parallel.data_parallel import DataParallelPPOTrainer, shard_draws
from isaacgym_tpu_torch.rl.ppo import AdamState, PPOTrainState, global_norm


def placements(net: nn.Module) -> Dict[str, tuple]:
    """Every parameter's placement over ``mdl`` by its name: ``("shard",
    dim)`` (dims of the torch ``(out, in)`` layout) or ``("replicate",)``."""
    out = {}
    for name, p in net.named_parameters():
        place = p.placements[0] if isinstance(p, DTensor) else None
        out[name] = ("shard", place.dim) if place is not None and place.is_shard() \
            else ("replicate",)
    return out


def _full(t: torch.Tensor) -> torch.Tensor:
    """The logical value of a parameter or gradient: a sharded ``DTensor``'s
    shards gathered with ``dist.all_gather`` (DTensor's own ``full_tensor``
    crashes over gloo on CUDA tensors, torch 2.11), anything else as it is."""
    if not isinstance(t, DTensor):
        return t.detach().clone()
    local, place = t.to_local().detach().contiguous(), t.placements[0]
    if not place.is_shard():
        return local.clone()
    parts = [torch.empty_like(local) for _ in range(t.device_mesh.size())]
    dist.all_gather(parts, local, group=t.device_mesh.get_group())
    return torch.cat(parts, dim=place.dim)


def gather_full(net: nn.Module, tensors: List[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The logical (unsharded) value of each of ``net``'s parameters, or of
    ``tensors`` laid out as ``net.parameters()`` (their gradients), by name,
    on every rank."""
    named = list(net.named_parameters())
    tensors = [p for _, p in named] if tensors is None else list(tensors)
    return {name: _full(t) for (name, _), t in zip(named, tensors)}


def shard_train_state(ts: PPOTrainState, mesh) -> PPOTrainState:
    """``ts`` with its trunks placed over ``mesh`` (``mesh.shard_params_tp``)
    and a fresh Adam state built from the shards, as the JAX package's
    ``_sharded_trainer`` re-inits the optimizer after ``shard_params_tp``."""
    from isaacgym_tpu_torch.parallel.mesh import shard_params_tp
    net = shard_params_tp(ts.params, mesh)
    params = list(net.parameters())
    return ts._replace(params=net, opt_state=AdamState(
        0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]))


class TensorParallelPPOTrainer(DataParallelPPOTrainer):
    """The PPO epoch with the trunks sharded over ``mesh``'s ``mdl`` axis and
    the env batch over its ``dp`` axis (``mesh.device_mesh``): the
    data-parallel trainer over this rank's ``dp`` group (the ranks of its
    ``mdl`` index). ``env`` holds this ``dp`` index's B / dp envs (made
    with ``shard_draws(env, dp_index, dp)``)."""

    def __init__(self, env, cfg, seed: int = 42, mesh=None, **kw):
        super().__init__(env, cfg, seed=seed, group=mesh.get_group("dp"), **kw)
        self.mesh = mesh
        self.mdl_rank = mesh.get_local_rank("mdl")
        self.mdl_size = mesh["mdl"].size()

    def init_state(self) -> PPOTrainState:
        return shard_train_state(super().init_state(), self.mesh)

    def _update(self, ts, batch, obs_stats):
        with implicit_replication():
            return super()._update(ts, batch, obs_stats)

    def _reduce_grads(self, grads, aux):
        """The data-parallel sum over ``dp`` of each rank's local shards."""
        local, aux = super()._reduce_grads(
            [g.to_local() if isinstance(g, DTensor) else g for g in grads], aux)
        return [DTensor.from_local(l, g.device_mesh, g.placements, run_check=False)
                if isinstance(g, DTensor) else l for l, g in zip(local, grads)], aux


def main(argv, run_root: str = "runs"):
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.parallel.mesh import device_mesh, init_distributed
    from isaacgym_tpu_torch.rl.ppo import PPOConfig
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config

    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    own = ("task", "epochs", "backend", "out", "model_parallel", "compute_dtype")
    task = kv.get("task", "HumanoidPingpongTiltNoEarlyStopG1")
    cfg = compose(task, [a for a in argv if "=" in a and a.split("=", 1)[0] not in own])
    preprocess_train_config(cfg)
    device = str(cfg["device"])
    rank, size, _ = init_distributed(kv.get("backend", "nccl" if device == "cuda" else "gloo"),
                                     device)
    torch.set_num_threads(max(1, torch.get_num_threads() // size))
    mesh = device_mesh(int(kv.get("model_parallel", 2)), device_type=device)
    dp_index, dp = mesh.get_local_rank("dp"), mesh["dp"].size()
    B = int(cfg["task"]["env"]["numEnvs"])
    if B % dp:
        raise ValueError(f"num_envs={B} not divisible by dp={dp}")
    seed = int(cfg["seed"])
    env = shard_draws(make(seed=seed, task=task, num_envs=B // dp, device=device,
                           cfg=cfg["task"]), dp_index, dp)
    dtype = getattr(torch, kv.get("compute_dtype", "bfloat16"))
    trainer = TensorParallelPPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=seed,
                                       mesh=mesh, compute_dtype=dtype)
    ts = trainer.init_state()
    first, norms = {}, []
    reduce_grads = trainer._reduce_grads

    def record(grads, aux):
        grads, aux = reduce_grads(grads, aux)
        if not first:
            first.update(gather_full(ts.params, grads))
            norms.append(global_norm(grads))   # the clip's norm
        return grads, aux
    trainer._reduce_grads = record
    env_state, obs = env.reset()
    out = kv.get("out") or os.path.join(run_root, cfg["experiment"] or "tp")
    os.makedirs(out, exist_ok=True)
    seconds, launches, metrics = [], [], {}
    for _ in range(int(kv.get("epochs", 1))):
        before = env.sim.kernel_launches()
        t0 = time.perf_counter()
        ts, env_state, obs, m = trainer.train_epoch(ts, env_state, obs)
        metrics = {k: float(v) for k, v in m.items()}   # waits for the epoch
        seconds.append(time.perf_counter() - t0)
        launches.append({k: v - before[k] for k, v in env.sim.kernel_launches().items()})
    full = gather_full(ts.params)
    np.savez(os.path.join(out, f"params_rank{rank}.npz"),
             **{f"param.{k}": v.float().cpu().numpy() for k, v in full.items()},
             **{f"grad0.{k}": v.float().cpu().numpy() for k, v in first.items()})
    place = placements(ts.params)
    local = {n: list(p.to_local().shape if isinstance(p, DTensor) else p.shape)
             for n, p in ts.params.named_parameters()}
    result = dict(rank=rank, world_size=size, dp_index=dp_index, dp=dp,
                  mdl_index=trainer.mdl_rank, mdl=trainer.mdl_size, envs_per_rank=B // dp,
                  device=device, compute_dtype=str(dtype), seconds_per_epoch=seconds,
                  kernel_launches_per_epoch=launches, metrics=metrics,
                  first_grad_norm=float(norms[0].to_local() if isinstance(norms[0], DTensor)
                                         else norms[0]),
                  placements={n: list(v) for n, v in place.items()}, local_shapes=local)
    with open(os.path.join(out, f"result_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
