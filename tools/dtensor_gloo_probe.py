"""Which DTensor operations of the tensor-parallel trunks run over gloo on
CUDA tensors, two ranks on one card.

    python tools/dtensor_gloo_probe.py [--stages fwd bwd ...] [--port 29700]

Each stage runs in a fresh pair of processes (a crash ends only its own
pair) and prints one JSON line: the stage, the exit codes and the last
lines of rank 0's output. The stages, each after the ones it needs:

* ``all_reduce``, ``all_gather``, ``scatter``: the c10d collectives on a
  CUDA tensor over the ``mdl`` group (``scatter`` as ``distribute_tensor``);
* ``fwd``: ``parallelize_module`` of a two-layer trunk of the port's
  ``ActorCritic`` (``ColwiseParallel``, ``RowwiseParallel``,
  ``src_data_rank=None``) and its forward against the unsharded net;
* ``bwd``: the gradients; ``norm``: ``global_norm`` under
  ``implicit_replication`` against the unsharded gradients'; ``adam``:
  ``clip_and_adam`` on the mixed list;
* ``full_tensor``: DTensor's own gather of a sharded weight;
* ``odd_fwd``: a three-layer trunk, whose last column-parallel layer
  gathers its output (``output_layouts=Replicate()``).

On an H100 with torch 2.11+cu128 every stage ran but ``full_tensor`` and
``odd_fwd``, which crashed in DTensor's all-gather (a segmentation fault in
``wait_tensor``); the c10d ``all_gather`` ran. So ``tensor_parallel``
gathers with ``dist.all_gather`` and ``mesh.shard_params_tp`` refuses a
trunk that ends column-parallel over gloo on CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STAGES = ("all_reduce", "all_gather", "scatter", "fwd", "bwd", "norm", "adam", "full_tensor",
          "odd_fwd")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(stage: str, rank: int, port: int) -> None:
    import faulthandler
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                   parallelize_module)
    sys.path.insert(0, ROOT)
    from isaacgym_tpu_torch.rl.networks import ActorCritic
    from isaacgym_tpu_torch.rl.ppo import AdamState, clip_and_adam, global_norm
    faulthandler.enable()
    dev = "cuda"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    mesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("dp", "mdl"))
    group = mesh.get_group("mdl")
    say = lambda **kw: print(json.dumps(dict(stage=stage, rank=rank, **kw)), flush=True)
    if stage == "all_reduce":
        t = torch.ones((), device=dev)
        dist.all_reduce(t, group=group)
        return say(sum=float(t))
    if stage == "all_gather":
        parts = [torch.zeros(4, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=dev), group=group)
        return say(gathered=[float(p[0]) for p in parts])
    if stage == "scatter":
        t = distribute_tensor(torch.randn(8, 4, device=dev), mesh["mdl"], [Shard(0)])
        return say(local_shape=list(t.to_local().shape))
    torch.manual_seed(0)
    units = (64, 64, 64) if stage == "odd_fwd" else (64, 64)
    net = ActorCritic(80, 7, units=units, compute_dtype=torch.float32).to(dev)
    ref = ActorCritic(80, 7, units=units, compute_dtype=torch.float32).to(dev)
    ref.load_state_dict(net.state_dict())
    n = len(units)
    plan = {f"layers.{i}": ColwiseParallel() if i % 2 == 0 else RowwiseParallel()
            for i in range(n)}
    if n % 2:
        plan[f"layers.{n - 1}"] = ColwiseParallel(output_layouts=Replicate())
    for trunk in ("actor_mlp", "critic_mlp"):
        parallelize_module(getattr(net, trunk), mesh["mdl"], plan, src_data_rank=None)
    x = torch.randn(16, 80, device=dev)
    mu, ls, v = net(x)
    mu0, ls0, v0 = ref(x)
    say(step="fwd", max_abs_err=float((mu - mu0).abs().max()))
    if stage in ("fwd", "odd_fwd"):
        return
    params = list(net.parameters())
    grads = torch.autograd.grad((mu ** 2).sum() + (v ** 2).sum() + ls.sum(), params)
    gref = torch.autograd.grad((mu0 ** 2).sum() + (v0 ** 2).sum() + ls0.sum(),
                               list(ref.parameters()))
    say(step="bwd", sharded=sum(isinstance(g, DTensor) for g in grads))
    if stage == "bwd":
        return
    with implicit_replication():
        norm = global_norm(grads)
    local = norm.to_local() if isinstance(norm, DTensor) else norm
    say(step="norm", norm=float(local), unsharded=float(global_norm(gref)))
    if stage == "norm":
        return
    with implicit_replication():
        state = AdamState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])
        clip_and_adam(params, grads, state, torch.tensor(1e-3, device=dev), 1.0)
    torch.cuda.synchronize()
    say(step="adam")
    if stage == "adam":
        return
    w = net.actor_mlp.layers[0].weight
    say(step="full_tensor", shape=list(w.full_tensor().shape))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", nargs="*", default=list(STAGES), choices=STAGES)
    ap.add_argument("--port", type=int, default=29700)
    ap.add_argument("--rank-of", nargs=2, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank_of:
        rank_main(a.rank_of[0], int(a.rank_of[1]), a.port)
        return 0
    for i, stage in enumerate(a.stages):
        procs = [subprocess.Popen([sys.executable, __file__, "--port", str(a.port + i),
                                   "--rank-of", stage, str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, cwd=ROOT) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            outs.append("timeout")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        print(json.dumps({"stage": stage, "exit_codes": [p.returncode for p in procs],
                          "rank0_tail": outs[0].strip().splitlines()[-4:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
