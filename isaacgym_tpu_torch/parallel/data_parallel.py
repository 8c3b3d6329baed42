"""The data-parallel PPO epoch: W ranks, each stepping B / W envs, compute
the epoch of one process on the global batch of B envs.

What ``tests/test_multiprocess.py`` pins for the JAX package's mesh: each
rank holds its slice of the envs, the parameters are replicated, and every
draw and every reduction is over the global batch.

* Draws: every rank seeds the env and the trainer alike, draws each global
  tensor (action noise, ball launches, DR parameters and noise) from its
  generator and keeps its slice, so its envs see what the same envs of the
  one-process run see (:func:`shard_draws`).
* Reductions: the episode and event sums, the metrics' means, minima and
  maxima, the advantage normalization and both normalizers' moments are
  all-reduced over the ranks (two passes: the mean, then the squared
  deviations from it).
* The update: every rank draws the one-process permutation of the global
  ``H x B`` samples; each takes its own rows of each minibatch, sums the loss
  terms over them divided by the global minibatch size, and the gradients
  and the loss terms (the KL among them, which the adaptive lr reads) are
  all-reduced in one flat buffer before the clip's global norm and Adam. All
  ranks apply the same reduced gradients, so their parameters stay equal.

    torchrun --nproc_per_node=2 -m isaacgym_tpu_torch.parallel.data_parallel \\
        task=HumanoidPingpongTiltNoEarlyStopG1 num_envs=4096 epochs=2 \\
        backend=gloo out=runs/ddp [device=cpu] [key=value ...]

``num_envs`` is the global batch; the other overrides are the launcher's.
Rank 0 alone writes ``metrics.jsonl``, ``config.json`` and ``ckpt_final.pt``
under ``out``; each rank writes ``result_rank<r>.json`` (its seconds and
kernel launches per epoch) and its flat parameters ``params_rank<r>.npy``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from isaacgym_tpu_torch.rl import normalizer as N
from isaacgym_tpu_torch.rl.ppo import PPOTrainer, action_noise, minibatch_permutation

#: the task methods that draw one row per env
_ENV_DRAWS = ("sample_ball_velocity", "sample_ball_start", "sample_ball_velocities")


class _ShardedRandomizer:
    """A ``DomainRandomizer`` whose draws are the global batch's slice."""

    def __init__(self, inner, rank: int, world_size: int):
        self._inner, self._rank, self._world = inner, rank, world_size

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _rows(self, x, b):
        return x[self._rank * b:(self._rank + 1) * b]

    def sample(self, generator, global_step, batch: int):
        full = self._inner.sample(generator, global_step, batch * self._world)
        return type(full)(*[self._rows(v, batch) for v in full])

    def _noise(self, generator, x, scale):
        if scale <= 0.0:
            return x
        b = x.shape[0]
        full = torch.randn((b * self._world,) + tuple(x.shape[1:]), generator=generator,
                           device=x.device)
        return x + self._rows(full, b) * scale

    def observation_noise(self, generator, obs):
        return self._noise(generator, obs, self._inner.obs_noise)

    def action_noise(self, generator, actions):
        return self._noise(generator, actions, self._inner.act_noise)


def _rows(out, lo, hi):
    """Rows ``lo:hi`` of a draw, or of each draw of a tuple (C11's two balls)."""
    return tuple(x[lo:hi] for x in out) if isinstance(out, tuple) else out[lo:hi]


def shard_draws(env, rank: int, world_size: int):
    """Make ``env`` (of B / W envs, seeded as every rank's) draw the global
    batch's random numbers and keep its rows; returns ``env``."""
    for name in _ENV_DRAWS:
        fn = getattr(env, name, None)
        if fn is not None:
            setattr(env, name, lambda n, fn=fn: _rows(fn(n * world_size), rank * n,
                                                      (rank + 1) * n))
    if env.randomizer is not None:
        env.randomizer = _ShardedRandomizer(env.randomizer, rank, world_size)
    return env


class DataParallelPPOTrainer(PPOTrainer):
    """:class:`PPOTrainer` over the global batch of a process group's ranks.
    ``env`` holds this rank's B / W envs (made with :func:`shard_draws`)."""

    def __init__(self, env, cfg, seed: int = 42, group=None, **kw):
        super().__init__(env, cfg, seed=seed, **kw)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self._mb_size = None

    def init_state(self):
        ts = super().init_state()
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        for p in ts.params.parameters():   # seeded alike; the group's rank 0's copy holds
            dist.broadcast(p.data, src, group=self.group)
        return ts

    def _all_sum(self, x):
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def _action_noise(self, shape, rng):
        b = shape[0]
        full = action_noise((b * self.world_size,) + tuple(shape[1:]), rng, self.device)
        return full[self.rank * b:(self.rank + 1) * b]

    def _sum(self, x):
        return self._all_sum(x)

    def _mean(self, x):
        return self._all_sum(x.sum()) / (x.numel() * self.world_size)

    def _min(self, x):
        x = x.min().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=self.group)
        return x

    def _max(self, x):
        x = x.max().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def _moments(self, rows):
        """Global mean and population variance over the leading axis."""
        n = rows.shape[0] * self.world_size
        mean = self._all_sum(rows.sum(dim=0)) / n
        var = self._all_sum(((rows - mean) ** 2).sum(dim=0)) / n
        return mean, var, n

    def _mean_std(self, x):
        mean, var, _ = self._moments(x.reshape(-1))
        return mean, torch.sqrt(var)

    def _update_stats(self, stats, rows):
        mean, var, n = self._moments(rows)
        return N.merge_moments(stats, mean, var, n)

    def _minibatch_rows(self, T: int, rng):
        """This rank's rows of each global minibatch. Row ``t * B + e`` of
        the global batch is env ``e`` at step ``t``; this rank holds envs
        ``[rank * b, (rank + 1) * b)`` as its rows ``t * b + e - rank * b``."""
        b = self.env.num_envs
        B = b * self.world_size
        Tg = T * self.world_size
        mb = min(self.cfg.minibatch_size, Tg)
        num_mb = Tg // mb
        self._mb_size = mb
        perm = minibatch_permutation(Tg, rng, self.device)[:num_mb * mb].view(num_mb, mb)
        t, e = perm // B, perm % B
        lo = self.rank * b
        mine = (e >= lo) & (e < lo + b)
        counts = mine.sum(dim=1).tolist()
        return list(torch.split((t * b + e - lo)[mine], counts))

    def _loss_mean(self, x):
        return x.sum() / self._mb_size

    def _reduce_grads(self, grads, aux):
        keys = sorted(aux)
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([aux[k] for k in keys])])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return out, dict(zip(keys, flat[i:]))


def flat_params(ts) -> np.ndarray:
    return np.concatenate([p.detach().cpu().numpy().ravel() for p in ts.params.parameters()])


def main(argv, run_root: str = "runs"):
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.parallel.mesh import init_distributed
    from isaacgym_tpu_torch.rl import checkpoint as ckpt
    from isaacgym_tpu_torch.rl.ppo import PPOConfig
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    from isaacgym_tpu_torch.utils.logging import JsonlObserver

    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    own = ("task", "epochs", "backend", "out")
    task = kv.get("task", "HumanoidPingpongTiltNoEarlyStopG1")
    cfg = compose(task, [a for a in argv if "=" in a and a.split("=", 1)[0] not in own])
    preprocess_train_config(cfg)
    device = str(cfg["device"])
    rank, size, _ = init_distributed(kv.get("backend", "nccl" if device == "cuda" else "gloo"),
                                     device)
    torch.set_num_threads(max(1, torch.get_num_threads() // size))
    B = int(cfg["task"]["env"]["numEnvs"])
    if B % size:
        raise ValueError(f"num_envs={B} not divisible by {size} ranks")
    seed = int(cfg["seed"])
    env = shard_draws(make(seed=seed, task=task, num_envs=B // size, device=device,
                           cfg=cfg["task"]), rank, size)
    trainer = DataParallelPPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=seed)
    ts = trainer.init_state()
    env_state, obs = env.reset()
    out = kv.get("out") or os.path.join(run_root, cfg["experiment"] or "ddp")
    observer = JsonlObserver()
    if rank == 0:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        observer.after_init(out, cfg)
    seconds, launches = [], []
    for it in range(int(kv.get("epochs", 2))):
        before = env.sim.kernel_launches()
        t0 = time.perf_counter()
        ts, env_state, obs, metrics = trainer.train_epoch(ts, env_state, obs)
        scalar = {k: float(v) for k, v in metrics.items()}   # waits for the epoch
        seconds.append(time.perf_counter() - t0)
        launches.append({k: v - before[k] for k, v in env.sim.kernel_launches().items()})
        n_ep = max(scalar["episode_count"], 1e-9)
        scalar["episode_return_mean"] = scalar["episode_return_sum"] / n_ep
        scalar["episode_length_mean"] = scalar["episode_length_sum"] / n_ep
        scalar["env_steps_per_s"] = B * trainer.cfg.horizon_length / seconds[-1]
        if rank == 0:
            observer.after_epoch(it, scalar)
    flat = flat_params(ts)
    np.save(os.path.join(out, f"params_rank{rank}.npy"), flat)
    result = dict(rank=rank, world_size=size, envs_per_rank=B // size, device=device,
                  seconds_per_epoch=seconds, kernel_launches_per_epoch=launches, a_loss=scalar["a_loss"],
                  reward_mean=scalar["reward_mean"], param_norm=float(np.linalg.norm(flat)))
    with open(os.path.join(out, f"result_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if rank == 0:
        ckpt.save(os.path.join(out, "ckpt_final.pt"), ts)
        observer.close()
    dist.barrier()
    dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
