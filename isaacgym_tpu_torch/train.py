"""Training and play launcher of the port (the root ``train.py``'s surface).

    python -m isaacgym_tpu_torch.train task=HumanoidPingpongTiltNoEarlyStopG1 \\
        [task.randomize=true] num_envs=4096 max_iterations=1000 seed=42
    python -m isaacgym_tpu_torch.train task=... test=true checkpoint=runs/X/ckpt_final.pt

It composes the task and train configs with the overrides
(``utils/config.py``, then ``preprocess_train_config``: the PBT
``model_size_multiplier`` and the launcher fields), builds the env and the
PPO trainer on the card (or on the CPU with ``device=cpu``), restores a
checkpoint when asked, then plays (``test=true``) or trains, saving
``ckpt_<epoch>.pt`` every ``save_frequency`` epochs and ``ckpt_final.pt``
at the end under ``runs/<experiment>/`` with ``config.json`` and
``metrics.jsonl``. ``wandb_activate=true`` adds the W&B observer (it does
nothing without ``wandb``), ``pbt.enabled=true`` the PBT observer
(``pbt_objective.json``).

Under ``torchrun`` (``WORLD_SIZE > 1``) every rank joins the process group
(``parallel.mesh.init_distributed``, ``backend=nccl`` by default on the
card, ``gloo`` on the CPU or for several ranks on one card) and trains its
own replica seeded ``seed + rank``, as the JAX launcher does: it shards no
epoch (``parallel/data_parallel.py`` is the data-parallel epoch). Rank 0
alone writes ``config.json``, the observers' files, the checkpoints and the
console log.
"""

from __future__ import annotations

import json
import os
import sys
import time

EPISODE_SUMS = ("episode_count", "episode_return_sum", "episode_length_sum")


def main(argv, run_root: str = "runs"):
    overrides = [a for a in argv if "=" in a]
    kv = dict(o.split("=", 1) for o in overrides)
    task_name = kv.get("task", "HumanoidPingpongTiltNoEarlyStopG1")
    overrides = [o for o in overrides if not o.startswith("task=")]

    import torch
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.rl import checkpoint as ckpt
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.parallel.mesh import init_distributed
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    from isaacgym_tpu_torch.utils import logging as L

    cfg = compose(task_name, [o for o in overrides if not o.startswith("backend=")])
    preprocess_train_config(cfg)
    device = str(cfg["device"])
    rank, _, _ = init_distributed(kv.get("backend", "nccl" if device == "cuda" else "gloo"),
                                  device)
    seed = int(cfg["seed"]) + rank   # rank-offset seeding, as the JAX launcher
    env = make(seed=seed, task=task_name, device=device, cfg=cfg["task"])
    ppo_cfg = PPOConfig.from_train_cfg(cfg["train"])
    max_iters = int(cfg["max_iterations"] or ppo_cfg.max_epochs)

    experiment = cfg["experiment"] or f"{task_name}_{time.strftime('%y%m%d-%H%M%S')}"
    run_dir = os.path.join(run_root, experiment)
    if rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)

    trainer = PPOTrainer(env, ppo_cfg, seed=seed)
    ts = trainer.init_state()
    if cfg["checkpoint"]:
        ts = ckpt.restore(str(cfg["checkpoint"]), ts)
        print(f"restored checkpoint from {cfg['checkpoint']} (epoch {ts.epoch})", flush=True)

    if cfg["test"]:
        from isaacgym_tpu_torch.rl.player import play
        stats = play(env, trainer, ts, episodes=int(cfg.get("episodes", 4)),
                     sigma=float(cfg["sigma"]) if cfg["sigma"] not in ("", None) else None)
        if rank == 0:
            print(json.dumps(stats), flush=True)
        return stats

    observers = [L.JsonlObserver()]
    if str(cfg.get("wandb_activate", False)).lower() in ("1", "true"):
        observers.append(L.WandbObserver(
            project=str(cfg.get("wandb_project", "isaacgym_tpu")),
            name=str(cfg.get("wandb_name") or experiment),
            entity=str(cfg.get("wandb_entity", "")),
            group=str(cfg.get("wandb_group", "")), rank=rank))
    if (cfg.get("pbt") or {}).get("enabled"):
        observers.append(L.PbtObserver())
    observer = L.MultiObserver(observers)
    if rank == 0:
        observer.after_init(run_dir, cfg)
    save_freq = int(cfg["train"]["params"]["config"].get("save_frequency", 1500))
    log_every = int(cfg.get("log_every", 10))
    if rank == 0:
        print(f"training {task_name}: {env.num_envs} envs on {env.device}, horizon "
              f"{ppo_cfg.horizon_length}, {max_iters} epochs, seed {seed}", flush=True)
    env_state, obs = env.reset()
    steps_per_epoch = env.num_envs * ppo_cfg.horizon_length
    t_start = t_last = time.time()
    it_last = ts.epoch
    # episode sums accumulate over the logging stride: with the episode
    # length a multiple of the horizon, boundaries fall in fixed epoch phases
    pending = {}
    for it in range(ts.epoch, max_iters):
        ts, env_state, obs, metrics = trainer.train_epoch(ts, env_state, obs)
        for k, v in metrics.items():
            if k in EPISODE_SUMS or (k.startswith("event_") and k.endswith("_sum")):
                pending[k] = pending[k] + v if k in pending else v
        if rank == 0 and (it < 3 or it % log_every == 0):
            scalar = {k: float(v) for k, v in metrics.items()}   # waits for the epoch
            now = time.time()
            scalar["env_steps_per_s"] = steps_per_epoch * (it - it_last + 1) / max(now - t_last, 1e-9)
            t_last, it_last = now, it + 1
            scalar.update({k: float(v) for k, v in pending.items()})
            pending = {}
            n_ep = max(scalar["episode_count"], 1e-9)
            scalar["episode_return_mean"] = scalar.pop("episode_return_sum") / n_ep
            scalar["episode_length_mean"] = scalar.pop("episode_length_sum") / n_ep
            for k in [k for k in scalar if k.startswith("event_") and k.endswith("_sum")]:
                scalar[k[:-4] + "_rate"] = scalar.pop(k) / n_ep
            observer.after_epoch(it, scalar)
            print(f"epoch {it:6d}  reward_mean {scalar['reward_mean']:9.3f}  "
                  f"ep_ret {scalar['episode_return_mean']:9.1f}  "
                  f"ep_len {scalar['episode_length_mean']:6.1f}  "
                  f"a_loss {scalar['a_loss']:.4f}  c_loss {scalar['c_loss']:.4f}  "
                  f"kl {scalar['kl']:.4f}  {scalar['env_steps_per_s']:,.0f} steps/s", flush=True)
        if rank == 0 and save_freq and (it + 1) % save_freq == 0:
            ckpt.save(os.path.join(run_dir, f"ckpt_{it + 1:07d}.pt"), ts)
    if device == "cuda":
        torch.cuda.synchronize()
    if rank == 0:
        ckpt.save(os.path.join(run_dir, "ckpt_final.pt"), ts)
        observer.close()
        print(f"done in {time.time() - t_start:.0f}s; checkpoints in {run_dir}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return ts


if __name__ == "__main__":
    main(sys.argv[1:])
