"""Population-based training (``tools/pbt.py``'s rules, on the port).

Members periodically compare objectives; the underperformers restart from a
top performer's train state with a mutated learning rate:

  for each round: every member trains ``epochs_per_round`` epochs on its own
  env state and train state; then the bottom quarter (at least one)
  EXPLOITS (a clone of a random top-quarter member's whole train state) and
  EXPLORES (the donor's lr x 0.8 or x 1.25, clamped to [1e-6, 1e-2]).

One trainer runs every member (the lr is the state's ``last_lr``, so the
schedule is forced to ``constant``: adaptive or linear would overwrite the
mutated lr). The initial lr spread and every exploit/explore choice come
from one ``random.Random(seed)`` in the JAX tool's order. The objective is
the mean finished-episode return over the member's round (what
``PbtObserver`` exports).

The update changes a state's tensors in place (``clip_and_adam``), so an
exploit clones every tensor of the donor's state: the clone and the donor
train on apart. A member keeps its own generator (``ts.rng``) and env state,
and its own stream of the env's generator (seeded as its trainer, ``seed +
1000 (m + 1)``), which is swapped in while it trains.

    python -m isaacgym_tpu_torch.pbt task=HumanoidPingpongTiltNoEarlyStopG1 \\
        population=4 rounds=5 epochs_per_round=50 num_envs=1024 experiment=pbt_demo
    # on the CPU: add device=cpu and a small net, e.g.
    #   train.params.network.mlp.units=[32,32]

Writes ``runs/<experiment>/pbt_history.jsonl`` (one row per round) and
``ckpt_best.pt``, and prints the best member as the last line.
"""

from __future__ import annotations

import copy
import json
import os
import random
import sys
import time

import torch

PBT_KEYS = ("population", "rounds", "epochs_per_round", "task")


def clone_train_state(ts, rng: torch.Generator, lr: float):
    """A copy of ``ts`` that shares no tensor with it, with the given
    generator and ``last_lr``."""
    from isaacgym_tpu_torch.rl.normalizer import RunningStats
    from isaacgym_tpu_torch.rl.ppo import AdamState
    opt = ts.opt_state
    return ts._replace(
        params=copy.deepcopy(ts.params),
        opt_state=AdamState(opt.count, [m.clone() for m in opt.mu], [v.clone() for v in opt.nu]),
        obs_stats=RunningStats(*[t.clone() for t in ts.obs_stats]),
        value_stats=RunningStats(*[t.clone() for t in ts.value_stats]),
        rng=rng, last_lr=torch.tensor(lr, dtype=torch.float32, device=ts.last_lr.device))


def main(argv, run_root: str = "runs"):
    """Run the population; returns ``(members, history rows, trainer)``."""
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.rl import checkpoint as ckpt
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config

    overrides = [a for a in argv if "=" in a]
    kv = dict(o.split("=", 1) for o in overrides)
    task_name = kv.get("task", "HumanoidPingpongTiltNoEarlyStopG1")
    population = int(kv.get("population", 4))
    rounds = int(kv.get("rounds", 3))
    epochs_per_round = int(kv.get("epochs_per_round", 20))
    cfg = compose(task_name, [o for o in overrides if o.split("=", 1)[0] not in PBT_KEYS])
    preprocess_train_config(cfg)
    seed = int(cfg["seed"])
    env = make(seed=seed, task=task_name, device=str(cfg["device"]), cfg=cfg["task"])
    ppo_cfg = PPOConfig.from_train_cfg(cfg["train"])
    if ppo_cfg.lr_schedule != "constant":
        ppo_cfg = type(ppo_cfg)(**{**ppo_cfg.__dict__, "lr_schedule": "constant"})

    experiment = cfg["experiment"] or f"pbt_{task_name}_{time.strftime('%y%m%d-%H%M%S')}"
    run_dir = os.path.join(run_root, experiment)
    os.makedirs(run_dir, exist_ok=True)

    trainer = PPOTrainer(env, ppo_cfg, seed=seed)   # one trainer for every member
    rng = random.Random(seed)
    members = []
    for m in range(population):
        ts = PPOTrainer(env, ppo_cfg, seed=seed + 1000 * (m + 1)).init_state()
        # spread the initial lr across half an order of magnitude
        lr = ppo_cfg.learning_rate * rng.choice([0.5, 0.8, 1.0, 1.25, 2.0])
        ts = ts._replace(last_lr=torch.tensor(lr, dtype=torch.float32, device=env.device))
        env.generator.manual_seed(seed + 1000 * (m + 1))
        env_state, obs = env.reset()
        members.append(dict(ts=ts, env_state=env_state, obs=obs, lr=lr,
                            env_rng=env.generator.get_state(), objective=float("-inf")))

    n_exploit = max(1, population // 4)
    log_path = os.path.join(run_dir, "pbt_history.jsonl")
    history = []
    t0 = time.time()
    for rnd in range(rounds):
        for mem in members:
            env.generator.set_state(mem["env_rng"])
            ret_sum = cnt = 0.0
            ts, env_state, obs = mem["ts"], mem["env_state"], mem["obs"]
            for _ in range(epochs_per_round):
                ts, env_state, obs, metrics = trainer.train_epoch(ts, env_state, obs)
                ret_sum += float(metrics["episode_return_sum"])
                cnt += float(metrics["episode_count"])
            mem.update(ts=ts, env_state=env_state, obs=obs, env_rng=env.generator.get_state(),
                       objective=ret_sum / max(cnt, 1.0))

        order = sorted(range(population), key=lambda i: members[i]["objective"], reverse=True)
        top, bottom = order[:n_exploit], order[-n_exploit:]
        for bi in bottom:
            if bi in top:
                continue   # degenerate tiny populations
            src, dst = members[rng.choice(top)], members[bi]
            new_lr = max(1e-6, min(1e-2, src["lr"] * rng.choice([0.8, 1.25])))
            # exploit the donor's train state; keep the member's own streams
            dst["ts"] = clone_train_state(src["ts"], dst["ts"].rng, new_lr)
            dst["lr"] = new_lr

        row = dict(round=rnd, objectives=[round(m["objective"], 3) for m in members],
                   lrs=[m["lr"] for m in members],
                   exploited=[int(b) for b in bottom if b not in top],
                   elapsed_s=round(time.time() - t0, 1))
        history.append(row)
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    best = max(members, key=lambda m: m["objective"])
    ckpt.save(os.path.join(run_dir, "ckpt_best.pt"), best["ts"])
    print(json.dumps(dict(best_objective=round(best["objective"], 3), best_lr=best["lr"],
                          run_dir=run_dir)), flush=True)
    return members, history, trainer


if __name__ == "__main__":
    main(sys.argv[1:])
