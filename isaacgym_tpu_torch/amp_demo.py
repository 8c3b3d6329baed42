"""End-to-end AMP training on the port (``tools/amp_demo.py``'s pipeline).

1. restore an expert checkpoint of the port's launcher (``ckpt_*.pt``) and
   record a deterministic rollout of its mean action as a MotionLib clip
   (env 0's DOF positions and velocities);
2. train a fresh policy with :class:`isaacgym_tpu_torch.rl.amp.AMPTrainer`:
   each epoch is a discriminator update (expert demos against fresh agent
   transitions), then a whole PPO epoch on style-blended rewards;
3. write per-epoch JSON lines (discriminator logits and loss, reward, task
   return) to ``<out>/metrics.jsonl``.

A healthy run: ``disc_demo_logit`` climbs toward +1, ``disc_agent_logit``
stays apart (about -1) early, and the gap narrows as the policy's motion
moves toward the expert's.

    python -m isaacgym_tpu_torch.amp_demo --expert runs/exp/ckpt_final.pt \\
        [--task HumanoidPingpongTiltNoEarlyStopG1] [--envs 2048] [--epochs 600] \\
        [--clip-steps 240] [--out runs/amp_demo] [--device cpu] [--units 512,256]

The card by default; ``--device cpu`` on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def record_clip(env, policy, steps: int, path: str) -> float:
    """Roll ``env`` ``steps`` steps under ``policy(obs) -> actions`` and save
    env 0's DOF trajectory as a MotionLib clip at ``path``; returns its fps
    (one frame per env step)."""
    import torch
    from isaacgym_tpu_torch.rl.motion_lib import save_motion_clip
    state, obs = env.reset()
    qs, qds = [], []
    with torch.no_grad():
        for _ in range(steps):
            state, obs, _r, _d, _i = env.step(state, policy(obs))
            qs.append(state.sim.dof_pos[0].clone())
            qds.append(state.sim.dof_vel[0].clone())
    T = len(qs)
    fps = 1.0 / float(env.sim.dt)
    save_motion_clip(path, fps=fps, root_pos=torch.zeros((T, 3)),
                     root_rot=torch.tensor([0.0, 0.0, 0.0, 1.0]).repeat(T, 1),
                     dof_pos=torch.stack(qs), dof_vel=torch.stack(qds))
    return fps


def dof_obs_offset(env) -> int:
    """Where the DOF positions start in the env's observation vector, found
    by matching a fresh state's."""
    import numpy as np
    state, obs = env.reset()
    nd = env.num_actions
    q0 = state.sim.dof_pos[0].cpu().numpy()
    o0 = obs[0].cpu().numpy()
    return next(i for i in range(len(o0) - nd + 1) if np.allclose(o0[i:i + nd], q0, atol=1e-4))


def amp_features(lib, offset: int, nd: int, fps: float):
    """(amp_obs_fn, demo_sampler) over the (dof_pos, 0.1 dof_vel) slice of
    the observation at ``offset``, and the same features of demo transitions
    one frame apart drawn from ``lib``; the discriminator sees 4 ``nd``
    features."""
    import torch
    dt = 1.0 / fps

    def amp_obs_fn(o, o2):
        return torch.cat([o[..., offset:offset + 2 * nd], o2[..., offset:offset + 2 * nd]],
                         dim=-1)

    def demo_sampler(generator, n):
        ids = lib.sample_motions(generator, n)
        t0 = lib.sample_time(generator, ids) * 0.8
        s0 = lib.get_motion_state(ids, t0)
        s1 = lib.get_motion_state(ids, t0 + dt)
        f = lambda s: torch.cat([s["dof_pos"], s["dof_vel"] * 0.1], dim=-1)
        return torch.cat([f(s0), f(s1)], dim=-1)

    return amp_obs_fn, demo_sampler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--expert", required=True)
    ap.add_argument("--task", default="HumanoidPingpongTiltNoEarlyStopG1")
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--clip-steps", type=int, default=240)
    ap.add_argument("--out", default="runs/amp_demo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--units", default="512,256",
                    help="policy MLP units for the fresh AMP policy")
    args = ap.parse_args(argv)

    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl import amp as A
    from isaacgym_tpu_torch.rl import checkpoint as ckpt
    from isaacgym_tpu_torch.rl.motion_lib import MotionLib
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose

    os.makedirs(args.out, exist_ok=True)

    # ---- 1. the expert clip: a small batch, env 0's trajectory
    cfg = compose(args.task, ["num_envs=8", f"device={args.device}"])
    rec_env = isaacgym_tpu_torch.make(seed=7, task=args.task, device=args.device,
                                      cfg=cfg["task"])
    expert = PPOTrainer(rec_env, PPOConfig.from_train_cfg(cfg["train"]), seed=7)
    ets = ckpt.restore(args.expert, expert.init_state())
    print(f"expert restored: {args.expert} (epoch {ets.epoch})", flush=True)
    clip = os.path.join(args.out, "expert_clip.npz")
    fps = record_clip(rec_env, lambda o: expert._policy(ets.params, ets.obs_stats, o)[0],
                      args.clip_steps, clip)
    nd = rec_env.num_actions
    lib = MotionLib(clip, num_dofs=nd, device=args.device)
    print(f"expert clip: {args.clip_steps} frames @ {fps:.0f} fps -> {clip}", flush=True)

    # ---- 2. AMP training of a fresh policy
    env = isaacgym_tpu_torch.make(seed=1, task=args.task, num_envs=args.envs,
                                  device=args.device)
    amp_obs_fn, demo_sampler = amp_features(lib, dof_obs_offset(env), nd, fps)
    units = tuple(int(u) for u in args.units.split(","))
    pcfg = PPOConfig(units=units, horizon_length=32,
                     minibatch_size=min(4096, args.envs * 32 // 4),
                     mini_epochs=5, learning_rate=1e-4)
    trainer = A.AMPTrainer(env, pcfg, amp_obs_dim=4 * nd, demo_sampler=demo_sampler,
                           amp_obs_fn=amp_obs_fn, seed=1)
    ppo_state, amp_state = trainer.init_state()
    env_state, obs = trainer.reset(amp_state)

    mpath = os.path.join(args.out, "metrics.jsonl")
    t0 = time.time()
    with open(mpath, "w") as mf:
        for it in range(args.epochs):
            ppo_state, amp_state, env_state, obs, metrics = trainer.train_epoch(
                ppo_state, amp_state, env_state, obs)
            if it % 10 == 0 or it == args.epochs - 1:
                m = {k: float(v) for k, v in metrics.items()}
                row = {"epoch": it, "time": round(time.time() - t0, 1)}
                for name in ("reward_mean", "a_loss", "c_loss", "kl", "disc_loss",
                             "disc_agent_logit", "disc_demo_logit", "disc_grad_penalty"):
                    row[name] = m[name]
                if m["episode_count"]:
                    row["episode_return_mean"] = m["episode_return_sum"] / m["episode_count"]
                mf.write(json.dumps(row) + "\n")
                mf.flush()
                print(f"epoch {it:5d} disc_demo {row['disc_demo_logit']:+.3f} "
                      f"disc_agent {row['disc_agent_logit']:+.3f} "
                      f"reward {row['reward_mean']:+.4f}", flush=True)
    print(f"done in {time.time() - t0:.0f}s; metrics -> {mpath}")


if __name__ == "__main__":
    main()
