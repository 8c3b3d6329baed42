"""Record a trained policy's rollout to a trajectory npz and render it
(``tools/record_policy.py``'s pipeline on the port).

    python -m isaacgym_tpu_torch.record_policy --checkpoint runs/exp/ckpt_final.pt \\
        [--task HumanoidPingpongTiltNoEarlyStopG1] [--envs 8] [--steps 200] \\
        [--out runs/media/policy] [--device cpu] [--fps 30] [--gif] [--no-render]

Restores a checkpoint of the port's launcher, rolls every env under the
policy's mean action on the card (``--device cpu`` on the CPU), records the
body states and the ball as a marker, and writes ``<out>.npz``; then renders
``<out>.mp4`` (and ``<out>.gif`` with ``--gif``) of the first env whose
one-shot paddle-hit flag fired, else the best-return env. Rendering is a
host step that needs OpenCV (and PIL for the gif); ``--no-render`` stops
after the npz.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--task", default="HumanoidPingpongTiltNoEarlyStopG1")
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="runs/media/policy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--gif", action="store_true", help="also write a .gif")
    ap.add_argument("--no-render", action="store_true", help="write the npz only")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl import checkpoint as ckpt
    from isaacgym_tpu_torch.rl.player import resolve_hit_flag
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose
    from isaacgym_tpu_torch.viewer.trajectory import TrajectoryRecorder

    cfg = compose(args.task, [f"num_envs={args.envs}", f"device={args.device}"])
    env = isaacgym_tpu_torch.make(seed=17, task=args.task, device=args.device,
                                  cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=17)
    ts = ckpt.restore(args.checkpoint, trainer.init_state())
    print(f"restored {args.checkpoint} (epoch {ts.epoch})", flush=True)

    state, obs = env.reset()
    B = env.num_envs
    hit_flag = resolve_hit_flag(env, state.flags)
    rec = TrajectoryRecorder(env.scene.body_names, max_envs=B, scene=env.scene)
    returns = torch.zeros(B, dtype=torch.float64, device=env.device)
    hit = torch.zeros(B, dtype=torch.bool, device=env.device)
    ball = getattr(env, "ball_actor", None)
    with torch.no_grad():
        for _ in range(args.steps):
            marker = state.sim.root[:, ball, None, :3] if ball is not None else None
            rec.record(env.sim.rigid_body_states(state.sim), markers=marker)
            mu = trainer._policy(ts.params, ts.obs_stats, obs)[0]
            state, obs, rew, done, info = env.step(state, mu)
            returns += rew.double()
            hit |= state.flags[hit_flag].to(torch.bool)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    npz = rec.save(args.out + ".npz")
    hit, returns = hit.cpu().numpy(), returns.cpu().numpy()
    env_idx = int(np.argmax(hit)) if hit.any() else int(np.argmax(returns))
    print(f"recorded {args.steps} steps x {B} envs -> {npz}; hits per env "
          f"{hit.astype(int).tolist()}, returns {[round(r) for r in returns.tolist()]}; "
          f"env {env_idx}", flush=True)
    if args.no_render:
        return
    from isaacgym_tpu_torch.viewer.render import render_trajectory
    print(render_trajectory(npz, args.out + ".mp4", env=env_idx, fps=args.fps))
    if args.gif:
        print(render_trajectory(npz, args.out + ".gif", env=env_idx, fps=args.fps,
                                size=(480, 270)))


if __name__ == "__main__":
    main()
