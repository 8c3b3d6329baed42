"""Ball-trajectory probe (``tools/probe_ball.py`` on the port).

Rolls a task with zero actions and reports the ball's arrival at the paddle
plane: when, where and how fast it crosses, the paddle-ball y-z distance the
Gauss reward sees, spin magnitudes and ground drops, under the JAX tool's
output keys. The physics switches come from the same ``ISAACGYM_TPU_*``
variables as the JAX tool's (``sim/switches.py``, read once when the env is
built): ``ISAACGYM_TPU_PALLAS=0 python -m isaacgym_tpu_torch.probe_ball``
takes the non-kernel step as ``ISAACGYM_TPU_PALLAS=0 python
tools/probe_ball.py`` takes the XLA one. ``pallas``, ``kappa_override`` and
``ccd`` report them as the JAX tool does (``tools/probe_ball.py:88-90``;
the forced kappa as a number); ``route`` names the simulator's route and
``kernel_launches`` counts each kernel wrapper's launches.

    python -m isaacgym_tpu_torch.probe_ball [--envs 512] [--steps 170]
        [--device cuda|cpu] [--seed 1] [--task T]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


@torch.no_grad()
def roll(env, state, steps: int):
    """``steps`` zero-action steps from ``state``: the ball's root (T, B,
    13), the paddle's position (T, B, 3) and the rewards (T, B), as numpy."""
    zeros = torch.zeros((env.num_envs, env.num_actions), device=env.device)
    balls, paddles, rews = [], [], []
    for _ in range(steps):
        state, _obs, rew, _done, _info = env.step(state, zeros)
        balls.append(state.sim.root[:, env.ball_actor, :].clone())
        paddles.append(env._rb_fn(state.sim)[:, env._paddle_row, 0:3].clone())
        rews.append(rew.clone())
    return (torch.stack(balls).cpu().numpy(), torch.stack(paddles).cpu().numpy(),
            torch.stack(rews).cpu().numpy())


def arrival_stats(balls, paddles, rews) -> dict:
    """The JAX tool's statistics of one roll."""
    T, B = balls.shape[:2]
    pos, vel, omg = balls[..., 0:3], balls[..., 7:10], balls[..., 10:13]
    # first crossing of the paddle plane while moving toward the robot
    px = paddles[0, :, 0]
    crossed = (pos[..., 0] <= px[None, :]) & (vel[..., 0] < 0.0)
    m = crossed.any(axis=0)
    t_cross = np.where(m, crossed.argmax(axis=0), -1)
    idx, bsel = np.maximum(t_cross, 0), np.arange(B)
    y_c, z_c = pos[idx, bsel, 1], pos[idx, bsel, 2]
    vx_c = vel[idx, bsel, 0]
    spin_c = np.linalg.norm(omg[idx, bsel], axis=-1)
    d_yz = np.sqrt((paddles[idx, bsel, 1] - y_c) ** 2 + (paddles[idx, bsel, 2] - z_c) ** 2)
    dropped = (pos[..., 2] < 0.1).any(axis=0)

    def q(a, p):
        return float(np.percentile(a[m], p)) if m.any() else float("nan")

    return {
        "envs": B, "steps": T,
        "cross_rate": float(m.mean()),
        "t_cross_med": q(t_cross.astype(float), 50),
        "y_cross": [q(y_c, 10), q(y_c, 50), q(y_c, 90)],
        "z_cross": [q(z_c, 10), q(z_c, 50), q(z_c, 90)],
        "vx_cross": [q(vx_c, 10), q(vx_c, 50), q(vx_c, 90)],
        "spin_at_cross": [q(spin_c, 10), q(spin_c, 50), q(spin_c, 90)],
        "gauss_d_yz": [q(d_yz, 10), q(d_yz, 50), q(d_yz, 90)],
        "gauss_reward_med": float(np.exp(-20.0 * q(d_yz, 50) ** 2)) if m.any() else 0.0,
        "dropped_rate": float(dropped.mean()),
        "max_spin_rad_s": float(np.linalg.norm(omg, axis=-1).max()),
        "reward_mean": float(rews.mean()),
        "paddle_xyz0": [float(v) for v in paddles[0, 0]],
    }


def probe(env, state, steps: int, task: str) -> dict:
    stats = arrival_stats(*roll(env, state, steps))
    sw = env.sim.switches.report()
    return {"task": task, **stats, "pallas": sw["pallas"], "kappa_override": sw["kappa_override"],
            "ccd": sw["ccd"], "route": env.sim.route,
            "kernel_launches": env.sim.kernel_launches()}


def main(argv=None):
    ap = argparse.ArgumentParser(description="zero-action ball probe on the port")
    ap.add_argument("--task", default="HumanoidPingpongTiltNoEarlyStopG1")
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--steps", type=int, default=170)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from isaacgym_tpu_torch.make import make
    env = make(seed=args.seed, task=args.task, num_envs=args.envs, device=args.device)
    state, _obs = env.reset()
    out = probe(env, state, args.steps, args.task)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
