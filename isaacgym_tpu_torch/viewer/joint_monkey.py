"""Joint-monkey kinematic exerciser (``isaacgym_tpu/viewer/joint_monkey.py``).

A 5-actor scene (two G1 robots facing each other, a table, two balls),
animated by sweeping each joint between its limits at the reference speed
rule (clamp(2 * range, 0.25 pi, 3 pi)), with the balls' drop-and-relaunch
check. The robots are driven kinematically: DOF positions are set each
frame and bodies come from the port's FK; only the balls integrate
ballistically with plane and table bounces (the port's contact functions).
Instead of a GL viewer the trajectory records to ``.npz``; a run is
bit-deterministic under a fixed seed on a given device.

Run: ``python -m isaacgym_tpu_torch.viewer.joint_monkey [steps] [out.npz] [--device cpu]``
(the card by default).
"""

from __future__ import annotations

import argparse
import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from isaacgym_tpu_torch.models.kinematics import fk_body_states
from isaacgym_tpu_torch.ops import contacts as C
from isaacgym_tpu_torch.tasks import pingpong_common as P
from isaacgym_tpu_torch.viewer.trajectory import TrajectoryRecorder

ANIM_SEEK_LOWER, ANIM_SEEK_UPPER, ANIM_SEEK_DEFAULT = 0, 1, 2

DT = 1.0 / 60.0
ROBOT1_POS = np.array([0.0, 0.0, 1.0], np.float32)
ROBOT2_POS = np.array([3.5, 0.0, 1.0], np.float32)
TABLE_POS = np.array([1.75, 0.0, 0.0], np.float32)
BALL_STARTS = np.array([[0.4, 0.28, 1.3], [3.1, -0.28, 1.3]], np.float32)
BALL_RESTITUTION = 0.5 * (0.9 + 0.7)   # ball 0.9 vs table 0.7, avg combine
BALL_RADIUS = 0.02


@lru_cache(maxsize=1)
def _trees():
    return P.load_tree("g1_29dof_pingpong.urdf"), P.load_tree("pingpong_table.urdf")


class _Frame:
    """One kinematic frame on ``device``: FK of both robots, both balls
    integrated one step."""

    def __init__(self, device):
        g1, table = _trees()
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        self.g1, self.device = g1, device
        self.pos1, self.pos2 = t(ROBOT1_POS)[None], t(ROBOT2_POS)[None]
        self.yaw180 = t(P.quat_from_yaw_deg(180.0))[None]
        self.ident = t([0.0, 0.0, 0.0, 1.0])
        self.zeros_q = torch.zeros((1, g1.n_dof), device=device)
        self.gravity = t([0.0, 0.0, -9.81])
        self.zero3 = torch.zeros(3, device=device)
        self.table_geoms = [(t(TABLE_POS) + t(table.geom_pos[i]), t(table.geom_quat[i]),
                             t(table.geom_size[i])) for i in range(len(table.geom_kind))]
        self.table_state = torch.cat([t(TABLE_POS), self.ident, torch.zeros(6, device=device)])
        self.body_names = ([f"robot1/{n}" for n in g1.body_names]
                           + [f"robot2/{n}" for n in g1.body_names]
                           + ["pingpong_table"] + ["ball1", "ball2"])

    def _ball_step(self, pos, vel):
        vel = vel + self.gravity * DT
        fr = C.sphere_plane(pos, BALL_RADIUS)
        dv, _, active = C.resolve_sphere_impulse(vel, fr, self.zero3, 0.45, 0.2)
        vel = vel + dv
        pos = C.depenetrate(pos, fr, active)
        for gp, gquat, size in self.table_geoms:
            fr = C.sphere_box(pos, BALL_RADIUS, gp, gquat, size)
            dv, _, active = C.resolve_sphere_impulse(vel, fr, self.zero3, BALL_RESTITUTION, 0.2)
            vel = vel + dv
            pos = C.depenetrate(pos, fr, active)
        return pos + vel * DT, vel

    @torch.no_grad()
    def __call__(self, q, ball_pos, ball_vel):
        nd = self.g1.n_dof
        r1 = fk_body_states(self.g1, self.pos1, self.ident[None], q[None, :nd], self.zeros_q)[0]
        r2 = fk_body_states(self.g1, self.pos2, self.yaw180, q[None, nd:], self.zeros_q)[0]
        p1, v1 = self._ball_step(ball_pos[0], ball_vel[0])
        p2, v2 = self._ball_step(ball_pos[1], ball_vel[1])
        z3 = self.zero3
        balls = torch.stack([torch.cat([p1, self.ident, v1, z3]),
                             torch.cat([p2, self.ident, v2, z3])])
        bodies = torch.cat([r1, r2, self.table_state[None], balls], dim=0)
        return bodies, torch.stack([p1, p2]), torch.stack([v1, v2])


def anim_speeds(tree) -> np.ndarray:
    rng = tree.upper - tree.lower
    return np.clip(2.0 * rng, 0.25 * math.pi, 3.0 * math.pi)


def run(steps: int = 240, out_path: Optional[str] = None, seed: int = 0, device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for but no CUDA device is available")
    frame_fn = _Frame(device)
    g1 = frame_fn.g1
    nd = 2 * g1.n_dof
    lower = np.concatenate([g1.lower, g1.lower])
    upper = np.concatenate([g1.upper, g1.upper])
    speeds = np.concatenate([anim_speeds(g1), anim_speeds(g1)])

    anim_state = np.full(nd, ANIM_SEEK_LOWER)
    targets = np.zeros(nd, np.float32)
    current = 0

    ball_pos = torch.as_tensor(BALL_STARTS, device=device)
    ball_vel = torch.zeros((2, 3), device=device)
    rng = np.random.RandomState(seed)
    rec = TrajectoryRecorder(frame_fn.body_names, max_envs=1)

    for _ in range(steps):
        d = current
        if anim_state[d] == ANIM_SEEK_LOWER:
            targets[d] -= speeds[d] * DT
            if targets[d] <= lower[d]:
                targets[d] = lower[d]
                anim_state[d] = ANIM_SEEK_UPPER
        elif anim_state[d] == ANIM_SEEK_UPPER:
            targets[d] += speeds[d] * DT
            if targets[d] >= upper[d]:
                targets[d] = upper[d]
                anim_state[d] = ANIM_SEEK_DEFAULT
        else:
            targets[d] -= speeds[d] * DT
            if targets[d] <= 0.0:
                targets[d] = 0.0
                anim_state[d] = ANIM_SEEK_LOWER
                current = (current + 1) % nd

        bodies, ball_pos, ball_vel = frame_fn(torch.as_tensor(targets, device=device),
                                              ball_pos, ball_vel)

        # ball drop and relaunch (the reference's check_reset / reset_ids)
        bz = ball_pos[:, 2].cpu().numpy()
        if bz[0] < 0.05 and bz[1] < 0.05:
            vels = []
            for sign in (1.0, -1.0):
                speed = sign * rng.uniform(6.5, 7.5)
                tilt = math.radians(rng.uniform(-5.0, 5.0))
                vels.append([speed * math.cos(tilt), speed * math.sin(tilt), 0.0])
            ball_pos = torch.as_tensor(BALL_STARTS, device=device)
            ball_vel = torch.as_tensor(vels, dtype=torch.float32, device=device)

        rec.record(bodies[None])

    if out_path:
        rec.save(out_path)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("steps", nargs="?", type=int, default=240)
    ap.add_argument("out", nargs="?", default="joint_monkey_traj.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.steps, args.out, seed=args.seed, device=args.device)
    arr = rec.stacked()
    print(f"recorded {arr.shape[0]} frames x {arr.shape[2]} bodies -> {args.out}")
    print("trajectory checksum:", float(np.abs(arr).sum()))


if __name__ == "__main__":
    main()
