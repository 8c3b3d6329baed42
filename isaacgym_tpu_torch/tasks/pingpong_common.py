"""Scene construction, ball launch and observation blocks of the pingpong
family, batched in torch.

Counterpart of ``isaacgym_tpu/tasks/pingpong_common.py``: the 3- or 4-actor
scene (``build_pingpong_scene``, ``:41``), the launch-velocity sampler (``:129``)
and the heading-local observation blocks (``:145``, ``:165``), written over a
leading batch dimension instead of per env.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.sim.scene import DRIVE_POS, ActorSpec, PlaneParams, SceneSpec
from isaacgym_tpu_torch.utils import rotations as rot


def load_tree(filename: str, floating_base: bool = False) -> K.KinematicTree:
    return K.load_asset(os.path.join(ASSET_DIR, filename), floating_base=floating_base)


def quat_from_yaw_deg(deg: float):
    half = np.radians(deg) / 2.0
    return (0.0, 0.0, float(np.sin(half)), float(np.cos(half)))


def build_pingpong_scene(env_cfg, sim_cfg, *, humanoids=1) -> SceneSpec:
    """The 3-actor (or 4-actor) scene: fixed-base humanoid(s) + table + ball,
    in that actor order. The second humanoid stands at ``humanoid2Pos`` with
    yaw ``humanoid2YawDeg``."""
    sc = env_cfg["scene"]
    plane_cfg = env_cfg.get("plane", {})
    if plane_cfg.get("terrain") or (env_cfg.get("heightmap") or {}).get("enabled"):
        raise NotImplementedError("terrain and heightmap obs are not ported yet "
                                  "(ROADMAP, module 9)")
    g1 = load_tree(env_cfg["asset"]["assetFileName"])
    table = load_tree("pingpong_table.urdf")
    ball = load_tree("small_ball.urdf")
    kp = np.asarray(sc["pdGains"], np.float32)
    kd = kp / 40.0
    ball_aero = env_cfg.get("ball", {}) or {}
    actors = [
        ActorSpec(name=f"humanoid{h + 1}", tree=g1,
                  pos=tuple(sc["humanoidPos"] if h == 0 else sc["humanoid2Pos"]),
                  quat=quat_from_yaw_deg(sc.get("humanoidYawDeg", 0.0) if h == 0
                                         else sc.get("humanoid2YawDeg", 180.0)),
                  fixed_base=True, restitution=sc["humanoidRestitution"],
                  friction=sc["humanoidFriction"], drive_mode=DRIVE_POS,
                  stiffness=kp, damping=kd, max_angular_velocity=100.0)
        for h in range(humanoids)
    ] + [
        ActorSpec(name="pingpong_table", tree=table, pos=tuple(sc["tablePos"]),
                  fixed_base=True, restitution=sc["tableRestitution"],
                  friction=sc["tableFriction"]),
        ActorSpec(name="pingpong_ball_2", tree=ball, pos=tuple(sc["ballStartPos"]),
                  fixed_base=False, restitution=sc["ballRestitution"],
                  friction=sc["ballFriction"],
                  drag_coefficient=float(ball_aero.get("dragCoefficient", 0.0)),
                  magnus_coefficient=float(ball_aero.get("magnusCoefficient", 0.0))),
    ]
    return SceneSpec(
        actors=actors,
        link_collision=bool(sc.get("linkCollision", env_cfg.get("linkCollision", False))),
        exact_link_support=bool(sc.get("exactLinkSupport",
                                       env_cfg.get("exactLinkSupport", True))),
        plane=PlaneParams(
            static_friction=plane_cfg.get("staticFriction", 1.0),
            dynamic_friction=plane_cfg.get("dynamicFriction", 1.0),
            restitution=plane_cfg.get("restitution", 0.0)),
        gravity=tuple(sim_cfg.get("gravity", (0.0, 0.0, -9.81))),
        dt=float(sim_cfg["dt"]),
        substeps=int(sim_cfg["substeps"]),
        bounce_threshold_velocity=float(
            sim_cfg.get("physx", {}).get("bounce_threshold_velocity", 0.2)),
        max_depenetration_velocity=float(
            sim_cfg.get("physx", {}).get("max_depenetration_velocity", 10.0)),
    )


def sample_ball_velocity(n, speed_range, tilt_range_deg, tilt_z_range_deg,
                         generator: torch.Generator, device):
    """(n, 3) launch velocities v = (-s cos a cos b, s sin a cos b, s sin b),
    s, a (tilt), b (tilt_z) uniform in their ranges."""
    u = torch.rand((3, n), generator=generator, device=device)
    s = speed_range[0] + (speed_range[1] - speed_range[0]) * u[0]
    a = torch.deg2rad(tilt_range_deg[0] + (tilt_range_deg[1] - tilt_range_deg[0]) * u[1])
    b = torch.deg2rad(tilt_z_range_deg[0] + (tilt_z_range_deg[1] - tilt_z_range_deg[0]) * u[2])
    return torch.stack([-s * torch.cos(a) * torch.cos(b), s * torch.sin(a) * torch.cos(b),
                        s * torch.sin(b)], dim=-1)


def compute_humanoid_observations(body_states, dof_pos, dof_vel):
    """Heading-local body pos/vel + dof state: [local_body_pos (J*3),
    local_body_vel (J*3), dof_pos, dof_vel*0.1]; row 0 of ``body_states``
    (B, J, 13) is the root."""
    B, J = body_states.shape[:2]
    body_pos = body_states[..., 0:3]
    body_vel = body_states[..., 7:10]
    heading_inv = rot.calc_heading_quat_inv(body_states[:, 0, 3:7])[:, None].expand(B, J, 4)
    local_pos = rot.quat_rotate(heading_inv, body_pos - body_pos[:, :1])
    local_vel = rot.quat_rotate(heading_inv, body_vel)
    return torch.cat([local_pos.reshape(B, -1), local_vel.reshape(B, -1),
                      dof_pos, dof_vel * 0.1], dim=-1)


def compute_pingpong_observations(body_states, ball_root):
    """Heading-local ball position/velocity relative to the root body."""
    heading_inv = rot.calc_heading_quat_inv(body_states[:, 0, 3:7])
    local_pos = rot.quat_rotate(heading_inv, ball_root[:, 0:3] - body_states[:, 0, 0:3])
    local_vel = rot.quat_rotate(heading_inv, ball_root[:, 7:10])
    return torch.cat([local_pos, local_vel], dim=-1)
