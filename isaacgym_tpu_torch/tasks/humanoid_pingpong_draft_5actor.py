"""HumanoidPingpong5ActorG1 (C11), the draft 5-actor task, batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_draft_5actor.py``:
5 actors per env [robot1, robot2, table, ball1, ball2], two fixed-base
26-DOF G1s facing each other (the second at x = 3.5 m, yaw 180 deg), effort
drive (the action times each DOF's motor effort times ``powerScale``), act
52, stepped by K3 at <26, 2, 2>. Ball 1 is launched toward robot 2 (+x),
ball 2 toward robot 1 (-x), both planar. The observation is 24 global-frame
values: each paddle's and each ball's position and velocity. The reward is
the symmetric paddle-ball distance term 1 / (1 + |p1 - b2|^2) + 1 / (1 +
|p2 - b1|^2); an env resets when ball 1 drops below z = 0.1 or its episode
ends. Like the JAX class it sits on the plain vec task, not on the pingpong
family's base.
"""

from __future__ import annotations

import numpy as np
import torch

from isaacgym_tpu_torch.env.vec_task import TorchVecTask
from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, ActorSpec, PlaneParams, SceneSpec
from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks import pingpong_common as P


def build_5actor_scene(sim_cfg, native: bool = True) -> SceneSpec:
    """The 5-actor scene (``:48-72``): [robot1, robot2, table, ball1, ball2],
    both robots fixed-base and effort-driven, at the config's dt and
    substeps."""
    g1 = P.load_tree("g1_26dof_pingpong.urdf", native=native)
    table = P.load_tree("pingpong_table.urdf", native=native)
    ball = P.load_tree("small_ball.urdf", native=native)
    robots = [
        ActorSpec("robot1", g1, pos=(0.0, 0.0, 1.0), fixed_base=True,
                  restitution=0.6, friction=0.5, drive_mode=DRIVE_EFFORT),
        ActorSpec("robot2", g1, pos=(3.5, 0.0, 1.0), quat=P.quat_from_yaw_deg(180.0),
                  fixed_base=True, restitution=0.6, friction=0.5, drive_mode=DRIVE_EFFORT),
    ]
    return SceneSpec(
        actors=robots + [
            ActorSpec("pingpong_table", table, pos=(1.75, 0.0, 0.0), fixed_base=True,
                      restitution=0.6, friction=0.2),
            ActorSpec("pingpong_ball_1", ball, pos=(0.4, 0.28, 1.3), fixed_base=False,
                      restitution=0.9, friction=0.2),
            ActorSpec("pingpong_ball_2", ball, pos=(3.1, -0.28, 1.3), fixed_base=False,
                      restitution=0.9, friction=0.2),
        ],
        plane=PlaneParams(),
        dt=float(sim_cfg["dt"]),
        substeps=int(sim_cfg["substeps"]),
    )


class HumanoidPingpong5Actor(TorchVecTask):

    PADDLE_BODY = 39
    ROBOT1, ROBOT2, TABLE, BALL1, BALL2 = 0, 1, 2, 3, 4
    ball_actor = BALL2   # the primary ball of ``pre_ball_root``, as in the JAX class

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        env = cfg["env"]
        env["numObservations"] = 24
        env["numActions"] = 52
        self.power_scale = float(env.get("powerScale", 1.0))
        ball = env["ball"]
        self.initial_speed_range = tuple(ball["initialSpeedRange"])
        self.tilt_angle_range = tuple(ball["tiltAngleRange"])
        super().__init__(cfg, seed=seed, device=device, switches=switches)
        tree = self.scene.articulations[0].model.tree
        self._motor_efforts = torch.as_tensor(np.concatenate([tree.effort, tree.effort]),
                                              dtype=torch.float32, device=self.device)
        self._init_root = torch.as_tensor(self.scene.initial_root, device=self.device)

    def create_scene(self) -> SceneSpec:
        return build_5actor_scene(self.cfg["sim"], native=self.switches.native)

    def rb_body_ids(self):
        # robot 1's paddle (39), robot 2's (40 + 39)
        return np.asarray([self.PADDLE_BODY, 40 + self.PADDLE_BODY])

    def action_to_drive(self, actions):
        """Effort drive (``:78-80``): actions x motor efforts x powerScale."""
        return torch.zeros_like(actions), actions * self._motor_efforts * self.power_scale

    def sample_ball_velocities(self, n):
        """Both balls' planar launches, each (n, 3) (``:82-94``): ball 1 at
        +U(speed) toward robot 2, ball 2 at -U(speed) toward robot 1, each
        at a tilt of U(tiltAngleRange) degrees about z. The parity tool
        replaces this hook to inject the JAX step's own launches."""
        u = torch.rand((4, n), generator=self.generator, device=self.device)
        lo, hi = self.initial_speed_range
        a_lo, a_hi = np.radians(self.tilt_angle_range[0]), np.radians(self.tilt_angle_range[1])
        s1 = lo + (hi - lo) * u[0]
        a1 = a_lo + (a_hi - a_lo) * u[1]
        s2 = -(lo + (hi - lo) * u[2])
        a2 = a_lo + (a_hi - a_lo) * u[3]
        z = torch.zeros_like(s1)
        return (torch.stack([s1 * torch.cos(a1), s1 * torch.sin(a1), z], dim=-1),
                torch.stack([s2 * torch.cos(a2), s2 * torch.sin(a2), z], dim=-1))

    def reset_sim(self, sim: SimState) -> SimState:
        """Initial roots with fresh launches for both balls, the DOF state
        zeroed (``:96-103``)."""
        B = sim.root.shape[0]
        root = self._init_root.expand(B, -1, -1).clone()
        v1, v2 = self.sample_ball_velocities(B)
        root[:, self.BALL1, 7:10] = v1
        root[:, self.BALL2, 7:10] = v2
        return sim._replace(root=root, dof_pos=torch.zeros_like(sim.dof_pos),
                            dof_vel=torch.zeros_like(sim.dof_vel))

    def observe(self, sim: SimState, rb_states, flags) -> torch.Tensor:
        """Global-frame paddle and ball positions and velocities
        (``:105-110``): [paddle 1, paddle 2, ball 1, ball 2] x (pos, vel)."""
        pick = lambda s: torch.cat([s[:, 0:3], s[:, 7:10]], dim=-1)
        return torch.cat([pick(rb_states[:, 0]), pick(rb_states[:, 1]),
                          pick(sim.root[:, self.BALL1]), pick(sim.root[:, self.BALL2])],
                         dim=-1)

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """Symmetric distance reward (``:112-122``) -> (reward, reset, flags)."""
        p1, p2 = rb_states[:, 0, 0:3], rb_states[:, 1, 0:3]
        b1, b2 = sim.root[:, self.BALL1, 0:3], sim.root[:, self.BALL2, 0:3]
        d1 = torch.sum((p1 - b2) ** 2, dim=-1)
        d2 = torch.sum((p2 - b1) ** 2, dim=-1)
        reward = 1.0 / (1.0 + d1) + 1.0 / (1.0 + d2)
        die = b1[:, 2] < 0.1
        reset = die | (progress >= self.max_episode_length - 1)
        return reward, reset, flags
