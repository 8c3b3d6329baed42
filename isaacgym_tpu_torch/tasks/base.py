"""Shared base of the pingpong task family (``isaacgym_tpu/tasks/base.py``):
the 3- or 4-actor scene, the randomized ball launch at reset, heading-local
observations and PD position drive over the right-arm DOFs."""

from __future__ import annotations

import numpy as np
import torch

from isaacgym_tpu_torch.env.vec_task import TorchVecTask
from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks import pingpong_common as P


class PingpongFamilyTask(TorchVecTask):
    """Common machinery; subclasses supply the reward and constants."""

    HUMANOIDS = 1
    PADDLE_BODY = 39             # paddle body index within a humanoid
    RESTORE_DOF_ON_RESET = True  # False: the flagship keeps the pose

    def __init__(self, cfg, seed: int = 42, device="cuda"):
        env = cfg["env"]
        self.alpha = float(env["alphaVelocityReward"])
        self.power_coefficient = float(env["powerCoefficient"])
        self.penalty = float(env["penalty"])
        ball = env["ball"]
        self.initial_speed_range = tuple(ball["initialSpeedRange"])
        self.tilt_angle_range = tuple(ball["tiltAngleRange"])
        self.tilt_z_angle_range = tuple(ball.get("tiltZAngleRange", (0.0, 0.0)))
        self.body_states_id = np.asarray(env["bodyStatesId"], dtype=np.int64)
        self._paddle_row = int(np.nonzero(self.body_states_id == self.PADDLE_BODY)[0][0])
        self.ball_actor = self.HUMANOIDS + 1   # [h1(, h2), table, ball]
        self.table_actor = self.HUMANOIDS
        super().__init__(cfg, seed=seed, device=device)
        self._init_root = torch.as_tensor(self.scene.initial_root, device=self.device)

    def create_scene(self):
        return P.build_pingpong_scene(self.cfg["env"], self.cfg["sim"],
                                      humanoids=self.HUMANOIDS)

    def rb_body_ids(self):
        return self.body_states_id

    def sample_ball_velocity(self, n):
        return P.sample_ball_velocity(n, self.initial_speed_range, self.tilt_angle_range,
                                      self.tilt_z_angle_range, self.generator, self.device)

    def reset_sim(self, sim: SimState) -> SimState:
        """Root states to initial + a fresh ball launch for every env."""
        B = sim.root.shape[0]
        root = self._init_root.expand(B, -1, -1).clone()
        root[:, self.ball_actor, 7:10] = self.sample_ball_velocity(B)
        out = sim._replace(root=root)
        if self.RESTORE_DOF_ON_RESET:
            out = out._replace(dof_pos=torch.zeros_like(sim.dof_pos),
                               dof_vel=torch.zeros_like(sim.dof_vel))
        return out

    def observe(self, sim: SimState, rb_states, flags) -> torch.Tensor:
        hum = P.compute_humanoid_observations(rb_states, sim.dof_pos, sim.dof_vel)
        ball = P.compute_pingpong_observations(rb_states, sim.root[:, self.ball_actor])
        return torch.cat([hum, ball], dim=-1)

    def _common_reward_inputs(self, pre_ball_root, sim: SimState, rb_states):
        ball = sim.root[:, self.ball_actor]
        power = torch.sum(torch.abs(sim.dof_force * sim.dof_vel), dim=-1)
        return dict(paddle_pos=rb_states[:, self._paddle_row, 0:3],
                    ball_pos=ball[:, 0:3], ball_vx=ball[:, 7], ball_vel=ball[:, 7:10],
                    pre_vx=pre_ball_root[:, 7], humanoid_x=sim.root[:, 0, 0],
                    power_reward=-self.power_coefficient * power)
