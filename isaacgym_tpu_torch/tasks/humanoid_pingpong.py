"""HumanoidPingpongG1 (C5), the original 3-actor task, batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong.py``: the 7-DOF G1
yawed -30 deg, a table and a ball launched in the x-y plane (vz = 0) from
(3.1, -0.3, 1.3) at 6.5-7.5 m/s, table restitution 0.7 and ball 0.9,
dt 0.0166 with 2 substeps, episodes of 64 steps. Reward: dense
inverse-square paddle-ball distance, the velocity-flip bonus alpha * |vx|
(every step the ball turns, not one-shot) and the power cost; the miss
penalty while the ball is behind the paddle. The episode ends early on a
miss or when the ball drops below z = 0.1; reset restores the DOF state.
"""

from __future__ import annotations

import torch

from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask


class HumanoidPingpong(PingpongFamilyTask):

    BALL_3D_LAUNCH = False
    RESTORE_DOF_ON_RESET = True

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        cfg["env"]["numObservations"] = 80
        cfg["env"]["numActions"] = 7
        super().__init__(cfg, seed=seed, device=device, switches=switches)

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """``reward_single`` over the batch -> (reward, reset, flags)."""
        c = self._common_reward_inputs(pre_ball_root, sim, rb_states)
        paddle_pos, ball_pos, vx = c["paddle_pos"], c["ball_pos"], c["ball_vx"]
        zero = torch.zeros_like(vx)

        dist = torch.linalg.norm(paddle_pos - ball_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + 1.5 * dist * dist)

        hit = (c["pre_vx"] < 0.0) & (vx > 0.0)
        velocity_reward = torch.where(hit, self.alpha * torch.abs(vx), zero)

        reward = pos_reward + c["power_reward"] + velocity_reward

        missed_ball = ball_pos[:, 0] < paddle_pos[:, 0] - 1e-3
        reward = torch.where(missed_ball, reward + self.penalty, reward)

        die = missed_ball | (ball_pos[:, 2] < 0.1)
        reset = die | (progress >= self.max_episode_length - 1)
        return reward, reset, flags
