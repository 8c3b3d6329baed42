"""HumanoidPingpongTiltNoEarlyStopG1, the flagship task (C7), batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_tilt_no_earlystop.py``:
fixed-base 7-DOF G1 + table + ball, obs 80, act 7, the Gauss y-z paddle
alignment reward with one-shot hit/miss events and no early termination (a
dropped ball costs -800; episodes end only at ``episodeLength``). Reset
restores the roots with a fresh ball launch and keeps the DOF state.
"""

from __future__ import annotations

from typing import Dict

import torch

from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask


class HumanoidPingpongTiltNoEarlyStop(PingpongFamilyTask):

    RESTORE_DOF_ON_RESET = False
    event_flag_names = {"paddle_condition_calculated": "hit_paddle",
                        "missed_ball_calculated": "missed_ball"}

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        cfg["env"]["numObservations"] = 80   # 30+30+7+7+3+3
        cfg["env"]["numActions"] = 7
        super().__init__(cfg, seed=seed, device=device, switches=switches)

    def init_flags(self) -> Dict[str, bool]:
        return {"paddle_condition_calculated": False, "missed_ball_calculated": False}

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """``reward_single`` (``:45``) over the batch -> (reward, reset, flags)."""
        c = self._common_reward_inputs(pre_ball_root, sim, rb_states)
        paddle_pos, ball_pos, vx = c["paddle_pos"], c["ball_pos"], c["ball_vx"]
        paddle_calc = flags["paddle_condition_calculated"]
        missed_calc = flags["missed_ball_calculated"]
        zero = torch.zeros_like(vx)

        hit_the_paddle = (c["pre_vx"] < 0.0) & (vx > 1.0)
        missed_ball = ((ball_pos[:, 0] < c["humanoid_x"] - 0.05)
                       | (ball_pos[:, 0] < paddle_pos[:, 0] - 0.1))
        reward = torch.where(~missed_calc & missed_ball, zero + self.penalty, zero)
        missed_calc = missed_calc | missed_ball

        dist = torch.sqrt((paddle_pos[:, 1] - ball_pos[:, 1]) ** 2
                          + (paddle_pos[:, 2] - ball_pos[:, 2]) ** 2)
        pos_reward = torch.where((~paddle_calc) | (ball_pos[:, 0] < c["humanoid_x"] - 0.05),
                                 torch.exp(-20.0 * dist * dist), zero)
        velocity_reward = torch.where(hit_the_paddle & ~paddle_calc,
                                      self.alpha * torch.abs(vx), zero)
        paddle_calc = paddle_calc | hit_the_paddle

        reward = reward + pos_reward + c["power_reward"] + velocity_reward
        reward = torch.where(ball_pos[:, 2] < 0.1, reward - 800.0, reward)
        reset = progress >= self.max_episode_length - 1
        return reward, reset, {"paddle_condition_calculated": paddle_calc,
                               "missed_ball_calculated": missed_calc}
