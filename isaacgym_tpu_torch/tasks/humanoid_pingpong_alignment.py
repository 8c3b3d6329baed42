"""HumanoidPingpongAlignmentG1 (C9), the alignment-reward variant, batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_alignment.py``: the
tilt scene (ball from (3.15, -0.28, 1.1) at 8.0-8.8 m/s, table and ball
restitution 1.5). Reward: dense inverse-square paddle distance, the
velocity-flip bonus (not one-shot), a one-shot hit-opponent-table reward
whose bounce is a flip in the sign of the ball's z-velocity
(``pre_ball_root[:, 9]`` below 0, now above), a one-shot overshoot penalty
past x = 3.1, a per-step miss penalty and the power cost; the one-shot
``reward_calculated`` flag latches on either. The episode ends early when
the ball drops below z = 0.1; reset restores the DOF state.

The hit reward never fires, as in the JAX package (``:55-60``) and the
reference it follows: it asks in the same step for x < 2.2 and for x in
(2.2, 3.1). The condition is kept as written.
"""

from __future__ import annotations

from typing import Dict

import torch

from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask


class HumanoidPingpongAlignment(PingpongFamilyTask):

    BALL_3D_LAUNCH = True
    RESTORE_DOF_ON_RESET = True

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        env = cfg["env"]
        env["numObservations"] = 80
        env["numActions"] = 7
        self.hit_table_reward = float(env["hitTableReward"])
        self.not_hit_table_penalty = float(env["nothitTablePenalty"])
        super().__init__(cfg, seed=seed, device=device, switches=switches)

    def init_flags(self) -> Dict[str, bool]:
        return {"reward_calculated": False}

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """``reward_single`` over the batch -> (reward, reset, flags)."""
        c = self._common_reward_inputs(pre_ball_root, sim, rb_states)
        ball_pos, vx = c["ball_pos"], c["ball_vx"]
        pre_vz = pre_ball_root[:, 9]
        vz = sim.root[:, self.ball_actor, 9]
        rew_calc = flags["reward_calculated"]
        zero = torch.zeros_like(vx)

        dist = torch.linalg.norm(c["paddle_pos"] - ball_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + 1.5 * dist * dist)

        condition = (c["pre_vx"] < 0.0) & (vx > 0.0)
        velocity_reward = torch.where(condition, self.alpha * torch.abs(vx), zero)

        in_table_range = (ball_pos[:, 0] > 2.2) & (ball_pos[:, 0] < 3.1)
        bounce_up = (pre_vz < 0.0) & (vz > 0.0)
        # never true together with in_table_range: the reference's latent bug
        no_bounce_before_half = (ball_pos[:, 0] < 2.2) & ~bounce_up
        good = in_table_range & bounce_up & no_bounce_before_half & ~rew_calc
        hit_reward = torch.where(good, zero + self.hit_table_reward, zero)
        rew_calc = rew_calc | (in_table_range & bounce_up & no_bounce_before_half)

        over = (ball_pos[:, 0] >= 3.1) & (vx > 0.0) & ~rew_calc
        hit_reward = torch.where(over, zero + self.not_hit_table_penalty, hit_reward)
        rew_calc = rew_calc | (ball_pos[:, 0] >= 3.1)

        reward = pos_reward + c["power_reward"] + velocity_reward + hit_reward
        missed_ball = ball_pos[:, 0] < c["humanoid_x"] - 0.05
        reward = torch.where(missed_ball, reward + self.penalty, reward)

        die = ball_pos[:, 2] < 0.1
        reset = die | (progress >= self.max_episode_length - 1)
        return reward, reset, {"reward_calculated": rew_calc}
