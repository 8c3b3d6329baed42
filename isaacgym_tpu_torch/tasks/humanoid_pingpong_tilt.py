"""HumanoidPingpongTiltG1 (C6), batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_tilt.py``: the
flagship's scene (fixed-base 7-DOF G1, table, ball; obs 80, act 7) with the
reference's table-event reward ``compute_pingpong_reward_nv``: dense
inverse-square paddle distance, a one-shot velocity-flip bonus, a per-step
miss penalty, a one-shot hit-opponent-table reward with short-bounce and
overshoot penalties (bounce: z < 0.83, vx > 0, |y| < 0.6), +400 a step in
the cross-net window x in (1.7, 1.8), |y| < 0.4, z in (0.98, 1.14), and the
curriculum-only ``landingShapingWeight`` (0 = the reference reward). The
episode ends early when the ball drops below z = 0.1; reset restores the
DOF state.
"""

from __future__ import annotations

from typing import Dict

import torch

from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask


class HumanoidPingpongTilt(PingpongFamilyTask):

    RESTORE_DOF_ON_RESET = True
    # ``hit_table_good`` and ``crossed_net`` are telemetry-only latches of the
    # one-shot good bounce and the net window (``reward_calculated`` also
    # latches on the penalties)
    event_flag_names = {"condition_calculated": "hit_paddle",
                        "hit_table_good": "hit_opponent_table",
                        "crossed_net": "cross_net"}

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        env = cfg["env"]
        env["numObservations"] = 80
        env["numActions"] = 7
        self.hit_table_reward = float(env["hitTableReward"])
        self.not_hit_table_penalty = float(env["nothitTablePenalty"])
        self.landing_shaping_weight = float(env.get("landingShapingWeight", 0.0))
        super().__init__(cfg, seed=seed, device=device, switches=switches)

    def init_flags(self) -> Dict[str, bool]:
        return {"condition_calculated": False, "reward_calculated": False,
                "no_bounce_before_half_mask": True, "hit_table_good": False,
                "crossed_net": False}

    def _tilt_reward_core(self, c, cond_calc, rew_calc, no_bounce):
        """The C6 reward state machine minus the power term (``:57-132``) on
        one humanoid's inputs ``c``, batched. C8 evaluates its second
        humanoid through the table-centre mirror with it. Returns (reward,
        cond_calc, rew_calc, no_bounce, events), ``events`` the telemetry
        of this step: ``good`` (one-shot good table hit), ``over_net``."""
        ball_pos, vx = c["ball_pos"], c["ball_vx"]
        rew_calc_0 = rew_calc
        zero = torch.zeros_like(vx)

        dist = torch.linalg.norm(c["paddle_pos"] - ball_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + 1.5 * dist * dist)

        condition = (c["pre_vx"] < 0.0) & (vx > 0.0)
        velocity_reward = torch.where(condition & ~cond_calc, self.alpha * torch.abs(vx), zero)
        cond_calc = cond_calc | condition

        missed_ball = ball_pos[:, 0] < c["humanoid_x"] - 0.05
        reward = torch.where(missed_ball, zero + self.penalty, zero)

        bounce_up = (ball_pos[:, 2] < 0.83) & (vx > 0.0) & (torch.abs(ball_pos[:, 1]) < 0.6)

        # short bounce (own half, x < 2.44): one-shot penalty
        short = (ball_pos[:, 0] < 2.44) & bounce_up
        hit_reward = torch.where(short & ~rew_calc, zero + self.not_hit_table_penalty, zero)
        rew_calc = rew_calc | short
        no_bounce = no_bounce & ~short

        # opponent half (2.44-3.1): one-shot reward on the first bounce
        in_range = (ball_pos[:, 0] > 2.44) & (ball_pos[:, 0] < 3.1)
        good = in_range & bounce_up & no_bounce & ~rew_calc
        hit_reward = torch.where(good, zero + self.hit_table_reward, hit_reward)
        rew_calc = rew_calc | (in_range & bounce_up & no_bounce)

        # overshoot (x >= 3.1 still moving away): one-shot penalty
        over = (ball_pos[:, 0] >= 3.1) & (vx > 0.0) & ~rew_calc
        hit_reward = torch.where(over, zero + self.not_hit_table_penalty, hit_reward)
        rew_calc = rew_calc | (ball_pos[:, 0] >= 3.1)

        # cross-net reward, +400 per step inside the window
        over_net = ((ball_pos[:, 0] > 1.7) & (ball_pos[:, 0] < 1.8) & (vx > 0.0)
                    & (torch.abs(ball_pos[:, 1]) < 0.4)
                    & (ball_pos[:, 2] > 0.98) & (ball_pos[:, 2] < 1.14))
        cross_net_reward = torch.where(over_net, zero + 400.0, zero)

        reward = reward + pos_reward + velocity_reward + hit_reward + cross_net_reward

        # curriculum-only landing shaping: once, when the landing machine
        # latches, a gaussian on the ballistic landing point. C8 never sets
        # the weight (its __init__ skips this class's), as in the JAX package.
        w = getattr(self, "landing_shaping_weight", 0.0)
        if w and c.get("ball_vel") is not None:
            v = c["ball_vel"]
            grav = 9.81
            dz = torch.clamp(ball_pos[:, 2] - 0.83, min=0.0)
            t_fall = torch.where(
                ball_pos[:, 2] > 0.83,
                (v[:, 2] + torch.sqrt(v[:, 2] * v[:, 2] + 2.0 * grav * dz)) / grav, zero)
            x_land = ball_pos[:, 0] + v[:, 0] * t_fall
            y_land = ball_pos[:, 1] + v[:, 1] * t_fall
            shaping = w * torch.exp(-((x_land - 2.77) ** 2 + y_land ** 2))
            first_landing = rew_calc & ~rew_calc_0
            reward = reward + torch.where(first_landing, shaping, zero)

        return reward, cond_calc, rew_calc, no_bounce, {"good": good, "over_net": over_net}

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """``reward_single`` (``:134``) over the batch -> (reward, reset, flags)."""
        c = self._common_reward_inputs(pre_ball_root, sim, rb_states)
        reward, cond_calc, rew_calc, no_bounce, ev = self._tilt_reward_core(
            c, flags["condition_calculated"], flags["reward_calculated"],
            flags["no_bounce_before_half_mask"])
        reward = reward + c["power_reward"]
        die = c["ball_pos"][:, 2] < 0.1
        reset = die | (progress >= self.max_episode_length - 1)
        return reward, reset, {
            "condition_calculated": cond_calc,
            "reward_calculated": rew_calc,
            "no_bounce_before_half_mask": no_bounce,
            "hit_table_good": flags["hit_table_good"] | ev["good"],
            "crossed_net": flags["crossed_net"] | ev["over_net"],
        }
