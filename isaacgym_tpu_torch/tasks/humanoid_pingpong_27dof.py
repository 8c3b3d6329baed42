"""HumanoidPingpongTiltNESSparse27DOFG1 (C10), batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_27dof.py``: the
whole-body 27-DOF G1 on a floating base, balancing on its feet (K4), with
the table and the ball; act 27, obs 313 = humanoid 114 (10 bodies: 30 + 30,
dof 27 + 27) + ball 7 (heading-local position and velocity and the predicted
y-intercept at the robot plane, the reference's unclamped formula kept
verbatim) + imitation 192 against the standing pose (23 balance bodies:
69 + 69, and 27 + 27 zero DOF targets).

Reward: the tiered balance/imitation reward against the standing pose (the
first 22, non-right-arm DOFs weighted x50; -50 once the mean body deviation
passes 0.32 m in training), the paddle-plane circle (r 0.15 m, first
x-approach only), the one-shot hit bonus (vx > 1.5), a time penalty while
the ball comes in, the gradient table-landing reward (z in [0.82, 0.83]:
constant inside x in [1.9, 3.1], |y| <= 0.6, else proportional to the
distance from (2.5, 0)), the net crossing with a height-graded penalty, the
one-shot ball-drop penalty (z < 0.78), the humanoid-fall latch (pelvis below
``pelvisHeightThreshold``) and the power cost. No early termination: the
episode ends at ``episodeLength - 1``. The diagnostic ``*_count`` flags are
surfaced per finished episode in ``info["episode_events"]``. A reset puts
the ball at a random start y and z and restores the DOF state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from isaacgym_tpu_torch.models.kinematics import fk_body_states
from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks import pingpong_common as P
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask
from isaacgym_tpu_torch.utils import rotations as rot


class HumanoidPingpongTiltNESSparse27DOF(PingpongFamilyTask):

    RESTORE_DOF_ON_RESET = True
    BALL_START_YZ = True

    def __init__(self, cfg, seed: int = 42, device="cuda"):
        env = cfg["env"]
        env["numObservations"] = 121 + 192
        env["numActions"] = 27
        env.setdefault("bodyStatesId", env["bodyStatesIdPingpong"])
        env.setdefault("penalty", 0.0)   # a base-class field this task does not use
        self.hit_table_reward = float(env["hitTableReward"])
        self.not_hit_table_penalty = float(env["nothitTablePenalty"])
        self.cross_net_reward_float = float(env["crossNetRewardFloat"])
        self.die_penalty_float = float(env["diePenaltyFloat"])
        self.hit_paddle_reward = float(env["hitPaddleReward"])
        self.miss_paddle_penalty_coefficient = float(env["missPaddlePenaltyCoefficient"])
        self.pelvis_height_threshold = float(env.get("pelvisHeightThreshold", 0.78))
        self.is_train = not bool(env.get("test", False))
        balance = np.asarray(env["bodyStatesIdBalance"], dtype=np.int64)
        pingpong = np.asarray(env["bodyStatesIdPingpong"], dtype=np.int64)
        # the body-state rows are the union of what obs and reward read
        self._all_ids = np.unique(np.concatenate([pingpong, balance]))
        self._ping_rows = torch.as_tensor(np.searchsorted(self._all_ids, pingpong))
        self._bal_rows = torch.as_tensor(np.searchsorted(self._all_ids, balance))
        self._pelvis_row = int(np.searchsorted(self._all_ids, 0))
        super().__init__(cfg, seed=seed, device=device)
        self._paddle_row = int(np.searchsorted(self._all_ids, self.PADDLE_BODY))
        self._ping_rows = self._ping_rows.to(self.device)
        self._bal_rows = self._bal_rows.to(self.device)

        # the standing pose's body states (FK at the spawn pose): the
        # imitation target
        tree = self.scene.articulations[0].model.tree
        init = self._init_root[0:1]
        zeros = torch.zeros((1, tree.n_dof), device=self.device)
        states = fk_body_states(tree, init[:, 0:3], init[:, 3:7], zeros, zeros,
                                body_ids=self._all_ids)
        self._ref_bal = states[0, self._bal_rows]          # (23, 13)
        self._initial_dof_pos = torch.zeros(27, device=self.device)
        self._initial_dof_vel = torch.zeros(27, device=self.device)

    def create_scene(self):
        return P.build_pingpong_scene(self.cfg["env"], self.cfg["sim"], humanoids=1,
                                      floating_base=True)

    def rb_body_ids(self):
        return self._all_ids

    def init_flags(self) -> Dict[str, bool]:
        return {"paddle_condition_calculated": False, "hit_table_calculated": False,
                "die_penalty_calculated": False, "humanoid_die_calculated": False,
                "closer_to_paddle_count": False, "hit_paddle_count": False,
                "cross_net_count": False, "hit_table_count": False,
                "fall_down_count": False}

    def observe(self, sim: SimState, rb_states, flags) -> torch.Tensor:
        B = rb_states.shape[0]
        ping = rb_states[:, self._ping_rows]
        hum = P.compute_humanoid_observations(ping, sim.dof_pos, sim.dof_vel)
        # ball obs and the predicted y-intercept at the robot plane
        heading_inv = rot.calc_heading_quat_inv(ping[:, 0, 3:7])
        ball = sim.root[:, self.ball_actor]
        lp = rot.quat_rotate(heading_inv, ball[:, 0:3] - ping[:, 0, 0:3])
        lv = rot.quat_rotate(heading_inv, ball[:, 7:10])
        y_int = lp[:, 1] + (lv[:, 1] / (-lv[:, 0] + 1e-6)) * lp[:, 0]
        # imitation obs against the standing pose
        bal = rb_states[:, self._bal_rows]
        h = heading_inv[:, None].expand(B, bal.shape[1], 4)
        d_lp = rot.quat_rotate(h, self._ref_bal[:, 0:3] - bal[..., 0:3]).reshape(B, -1) * 10.0
        d_lv = rot.quat_rotate(h, self._ref_bal[:, 7:10] - bal[..., 7:10]).reshape(B, -1)
        dof0 = self._initial_dof_pos.expand(B, -1)
        vel0 = self._initial_dof_vel.expand(B, -1)
        return torch.cat([hum, lp, lv, y_int[:, None], d_lp, d_lv, dof0, vel0], dim=-1)

    def _imitation_reward(self, sim: SimState, rb_states):
        """The reference's ``compute_imitation_reward``, G1 path: (reward,
        has_fallen)."""
        k_pos, k_vel, k_dof_pos, k_dof_vel = 50.0, 4.0, 5.0, 0.05
        w_pos, w_vel, w_dof_pos, w_dof_vel = 0.4, 0.2, 0.2, 0.2
        bal = rb_states[:, self._bal_rows]
        ref = self._ref_bal
        r_body_pos = torch.exp(-k_pos * ((ref[:, 0:3] - bal[..., 0:3]) ** 2).mean(dim=(1, 2)))
        r_body_vel = torch.exp(-k_vel * ((ref[:, 7:10] - bal[..., 7:10]) ** 2).mean(dim=(1, 2)))
        diff_dof = (self._initial_dof_pos - sim.dof_pos) ** 2
        # tiered: the first 22 (non-right-arm) DOFs x50 weight, x500 sharpness
        r_first = torch.exp(-(k_dof_pos * 500.0) * diff_dof[:, :22].mean(-1))
        r_last = torch.exp(-k_dof_pos * diff_dof[:, 22:].mean(-1))
        dof_pos_reward = (w_dof_pos * 50.0) * r_first + w_dof_pos * r_last
        diff_dvel = ((self._initial_dof_vel[:22] - sim.dof_vel[:, :22]) ** 2).mean(-1)
        r_dof_vel = torch.exp(-k_dof_vel * diff_dvel)
        reward = (dof_pos_reward + w_dof_vel * r_dof_vel + w_pos * r_body_pos
                  + w_vel * r_body_vel)
        term_dist = 0.32 if self.is_train else 1e6
        has_fallen = torch.linalg.norm(bal[..., 0:3] - ref[:, 0:3], dim=-1).mean(-1) > term_dist
        return torch.where(has_fallen, torch.full_like(reward, -50.0), reward), has_fallen

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        """``reward_single`` (``:185``) over the batch -> (reward, reset, flags)."""
        f = dict(flags)
        paddle = rb_states[:, self._paddle_row]
        pelvis = rb_states[:, self._pelvis_row]
        ball = sim.root[:, self.ball_actor]
        bx, by, bz, vx = ball[:, 0], ball[:, 1], ball[:, 2], ball[:, 7]
        zero = torch.zeros_like(vx)
        alive = ~f["humanoid_die_calculated"]

        ref_reward, has_fallen = self._imitation_reward(sim, rb_states)
        f["fall_down_count"] = f["fall_down_count"] | has_fallen

        # the paddle-plane circle (first x-approach only)
        x_close = torch.abs(bx - paddle[:, 0]) < 0.2
        first_time_close = x_close & ~f["paddle_condition_calculated"]
        yz_dist = torch.sqrt((by - paddle[:, 1]) ** 2 + (bz - paddle[:, 2]) ** 2)
        in_circle = yz_dist < 0.15
        pos_reward = torch.where(
            first_time_close & alive,
            torch.where(in_circle, zero + self.hit_paddle_reward,
                        self.miss_paddle_penalty_coefficient * yz_dist), zero)
        f["closer_to_paddle_count"] = f["closer_to_paddle_count"] | (first_time_close & in_circle)

        # the one-shot hit bonus, vx > 1.5
        hit_the_paddle = (pre_ball_root[:, 7] < 0.0) & (vx > 1.5)
        f["hit_paddle_count"] = f["hit_paddle_count"] | hit_the_paddle
        velocity_reward = torch.where(
            hit_the_paddle & ~f["paddle_condition_calculated"] & alive,
            self.alpha * torch.abs(vx), zero)
        f["paddle_condition_calculated"] = f["paddle_condition_calculated"] | x_close

        # a time penalty while the ball comes in
        time_penalty = torch.where((bx > sim.root[:, 0, 0]) & (vx < 0.0),
                                   -0.01 * progress.to(vx.dtype), zero)

        # the gradient table-landing reward
        z_in_range = (bz >= 0.82) & (bz <= 0.83) & (vx > 0.0)
        in_square = (bx >= 1.9) & (bx <= 3.1) & (torch.abs(by) <= 0.6)
        distance = torch.sqrt((bx - 2.5) ** 2 + by ** 2)
        f["hit_table_count"] = f["hit_table_count"] | (z_in_range & in_square)
        hit_reward = torch.where(
            z_in_range & ~f["hit_table_calculated"] & alive,
            torch.where(in_square, zero + self.hit_table_reward,
                        self.not_hit_table_penalty * distance), zero)
        f["hit_table_calculated"] = f["hit_table_calculated"] | z_in_range

        # the net crossing with a height-graded penalty
        when_over_net = (bx > 1.72) & (bx < 1.78) & (vx > 0.0)
        suitable = (bz > 0.96) & (bz < 1.25)
        over_height = torch.where(bz > 1.25, bz - 1.25, 0.96 - bz)
        net_reward = torch.where(
            when_over_net & alive,
            torch.where(suitable, zero + self.cross_net_reward_float, -400.0 * over_height),
            zero)
        f["cross_net_count"] = f["cross_net_count"] | (net_reward > 0)

        power = torch.sum(torch.abs(sim.dof_force * sim.dof_vel), dim=-1)
        power_reward = -self.power_coefficient * power

        # the one-shot ball-drop penalty, z < 0.78, no reset
        dropped = bz < 0.78
        die_penalty = torch.where(dropped & ~f["die_penalty_calculated"] & alive,
                                  zero + self.die_penalty_float, zero)
        f["die_penalty_calculated"] = f["die_penalty_calculated"] | dropped

        # the humanoid-fall latch
        f["humanoid_die_calculated"] = (f["humanoid_die_calculated"]
                                        | (pelvis[:, 2] < self.pelvis_height_threshold))

        reward = (pos_reward + power_reward + velocity_reward + hit_reward + net_reward
                  + die_penalty + time_penalty + ref_reward)
        reset = progress >= self.max_episode_length - 1
        return reward, reset, f
