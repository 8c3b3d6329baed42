"""Humanoid12PingpongTiltG1 (C8), the two-humanoid scene, batched.

Counterpart of ``isaacgym_tpu/tasks/humanoid_pingpong_4actor_tilt.py``: two
fixed-base 7-DOF G1s facing each other (the second at ``humanoid2Pos``, yaw
180 deg), table and ball: 4 actors, 14 DOFs, act 14, stepped by K3. The
observation is humanoid 1's 94 values (30 + 30 + 14 + 14 + 3 + 3: both
humanoids' DOFs), not the reference's declared 80, as in the JAX package.
Only humanoid 1's C6 reward is wired.

With ``env.twoPlayer: true`` the obs is 188, both humanoids' perspectives
(``rb_body_ids`` adds humanoid 2's bodies), and the reward adds humanoid 2's
C6 reward through the table-centre mirror x' = 2 tablePos.x - x, with its
own ``*2`` flags; the power term is counted once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from isaacgym_tpu_torch.sim.simulator import SimState
from isaacgym_tpu_torch.tasks import pingpong_common as P
from isaacgym_tpu_torch.tasks.base import PingpongFamilyTask
from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt import HumanoidPingpongTilt


class Humanoid12PingpongTilt(HumanoidPingpongTilt):

    HUMANOIDS = 2

    def __init__(self, cfg, seed: int = 42, device="cuda", switches=None):
        env = cfg["env"]
        self.two_player = bool(env.get("twoPlayer", False))
        env["numObservations"] = 188 if self.two_player else 94
        env["numActions"] = 14
        # the JAX task skips C6's __init__ too, so landingShapingWeight is
        # never read here
        self.hit_table_reward = float(env["hitTableReward"])
        self.not_hit_table_penalty = float(env["nothitTablePenalty"])
        self._mirror_2cx = 2.0 * float(env["scene"]["tablePos"][0])
        PingpongFamilyTask.__init__(self, cfg, seed=seed, device=device, switches=switches)
        if self.two_player:
            self.event_flag_names = dict(HumanoidPingpongTilt.event_flag_names,
                                         condition_calculated2="hit_paddle2",
                                         hit_table_good2="hit_opponent_table2",
                                         crossed_net2="cross_net2")

    def rb_body_ids(self):
        ids = self.body_states_id
        if not self.two_player:
            return ids
        # second block of rows: the same bodies of humanoid 2
        return np.concatenate([ids, ids + self.scene.articulations[1].body_start])

    def init_flags(self) -> Dict[str, bool]:
        flags = super().init_flags()
        if self.two_player:
            flags.update(condition_calculated2=False, reward_calculated2=False,
                         no_bounce_before_half_mask2=True, hit_table_good2=False,
                         crossed_net2=False)
        return flags

    def observe(self, sim: SimState, rb_states, flags) -> torch.Tensor:
        if not self.two_player:
            return super().observe(sim, rb_states, flags)
        n = len(self.body_states_id)
        ball = sim.root[:, self.ball_actor]

        def perspective(rows):
            return torch.cat([P.compute_humanoid_observations(rows, sim.dof_pos, sim.dof_vel),
                              P.compute_pingpong_observations(rows, ball)], dim=-1)

        return torch.cat([perspective(rb_states[:, :n]), perspective(rb_states[:, n:2 * n])],
                         dim=-1)

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        if not self.two_player:
            return super().reward(pre_ball_root, sim, rb_states, flags, progress)
        n = len(self.body_states_id)
        c1 = self._common_reward_inputs(pre_ball_root, sim, rb_states)
        r1, cc1, rc1, nb1, ev1 = self._tilt_reward_core(
            c1, flags["condition_calculated"], flags["reward_calculated"],
            flags["no_bounce_before_half_mask"])

        # humanoid 2 through the mirror x -> 2 cx - x, vx -> -vx
        ball = sim.root[:, self.ball_actor]
        paddle2 = rb_states[:, n + self._paddle_row]
        m = self._mirror_2cx
        c2 = dict(paddle_pos=torch.stack([m - paddle2[:, 0], paddle2[:, 1], paddle2[:, 2]], -1),
                  ball_pos=torch.stack([m - ball[:, 0], ball[:, 1], ball[:, 2]], -1),
                  ball_vx=-ball[:, 7], pre_vx=-pre_ball_root[:, 7],
                  humanoid_x=m - sim.root[:, 1, 0])
        r2, cc2, rc2, nb2, ev2 = self._tilt_reward_core(
            c2, flags["condition_calculated2"], flags["reward_calculated2"],
            flags["no_bounce_before_half_mask2"])

        # one controller drives both arms: the power cost counts once
        reward = r1 + r2 + c1["power_reward"]
        die = c1["ball_pos"][:, 2] < 0.1
        reset = die | (progress >= self.max_episode_length - 1)
        return reward, reset, {
            "condition_calculated": cc1, "reward_calculated": rc1,
            "no_bounce_before_half_mask": nb1,
            "hit_table_good": flags["hit_table_good"] | ev1["good"],
            "crossed_net": flags["crossed_net"] | ev1["over_net"],
            "condition_calculated2": cc2, "reward_calculated2": rc2,
            "no_bounce_before_half_mask2": nb2,
            "hit_table_good2": flags["hit_table_good2"] | ev2["good"],
            "crossed_net2": flags["crossed_net2"] | ev2["over_net"],
        }
