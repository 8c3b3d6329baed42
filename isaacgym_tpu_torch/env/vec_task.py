"""Vectorized-task base: the env step with its branch-free auto-reset.

Counterpart of ``isaacgym_tpu/env/vec_task.py`` (``EnvState``, ``reset``,
``_step_impl`` at ``:205-290``): action clip -> PD targets -> physics ->
body states -> reward -> auto-reset (every env's would-be reset state,
merged with ``torch.where``, no host sync) -> observation. With
``task.randomize: true`` the step adds action noise before the clip, runs
``Simulator.step`` with the state's per-env ``DRParams`` (K2-dr), re-samples
them for resetting envs whose counter passed ``frequency``, adds observation
noise and advances ``global_step`` (the DR schedules' clock) once per step.
The JAX package's per-env PRNG keys become one ``torch.Generator`` on the
env's device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isaacgym_tpu_torch.env.randomize import DomainRandomizer, DRParams
from isaacgym_tpu_torch.sim.scene import SceneSpec, compile_scene
from isaacgym_tpu_torch.sim.simulator import (
    FLOATING_DR_REFUSAL, MULTI_DR_REFUSAL, SimState, Simulator,
)


class EnvState(NamedTuple):
    sim: SimState                  # batched (B, ...)
    progress: torch.Tensor         # (B,) int32
    flags: Dict[str, torch.Tensor]  # task one-shot flags, each (B,) bool
    pre_ball_root: torch.Tensor    # (B, 13) ball root before the last physics step
    ep_return: torch.Tensor        # (B,) running episode return
    dr: Optional[DRParams] = None  # batched DRParams when DR is on
    randomize_buf: Optional[torch.Tensor] = None  # (B,) int32 steps since re-sampling
    global_step: Optional[torch.Tensor] = None    # () int32, drives the DR schedules


def _merge(do, a, b):
    return torch.where(do.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


class TorchVecTask:
    """Base class of the pingpong task family; subclasses supply the scene,
    the reset, the observation and the reward, all batched."""

    #: root slot of the ball, set by the subclass before ``__init__``
    ball_actor: int
    #: flag -> event name surfaced per episode in ``info["episode_events"]``
    event_flag_names: Optional[Dict[str, str]] = None

    def __init__(self, cfg: Dict[str, Any], seed: int = 42, device="cuda"):
        self.cfg = cfg
        env_cfg = cfg["env"]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for but no CUDA device is available")
        self.num_envs = int(env_cfg["numEnvs"])
        self.num_obs = int(env_cfg["numObservations"])
        self.num_actions = int(env_cfg["numActions"])
        self.max_episode_length = int(env_cfg["episodeLength"])
        self.clip_actions = float(env_cfg.get("clipActions", 1.0))
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

        self.scene_spec: SceneSpec = self.create_scene()
        self.scene = compile_scene(self.scene_spec)
        self.sim = Simulator(self.scene, device=self.device)

        # domain randomization: spec-driven, off by default
        task_cfg = cfg.get("task", {}) or {}
        self.randomize = bool(task_cfg.get("randomize", False))
        if self.randomize and self.sim.fused_substep_multi is not None:
            raise NotImplementedError(MULTI_DR_REFUSAL)
        if self.randomize and self.sim.fused_substep_floating is not None:
            raise NotImplementedError(FLOATING_DR_REFUSAL)
        self.randomizer = (DomainRandomizer(task_cfg.get("randomization_params", {}),
                                            self.scene.num_dofs)
                           if self.randomize else None)

        lo, hi = self._action_dof_limits()
        self._pd_action_offset = torch.as_tensor(0.5 * (hi + lo), dtype=torch.float32,
                                                 device=self.device)
        self._pd_action_scale = torch.as_tensor(0.5 * (hi - lo), dtype=torch.float32,
                                                device=self.device)
        self._rb_fn = self.sim.make_body_state_fn(self.rb_body_ids())

    # -- subclass hooks (batched) -------------------------------------------

    def create_scene(self) -> SceneSpec:
        raise NotImplementedError

    def init_flags(self) -> Dict[str, bool]:
        return {}

    def rb_body_ids(self):
        raise NotImplementedError

    def reset_sim(self, sim: SimState) -> SimState:
        raise NotImplementedError

    def observe(self, sim: SimState, rb_states, flags) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, pre_ball_root, sim: SimState, rb_states, flags, progress):
        raise NotImplementedError

    def _action_dof_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        los = [s.model.tree.lower for s in self.scene.articulations]
        his = [s.model.tree.upper for s in self.scene.articulations]
        return np.concatenate(los), np.concatenate(his)

    # -- public API ------------------------------------------------------------

    def _flags0(self, B):
        return {k: torch.full((B,), bool(v), device=self.device)
                for k, v in self.init_flags().items()}

    def reset(self) -> Tuple[EnvState, torch.Tensor]:
        """Fresh env state + initial observations."""
        B = self.num_envs
        sim = self.reset_sim(self.sim.initial_state(B))
        flags = self._flags0(B)
        dr = randomize_buf = global_step = None
        if self.randomize:
            global_step = torch.zeros((), dtype=torch.int32, device=self.device)
            dr = self.randomizer.sample(self.generator, global_step, B)
            randomize_buf = torch.zeros(B, dtype=torch.int32, device=self.device)
        state = EnvState(sim=sim, progress=torch.zeros(B, dtype=torch.int32, device=self.device),
                         flags=flags, pre_ball_root=sim.root[:, self.ball_actor].clone(),
                         ep_return=torch.zeros(B, dtype=torch.float32, device=self.device),
                         dr=dr, randomize_buf=randomize_buf, global_step=global_step)
        return state, self.observe(sim, self._rb_fn(sim), flags)

    def action_to_drive(self, actions):
        targets = self._pd_action_offset + self._pd_action_scale * actions
        return targets, torch.zeros_like(targets)

    def step(self, state: EnvState, actions):
        """One vectorized env step: (state', obs, reward, done, info)."""
        if self.randomize:
            actions = self.randomizer.action_noise(self.generator, actions)
        actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)
        targets, efforts = self.action_to_drive(actions)
        pre_ball = state.sim.root[:, self.ball_actor]
        sim = self.sim.step(state.sim, targets, efforts, state.dr if self.randomize else None)
        progress = state.progress + 1

        rew, reset, flags = self.reward(pre_ball, sim, self._rb_fn(sim), state.flags, progress)

        # branch-free auto-reset: the would-be reset state of every env,
        # merged where ``reset`` is set
        sim_reset = self.reset_sim(sim)
        do = reset.to(torch.bool)
        ev_map = (self.event_flag_names if self.event_flag_names is not None
                  else {k: k[:-len("_count")] for k in flags if k.endswith("_count")})
        events = {name: do & flags[flag].to(torch.bool) for flag, name in ev_map.items()}
        sim = SimState(*[_merge(do, a, b) for a, b in zip(sim_reset, sim)])
        progress = torch.where(do, torch.zeros_like(progress), progress)
        init = self.init_flags()
        flags = {k: torch.where(do, torch.full_like(v, bool(init[k])), v)
                 for k, v in flags.items()}
        obs = self.observe(sim, self._rb_fn(sim), flags)

        dr, randomize_buf, global_step = state.dr, state.randomize_buf, state.global_step
        if self.randomize:
            # re-sample resetting envs whose counter passed ``frequency``
            # (the reference's randomize_buf semantics)
            global_step = state.global_step + 1
            randomize_buf = state.randomize_buf + 1
            resample = do & (randomize_buf >= self.randomizer.frequency)
            dr_new = self.randomizer.sample(self.generator, global_step, self.num_envs)
            dr = DRParams(*[_merge(resample, a, b) for a, b in zip(dr_new, state.dr)])
            randomize_buf = torch.where(resample, torch.zeros_like(randomize_buf),
                                        randomize_buf)
            obs = self.randomizer.observation_noise(self.generator, obs)

        finished_return = state.ep_return + rew
        ep_return = torch.where(do, torch.zeros_like(finished_return), finished_return)
        new_state = EnvState(sim=sim, progress=progress, flags=flags,
                             pre_ball_root=pre_ball, ep_return=ep_return, dr=dr,
                             randomize_buf=randomize_buf, global_step=global_step)
        time_outs = state.progress + 1 >= self.max_episode_length - 1
        info = {
            "time_outs": time_outs & do,
            "episode_done": do,
            "episode_return": torch.where(do, finished_return, torch.zeros_like(finished_return)),
            "episode_length": torch.where(do, state.progress + 1, torch.zeros_like(progress)),
            "episode_events": events,
        }
        return new_state, obs, rew, reset, info
