"""Trajectory recorder, the headless stand-in for the native viewer
(``isaacgym_tpu/viewer/trajectory.py``).

Records per-step rigid-body states (pulled off the env's device) and
optional markers and debug lines to ``.npz`` for offline rendering
(``viewer.render``) and inspection, with the JAX recorder's keys, shapes and
dtypes, so either package's renderer draws either package's file.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TrajectoryRecorder:
    """Records per-step body states (and optional markers) for envs 0..k-1."""

    def __init__(self, body_names, max_envs: int = 1, scene=None):
        self.body_names = list(body_names)
        self.max_envs = max_envs
        self.frames: List[np.ndarray] = []
        self.markers: List[np.ndarray] = []
        self.extras: Dict[str, List[np.ndarray]] = {}
        # debug-line state (the reference's gym.add_lines / clear_lines)
        self._live_lines: List[np.ndarray] = []
        self._live_line_colors: List[np.ndarray] = []
        self.line_frames: List[np.ndarray] = []
        self.line_color_frames: List[np.ndarray] = []
        # geom table for the offline renderer (viewer.render)
        self.geoms: Optional[np.ndarray] = None
        if scene is not None:
            from isaacgym_tpu_torch.viewer.render import scene_geom_table
            self.geoms = scene_geom_table(scene)

    def add_lines(self, verts, colors=None) -> None:
        """Queue debug line segments (the reference's ``gym.add_lines``):
        ``verts`` is (n, 2, 3) [or (n, 6)] world-space segment endpoints,
        ``colors`` (n, 3) RGB in [0, 1] (default red). Lines persist across
        frames until :meth:`clear_lines`."""
        v = _host(verts).astype(np.float32).reshape(-1, 2, 3)
        c = (np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32), (len(v), 3))
             if colors is None else
             np.broadcast_to(_host(colors).astype(np.float32).reshape(-1, 3), (len(v), 3)))
        self._live_lines.append(v)
        self._live_line_colors.append(np.ascontiguousarray(c))

    def clear_lines(self) -> None:
        """The reference's ``gym.clear_lines``."""
        self._live_lines = []
        self._live_line_colors = []

    def record(self, rb_states, markers=None, **extras) -> None:
        """``rb_states``: (B, num_bodies, 13), a tensor on any device or an
        array; only the first ``max_envs`` envs leave the device."""
        self.frames.append(_host(rb_states[: self.max_envs]))
        if markers is not None:
            self.markers.append(_host(markers))
        self.line_frames.append(
            np.concatenate(self._live_lines) if self._live_lines
            else np.zeros((0, 2, 3), np.float32))
        self.line_color_frames.append(
            np.concatenate(self._live_line_colors) if self._live_line_colors
            else np.zeros((0, 3), np.float32))
        for k, v in extras.items():
            self.extras.setdefault(k, []).append(_host(v[: self.max_envs]))

    def stacked(self) -> np.ndarray:
        return np.stack(self.frames)  # (T, k, nb, 13)

    def save(self, path: str) -> str:
        data = {
            "body_states": self.stacked(),
            "body_names": np.asarray(self.body_names),
        }
        if self.geoms is not None:
            data["geoms"] = self.geoms
        if self.markers:
            data["markers"] = np.stack(self.markers)
        if any(len(f) for f in self.line_frames):
            # ragged per-frame segment counts -> NaN-padded (T, n_max, 2, 3)
            n_max = max(len(f) for f in self.line_frames)
            T = len(self.line_frames)
            lines = np.full((T, n_max, 2, 3), np.nan, np.float32)
            line_colors = np.zeros((T, n_max, 3), np.float32)
            for t, (f, c) in enumerate(zip(self.line_frames, self.line_color_frames)):
                lines[t, : len(f)] = f
                line_colors[t, : len(c)] = c
            data["lines"] = lines
            data["line_colors"] = line_colors
        for k, v in self.extras.items():
            data[f"extra_{k}"] = np.stack(v)
        np.savez_compressed(path, **data)
        return path


def record_env_rollout(env, policy=None, steps: int = 120, envs: int = 1,
                       out_path: Optional[str] = None):
    """Roll an env with a policy (default: zero actions) and record bodies."""
    state, obs = env.reset()
    rec = TrajectoryRecorder(env.scene.body_names, max_envs=envs, scene=env.scene)
    zeros = torch.zeros((env.num_envs, env.num_actions), device=env.device)
    for _ in range(steps):
        actions = zeros if policy is None else policy(obs)
        rb = env.sim.rigid_body_states(state.sim)
        rec.record(rb, ball=state.sim.root[:, env.ball_actor, :])
        state, obs, rew, done, info = env.step(state, actions)
    if out_path:
        rec.save(out_path)
    return rec
