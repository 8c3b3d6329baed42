"""Motion library and skeleton tree (``isaacgym_tpu/rl/motion_lib.py``).

Counterparts of the reference's ``MotionLib`` and poselib's
``SkeletonTree``: ``sample_motions``, ``sample_time``, ``get_motion_state``
and ``SkeletonTree.from_mjcf``, batched over query tensors on the library's
device, randomness from an explicit ``torch.Generator``.

Motion clips are ``.npz`` files with arrays (all float32), the JAX
package's format, so a clip written by either package loads in the other:
  fps ()            frames per second
  root_pos (T,3), root_rot (T,4 xyzw)
  dof_pos (T,D), dof_vel (T,D)
  body_pos (T,J,3), body_rot (T,J,4)            [optional]
  body_vel (T,J,3), body_ang_vel (T,J,3)        [optional]
``get_motion_state`` interpolates linearly (slerp for rotations) at any
times.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import torch

from isaacgym_tpu_torch.utils import rotations as rot


class SkeletonTree:
    """Node names, parents and offsets of an articulated asset (poselib's view)."""

    def __init__(self, node_names, parent_indices, local_translations):
        self.node_names = list(node_names)
        self.parent_indices = np.asarray(parent_indices)
        self.local_translation = np.asarray(local_translations)

    @staticmethod
    def from_urdf(path: str) -> "SkeletonTree":
        from isaacgym_tpu_torch.models.kinematics import load_asset
        tree = load_asset(path)
        return SkeletonTree(tree.body_names, tree.parent, tree.joint_pos)

    # the reference calls from_mjcf on URDF files too (the G1 asset lives in
    # an 'mjcf' directory); the JAX package reads it by the URDF route
    @staticmethod
    def from_mjcf(path: str) -> "SkeletonTree":
        return SkeletonTree.from_urdf(path)

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)


class MotionLib:
    """Batched reference-motion sampler on ``device`` (the card unless asked
    otherwise)."""

    def __init__(self, motion_file: str, num_dofs: int, device="cuda",
                 key_body_ids=None, dof_body_ids=None, dof_offsets=None,
                 is_train: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for but no CUDA device is available")
        if os.path.isdir(motion_file):
            files = sorted(glob.glob(os.path.join(motion_file, "*.npz")))
        else:
            files = [motion_file]
        if not files:
            raise FileNotFoundError(f"no motion clips under {motion_file}")
        self.num_dofs = num_dofs
        self._clips = [dict(np.load(f)) for f in files]
        for c in self._clips:
            if c["dof_pos"].shape[1] != num_dofs:
                raise ValueError(f"dof count mismatch: clip has {c['dof_pos'].shape[1]}, "
                                 f"asked for {num_dofs}")
        self._fps = np.asarray([float(c["fps"]) for c in self._clips])
        self._lengths_frames = np.asarray([c["dof_pos"].shape[0] for c in self._clips])
        self._motion_lengths = (self._lengths_frames - 1) / self._fps
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

        # pad clips to a common length so a state lookup is one gather
        Tm = int(self._lengths_frames.max())

        def pad(key, dim):
            out = []
            for c in self._clips:
                a = c.get(key)
                if a is None:
                    a = np.zeros((c["dof_pos"].shape[0],) + dim, np.float32)
                    if key.endswith("rot"):   # identity quats, not zeros
                        a[..., :] = [0.0, 0.0, 0.0, 1.0]
                pad_n = Tm - a.shape[0]
                out.append(np.concatenate([a, np.repeat(a[-1:], pad_n, 0)]) if pad_n else a)
            return f32(np.stack(out))

        self.root_pos = pad("root_pos", (3,))
        self.root_rot = pad("root_rot", (4,))
        self.dof_pos = pad("dof_pos", (num_dofs,))
        self.dof_vel = pad("dof_vel", (num_dofs,))
        # per-body kinematics (key-body obs for imitation and AMP)
        jb = next((c["body_pos"].shape[1] for c in self._clips if "body_pos" in c), None)
        self.num_bodies = jb
        if jb is not None:
            self.body_pos = pad("body_pos", (jb, 3))
            self.body_rot = pad("body_rot", (jb, 4))
        else:
            self.body_pos = self.body_rot = None
        self._key_body_ids = (torch.as_tensor(np.asarray(key_body_ids), device=self.device)
                              if key_body_ids is not None else None)
        self.num_motions = len(self._clips)
        self._fps_t = f32(self._fps)
        self._lengths_t = f32(self._motion_lengths)
        self._last_frame_t = torch.as_tensor(self._lengths_frames - 1, dtype=torch.int32,
                                             device=self.device)

    @property
    def motion_lengths(self) -> torch.Tensor:
        return self._lengths_t

    def sample_motions(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, self.num_motions, (n,), generator=generator,
                             device=self.device)

    def sample_time(self, generator: torch.Generator, motion_ids) -> torch.Tensor:
        u = torch.rand(motion_ids.shape, generator=generator, device=self.device)
        return u * self._lengths_t[motion_ids]

    def get_motion_state(self, motion_ids, motion_times) -> Dict[str, torch.Tensor]:
        """Interpolated state at (ids (N,), times (N,)): lerp, slerp for rotations."""
        motion_ids = torch.as_tensor(motion_ids, device=self.device).long()
        motion_times = torch.as_tensor(motion_times, dtype=torch.float32, device=self.device)
        fps = self._fps_t[motion_ids]
        t = torch.clamp(motion_times, min=torch.zeros_like(fps), max=self._lengths_t[motion_ids])
        f = t * fps
        f0 = torch.floor(f).to(torch.int32)
        max_f = self._last_frame_t[motion_ids]
        f0 = torch.minimum(torch.clamp(f0, min=0), max_f - 1).long()
        f1 = torch.minimum(torch.clamp(f0 + 1, min=0), max_f.long())
        w = torch.clamp(f - f0, 0.0, 1.0)[:, None]

        def lerp(tab):
            a, b = tab[motion_ids, f0], tab[motion_ids, f1]
            return a + (b - a) * w

        out = {
            "root_pos": lerp(self.root_pos),
            "root_rot": rot.slerp(self.root_rot[motion_ids, f0], self.root_rot[motion_ids, f1], w),
            "dof_pos": lerp(self.dof_pos), "dof_vel": lerp(self.dof_vel),
        }
        if self.body_pos is not None:
            a, b = self.body_pos[motion_ids, f0], self.body_pos[motion_ids, f1]
            body_pos = a + (b - a) * w[:, :, None]
            J = a.shape[1]
            qb0 = self.body_rot[motion_ids, f0].reshape(-1, 4)
            qb1 = self.body_rot[motion_ids, f1].reshape(-1, 4)
            wb = torch.repeat_interleave(w, J, dim=0)
            out["body_pos"] = body_pos
            out["body_rot"] = rot.slerp(qb0, qb1, wb).reshape(-1, J, 4)
            if self._key_body_ids is not None:
                out["key_body_pos"] = body_pos[:, self._key_body_ids]
        return out


def save_motion_clip(path: str, fps: float, root_pos, root_rot, dof_pos, dof_vel,
                     **extra) -> str:
    """Write a clip in the MotionLib format; tensors on any device are
    brought to the host."""
    host = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x)).astype(np.float32)
    np.savez_compressed(path, fps=np.float32(fps), root_pos=host(root_pos),
                        root_rot=host(root_rot), dof_pos=host(dof_pos),
                        dof_vel=host(dof_vel),
                        **{k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                           for k, v in extra.items()})
    return path
