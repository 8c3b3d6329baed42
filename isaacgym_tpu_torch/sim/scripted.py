"""Scripted inputs for holding K2 (the fused substep) against a reference.

Random-action states rarely bring the paddle into the narrowphase, so the
checks also build states that do: each function returns the kernel's seven
(B, n) float32 numpy inputs, made from a numpy ``RandomState``.

  reset        reset states with launched balls (config launch ranges)
  paddle_ball  the paddle face in front of an incoming ball
  paddle_table the paddle pressed into the table slab (art-vs-static), many
               within 2 mm of the surface, where the resting band acts. The
               flagship's joint limits keep the paddle 0.16 m above its
               table, so this set needs the scene of ``raised_table_cfg``
  ball_rest    the ball resting on the table top
"""

from __future__ import annotations

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import fk_dof_frames
from isaacgym_tpu_torch.sim.simulator import fused_geom_lists
from isaacgym_tpu_torch.utils import rotations as rot

KINDS = ("reset", "paddle_ball", "paddle_table", "ball_rest")
TABLE_RAISE = 0.49   # m: puts the table top where the paddle reaches it


def raised_table_cfg(cfg):
    """A copy of a task config with the table raised by ``TABLE_RAISE``."""
    import copy
    out = copy.deepcopy(cfg)
    pos = list(out["env"]["scene"]["tablePos"])
    pos[2] += TABLE_RAISE
    out["env"]["scene"]["tablePos"] = pos
    return out


def _paddle_pose(env, q):
    """World centre and face normal (cylinder axis) of the paddle geom."""
    scene = env.scene
    tree = scene.articulations[0].model.tree
    _, _, art, _ = fused_geom_lists(scene)
    g = next(a for a in art if a["kind"] == U.GEOM_CYLINDER)
    init = scene.initial_root[0]
    B = q.shape[0]
    fp, fq = fk_dof_frames(tree, torch.as_tensor(init[0:3]).expand(B, 3),
                           torch.as_tensor(init[3:7]).expand(B, 4),
                           torch.as_tensor(q, dtype=torch.float32))
    lp, lq = fp[:, g["link"]], fq[:, g["link"]]
    off_p = torch.as_tensor(g["off_pos"]).expand(B, 3)
    gq = rot.quat_mul(lq, torch.as_tensor(g["off_quat"]).expand(B, 4))
    center = (lp + rot.quat_rotate(lq, off_p)).numpy()
    axis = rot.quat_rotate(gq, torch.tensor([0.0, 0.0, 1.0]).expand(B, 3)).numpy()
    return center, axis, g


def k2_inputs(env, kind: str, B: int, rng: np.random.RandomState):
    """(q, qd, targets, efforts, ball_pos, ball_vel, ball_omega) for ``kind``."""
    tree = env.scene.articulations[0].model.tree
    lo, hi = tree.lower.astype(np.float64), tree.upper.astype(np.float64)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    tgt = rng.uniform(lo, hi, (B, 7))
    eff = np.zeros((B, 7))
    bw = rng.uniform(-20.0, 20.0, (B, 3))
    rb = env.scene.free_bodies[0].radius
    if kind == "reset":
        ball = env.cfg["env"]["ball"]
        s = rng.uniform(*ball["initialSpeedRange"], B)
        a = np.radians(rng.uniform(*ball["tiltAngleRange"], B))
        b = np.radians(rng.uniform(*ball["tiltZAngleRange"], B))
        bv = np.stack([-s * np.cos(a) * np.cos(b), s * np.sin(a) * np.cos(b), s * np.sin(b)], 1)
        bp = np.broadcast_to(env.scene.initial_root[2, 0:3], (B, 3))
        return tuple(map(f, (np.zeros((B, 7)), np.zeros((B, 7)), tgt, eff, bp, bv, 0 * bw)))
    if kind == "paddle_ball":
        q = rng.uniform(lo, hi, (B, 7))
        center, axis, g = _paddle_pose(env, q)
        side = np.where(rng.uniform(size=(B, 1)) < 0.5, -1.0, 1.0)
        nrm = axis * side
        gap = rng.uniform(-0.004, 0.03, (B, 1))
        lateral = np.cross(nrm, rng.normal(size=(B, 3)))
        lateral *= rng.uniform(0.0, 0.9 * g["size"][0], (B, 1)) / np.maximum(
            np.linalg.norm(lateral, axis=1, keepdims=True), 1e-9)
        bp = center + nrm * (g["size"][1] + rb + gap) + lateral
        bv = -nrm * rng.uniform(1.0, 8.0, (B, 1)) + rng.normal(0.0, 1.0, (B, 3))
        qd = rng.uniform(-3.0, 3.0, (B, 7))
        return tuple(map(f, (q, qd, tgt, eff, bp, bv, bw)))
    if kind == "paddle_table":
        table = fused_geom_lists(env.scene)[0][0]
        top = float(table["pos"][2] + table["size"][2])
        xlo = float(table["pos"][0] - table["size"][0])
        picked, n = [], 0
        for _ in range(50):
            cand = rng.uniform(lo, hi, (20000, 7))
            center, axis, g = _paddle_pose(env, cand)
            sup = np.abs(axis[:, 2]) * g["size"][1] + np.sqrt(
                np.maximum(1.0 - axis[:, 2] ** 2, 0.0)) * g["size"][0]
            dist = center[:, 2] - top - sup
            ok = (dist > -0.02) & (dist < 0.002) & (center[:, 0] > xlo + 0.02)
            picked.append(cand[ok])
            n += int(ok.sum())
            if n >= min(B, 512):
                break
        if n == 0:
            raise RuntimeError("paddle_table: the paddle cannot reach this scene's "
                               "table (use raised_table_cfg)")
        q = np.concatenate(picked)
        q = q[np.arange(B) % len(q)]   # distinct qd keep tiled envs distinct
        qd = rng.uniform(-1.0, 1.0, (B, 7))
        bp = np.broadcast_to(np.asarray([2.9, 0.0, top + 0.3]), (B, 3))
        bv = np.broadcast_to(np.asarray([-5.6, 0.0, 1.2]), (B, 3))
        return tuple(map(f, (q, qd, tgt, eff, bp, bv, bw)))
    if kind == "ball_rest":
        table = fused_geom_lists(env.scene)[0][0]
        top = float(table["pos"][2] + table["size"][2])
        q = rng.uniform(lo, hi, (B, 7))
        bp = np.stack([rng.uniform(1.0, 2.5, B), rng.uniform(-0.6, 0.6, B),
                       top + rb - rng.uniform(0.0, 0.002, B)], 1)
        bv = np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
                       rng.uniform(-0.1, 0.0, B)], 1)
        return tuple(map(f, (q, np.zeros((B, 7)), tgt, eff, bp, bv, 0.1 * bw)))
    raise KeyError(f"unknown input kind {kind!r}; known: {KINDS}")
