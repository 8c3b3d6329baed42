"""Scripted inputs for holding K2, K3 and K4 (the fused substeps) against a
reference.

Random-action states rarely bring the paddle into the narrowphase, so the
checks also build states that do: each function returns the kernel's seven
float32 numpy inputs, made from a numpy ``RandomState``.

K2 (``k2_inputs``, (B, n) each):

  reset        reset states with launched balls (config launch ranges)
  paddle_ball  the paddle face in front of an incoming ball
  paddle_table the paddle pressed into the table slab (art-vs-static), many
               within 2 mm of the surface, where the resting band acts. The
               flagship's joint limits keep the paddle 0.16 m above its
               table, so this set needs the scene of ``raised_table_cfg``
  ball_rest    the ball resting on the table top

K3 (``k3_inputs``, balls (B, NB, 3)), on C8 or on the two-arm, two-ball
check scene of ``toy_multi_scene`` (the JAX package's own test scene):
  reset        reset states (C8: config launch ranges; toy: the JAX test's
               two launches)
  paddle_ball1 ball 0 in front of articulation 0's paddle (toy: ball 1 at
               articulation 1's)
  paddle_ball2 ball 0 in front of articulation 1's paddle, the one yawed
               180 deg (toy: ball 1 at articulation 0's)
  ball_rest    C8 only: the ball resting on the table top
  ball_ball    toy only: the two balls about to collide, one spinning

K4 (``k4_inputs``, eleven (B, n) arrays: q, qd, targets, efforts, the
base's pos, quat, linvel, angvel, the ball's pos, vel, omega), on C10:
  stand        the neutral pose at the standing height, the feet's bounding
               spheres within a few mm of the ground (resting contacts at
               the activation margin), the ball launched
  strike       standing, the paddle face in front of an incoming ball
  fall         the humanoid tilted up to 86 deg and falling, its geoms
               hitting the ground
  table        standing on the table slab, many feet within 2 mm of it
               (art-vs-static); needs the scene of ``raised_table_cfg``,
               whose table top is high enough that only the feet reach it

The force-sensor path (K2-tau, K3-tau): ``paddle_sensor_scene`` compiles a
task's scene with a force sensor on each humanoid's paddle, and
``strike_state`` makes a ``SimState`` of it from a paddle_ball set: each
ball in front of a paddle, off its centre, heading in.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import compile_tree, fk_dof_frames
from isaacgym_tpu_torch.sim.scene import ActorSpec, PlaneParams, SceneSpec, compile_scene
from isaacgym_tpu_torch.sim.simulator import floating_geom_lists, fused_geom_lists, true_statics
from isaacgym_tpu_torch.utils import rotations as rot

KINDS = ("reset", "paddle_ball", "paddle_table", "ball_rest")
C8_KINDS = ("reset", "paddle_ball1", "paddle_ball2", "ball_rest")
TOY_KINDS = ("reset", "paddle_ball1", "paddle_ball2", "ball_ball")
K4_KINDS = ("stand", "strike", "fall", "table")
TABLE_RAISE = 0.49   # m: puts the table top where the paddle reaches it


def raised_table_cfg(cfg):
    """A copy of a task config with the table raised by ``TABLE_RAISE``."""
    import copy
    out = copy.deepcopy(cfg)
    pos = list(out["env"]["scene"]["tablePos"])
    pos[2] += TABLE_RAISE
    out["env"]["scene"]["tablePos"] = pos
    return out


def _paddle_pose(env, q, art: int = 0):
    """World centre and face normal (cylinder axis) of articulation
    ``art``'s paddle geom: its cylinder, else its first articulated geom."""
    scene = env.scene
    slot = scene.articulations[art]
    tree = slot.model.tree
    _, _, geoms, _ = fused_geom_lists(scene)
    mine = [g for g in geoms if g["art"] == art]
    g = next((g for g in mine if g["kind"] == U.GEOM_CYLINDER), mine[0])
    init = scene.initial_root[slot.actor_index]
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


TOY_ARM_URDF = """
<robot name="toy_arm">
  <link name="base">
    <inertial><origin xyz="0 0 0"/><mass value="5.0"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.2"/>
      <geometry><box size="0.2 0.2 0.4"/></geometry></collision>
  </link>
  <link name="upper">
    <inertial><origin xyz="0.1 0 0"/><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="fore">
    <inertial><origin xyz="0.1 0 0"/><mass value="0.6"/>
      <inertia ixx="0.005" iyy="0.005" izz="0.005" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="paddle">
    <inertial><origin xyz="0.08 0 0"/><mass value="0.3"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.12 0 0"/>
      <geometry><sphere radius="0.09"/></geometry></collision>
  </link>
  <joint name="shoulder" type="revolute">
    <origin xyz="0.1 0 0.1"/><parent link="base"/><child link="upper"/>
    <axis xyz="0 1 0"/><limit lower="-2.0" upper="2.0" effort="40" velocity="20"/>
  </joint>
  <joint name="elbow" type="revolute">
    <origin xyz="0.2 0 0"/><parent link="upper"/><child link="fore"/>
    <axis xyz="0 1 0"/><limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
  <joint name="wrist" type="revolute">
    <origin xyz="0.2 0 0"/><parent link="fore"/><child link="paddle"/>
    <axis xyz="0 0 1"/><limit lower="-2.0" upper="2.0" effort="20" velocity="20"/>
  </joint>
</robot>
"""

TOY_BALL_URDF = """
<robot name="toy_ball">
  <link name="ball">
    <inertial><origin xyz="0 0 0"/><mass value="0.0027"/>
      <inertia ixx="7e-7" iyy="7e-7" izz="7e-7" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/>
      <geometry><sphere radius="0.02"/></geometry></collision>
  </link>
</robot>
"""


class ToyEnv:
    """The two-arm, two-ball check scene: its compiled scene and simulator
    (with ``paddle_sensor``, a force sensor on each arm's paddle)."""

    def __init__(self, drive_mode: int, device="cpu", paddle_sensor: bool = False):
        from isaacgym_tpu_torch.sim.simulator import Simulator
        self.scene = toy_multi_scene(drive_mode, paddle_sensor)
        self.sim = Simulator(self.scene, device=device)
        self.cfg = None


def toy_multi_scene(drive_mode: int, paddle_sensor: bool = False):
    """Two fixed-base 3-DOF arms facing each other (the second yawed 180
    deg), two balls and the plane, as the JAX package's K3 tests build it
    (``tests/test_pallas_dynamics.py:_toy_multi_scene``); with
    ``paddle_sensor`` a force sensor on the arms' shared paddle body."""
    arm = compile_tree(U.parse_urdf(TOY_ARM_URDF, from_string=True))
    if paddle_sensor:
        from isaacgym_tpu_torch.sim.asset_api import create_asset_force_sensor
        create_asset_force_sensor(arm, arm.body_index("paddle"))
    ball = compile_tree(U.parse_urdf(TOY_BALL_URDF, from_string=True))
    kp = np.full(3, 25.0, np.float32)
    arm_spec = lambda name, pos, quat: ActorSpec(
        name, arm, pos=pos, quat=quat, fixed_base=True, restitution=0.6, friction=0.5,
        drive_mode=drive_mode, stiffness=kp, damping=kp / 20)
    return compile_scene(SceneSpec(
        actors=[arm_spec("arm1", (0, 0, 1.0), (0.0, 0.0, 0.0, 1.0)),
                arm_spec("arm2", (2.0, 0, 1.0), (0, 0, 1, 0)),
                ActorSpec("ball1", ball, pos=(1.4, 0.02, 1.3), fixed_base=False,
                          restitution=1.3, friction=0.2),
                ActorSpec("ball2", ball, pos=(0.6, -0.02, 1.3), fixed_base=False,
                          restitution=1.3, friction=0.2)],
        plane=PlaneParams(), dt=1 / 120, substeps=2))


def _ball_at_paddle(env, q_art, art, rng, rb):
    """Ball positions and velocities in front of articulation ``art``'s
    paddle at joint values ``q_art`` (B, nd): within 3 cm of the surface or
    up to 4 mm inside it, heading in."""
    B = q_art.shape[0]
    center, axis, g = _paddle_pose(env, q_art, art)
    if g["kind"] == U.GEOM_CYLINDER:
        nrm = axis * np.where(rng.uniform(size=(B, 1)) < 0.5, -1.0, 1.0)
        lateral = np.cross(nrm, rng.normal(size=(B, 3)))
        lateral *= rng.uniform(0.0, 0.9 * g["size"][0], (B, 1)) / np.maximum(
            np.linalg.norm(lateral, axis=1, keepdims=True), 1e-9)
        surface = g["size"][1]
    else:   # a sphere: any direction
        nrm = rng.normal(size=(B, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        lateral = 0.0
        surface = g["size"][0]
    gap = rng.uniform(-0.004, 0.03, (B, 1))
    bp = center + nrm * (surface + rb + gap) + lateral
    bv = -nrm * rng.uniform(1.0, 8.0, (B, 1)) + rng.normal(0.0, 1.0, (B, 3))
    return bp, bv


def k3_inputs(env, kind: str, B: int, rng: np.random.RandomState, effort_scale: float = 0.0):
    """(q, qd, targets, efforts, ball_pos, ball_vel, ball_omega) of K3 for
    ``kind`` on ``env`` (a C8 env or a :class:`ToyEnv`). With
    ``effort_scale`` (effort drive) the efforts are uniform in that range
    and the targets zero; else the targets are uniform within the limits."""
    scene = env.scene
    arts = scene.articulations
    nd = arts[0].model.tree.n_dof
    lo = np.concatenate([s.model.tree.lower for s in arts]).astype(np.float64)
    hi = np.concatenate([s.model.tree.upper for s in arts]).astype(np.float64)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    n, nb = len(lo), len(scene.free_bodies)
    if effort_scale:
        tgt, eff = np.zeros((B, n)), rng.uniform(-effort_scale, effort_scale, (B, n))
    else:
        tgt, eff = rng.uniform(lo, hi, (B, n)), np.zeros((B, n))
    q = rng.uniform(lo, hi, (B, n))
    qd = rng.uniform(-3.0, 3.0, (B, n))
    init = np.stack([scene.initial_root[b.actor_index] for b in scene.free_bodies])
    bp = np.broadcast_to(init[None, :, 0:3], (B, nb, 3)).copy()
    bv = rng.normal(0.0, 1.0, (B, nb, 3))
    bw = rng.uniform(-20.0, 20.0, (B, nb, 3))
    rb = scene.free_bodies[0].radius
    if kind == "reset":
        q, qd = np.zeros((B, n)), np.zeros((B, n))
        bw = 0 * bw
        if env.cfg is not None:   # C8: the config's launch ranges
            ball = env.cfg["env"]["ball"]
            s = rng.uniform(*ball["initialSpeedRange"], B)
            a = np.radians(rng.uniform(*ball["tiltAngleRange"], B))
            b = np.radians(rng.uniform(*ball["tiltZAngleRange"], B))
            bv[:, 0] = np.stack([-s * np.cos(a) * np.cos(b), s * np.sin(a) * np.cos(b),
                                 s * np.sin(b)], 1)
        else:   # the toy: the JAX test's two launches
            bv = np.broadcast_to(np.asarray([[-3.0, 0.1, 0.5], [3.0, -0.1, 0.5]]),
                                 (B, 2, 3)) + rng.normal(0.0, 0.1, (B, 2, 3))
    elif kind in ("paddle_ball1", "paddle_ball2"):
        first = 0 if kind == "paddle_ball1" else 1
        for bi in range(nb):
            art = (first + bi) % len(arts)
            bp[:, bi], bv[:, bi] = _ball_at_paddle(env, q[:, art * nd:(art + 1) * nd], art,
                                                   rng, rb)
    elif kind == "ball_rest":
        table = fused_geom_lists(scene)[0][0]
        top = float(table["pos"][2] + table["size"][2])
        bp[:, 0] = np.stack([rng.uniform(1.0, 2.5, B), rng.uniform(-0.6, 0.6, B),
                             top + rb - rng.uniform(0.0, 0.002, B)], 1)
        bv[:, 0] = np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
                             rng.uniform(-0.1, 0.0, B)], 1)
        qd, bw = np.zeros((B, n)), 0.1 * bw
    elif kind == "ball_ball":
        if nb != 2:
            raise KeyError("ball_ball needs two balls")
        mid = np.stack([rng.uniform(0.9, 1.1, B), rng.uniform(-0.3, 0.3, B),
                        rng.uniform(1.2, 1.5, B)], 1)
        d = rng.normal(size=(B, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        half = 0.5 * (2 * rb + rng.uniform(-0.004, 0.03, (B, 1)))
        bp = np.stack([mid + d * half, mid - d * half], 1)
        closing = rng.uniform(1.0, 5.0, (B, 1))
        bv = np.stack([-d * closing, d * closing], 1) + rng.normal(0.0, 0.3, (B, 2, 3))
        bw[:, 1] = 0.0   # one ball spinning
    else:
        raise KeyError(f"unknown input kind {kind!r}; known: {C8_KINDS + TOY_KINDS}")
    return tuple(map(f, (q, qd, tgt, eff, bp, bv, bw)))


def paddle_sensor_scene(cfg, humanoids: int = 1):
    """The pingpong scene of task config ``cfg`` with a force sensor on the
    paddle: registered once on the humanoids' shared asset before the scene
    is compiled, so every humanoid carries one."""
    from isaacgym_tpu_torch.sim.asset_api import (create_asset_force_sensor,
                                                  find_asset_rigid_body_index)
    from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
    spec = build_pingpong_scene(cfg["env"], cfg["sim"], humanoids=humanoids)
    tree = spec.actors[0].tree
    create_asset_force_sensor(tree, find_asset_rigid_body_index(tree, "pingpong_paddle"))
    return compile_scene(spec)


def strike_state(sim, kind: str, B: int, rng: np.random.RandomState, cfg=None):
    """A batched ``SimState`` of ``sim``'s scene and its PD targets from the
    scripted set ``kind`` (one humanoid: ``paddle_ball``; two:
    ``paddle_ball1`` or ``paddle_ball2``; ``reset`` with the task config
    ``cfg`` for its launch ranges): joints and balls from the set, every
    other actor at its initial root. Returns ``(state, targets)`` on the
    simulator's device."""
    scene, dev = sim.scene, sim.device
    env = types.SimpleNamespace(scene=scene, cfg=cfg)
    multi = len(scene.articulations) > 1
    q, qd, tgt, _, bp, bv, bw = (k3_inputs if multi else k2_inputs)(env, kind, B, rng)
    t = lambda a: torch.as_tensor(a, device=dev)
    state = sim.initial_state(B)
    root = state.root.clone()
    balls = [b.actor_index for b in scene.free_bodies]
    shape = (B, len(balls), 3)
    root[:, balls, 0:3] = t(bp).reshape(shape)
    root[:, balls, 7:10] = t(bv).reshape(shape)
    root[:, balls, 10:13] = t(bw).reshape(shape)
    return state._replace(root=root, dof_pos=t(q), dof_vel=t(qd)), t(tgt)


def floating_geom_poses(scene, q, base_pos, base_quat):
    """World centres (B, ng, 3) and orientations (B, ng, 4) of K4's
    articulated geoms (``floating_geom_lists`` order) at joint values ``q``
    and the base pose, numpy in and out; and the geom list."""
    _, geoms, _ = floating_geom_lists(scene)
    tree = scene.articulations[0].model.tree
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    bp, bq = t(base_pos), t(base_quat)
    fp, fq = fk_dof_frames(tree, bp, bq, t(q))
    centers, quats = [], []
    for g in geoms:
        lp, lq = (bp, bq) if g["link"] < 0 else (fp[:, g["link"]], fq[:, g["link"]])
        centers.append(lp + rot.quat_rotate(lq, t(g["off_pos"]).expand_as(lp)))
        quats.append(rot.quat_mul(lq, t(g["off_quat"]).expand_as(lq)))
    return torch.stack(centers, 1).numpy(), torch.stack(quats, 1).numpy(), geoms


def standing_height(scene, exact: bool = False) -> float:
    """The base height at which the lowest articulated geom touches a
    horizontal surface at the neutral pose and the spawn attitude: its
    bounding sphere (the ground contact) or, with ``exact``, its exact
    support along the vertical (a box's or cylinder's contact with the
    table slab)."""
    init = scene.initial_root[scene.articulations[0].actor_index]
    nd = scene.articulations[0].model.tree.n_dof
    centers, quats, geoms = floating_geom_poses(scene, np.zeros((1, nd)), np.zeros((1, 3)),
                                                init[None, 3:7])
    low = []
    for i, g in enumerate(geoms):
        n = rot.quat_rotate(rot.quat_conjugate(torch.as_tensor(quats[:, i])),
                            torch.tensor([[0.0, 0.0, 1.0]])).numpy()[0]
        size = np.asarray(g["size"], np.float64)
        if not exact or g["kind"] == U.GEOM_SPHERE:
            sup = g["radius_bound"]
        elif g["kind"] == U.GEOM_CYLINDER:
            sup = abs(n[2]) * size[1] + np.sqrt(max(1.0 - n[2] ** 2, 0.0)) * size[0]
        else:
            sup = float(np.abs(n) @ size)
        low.append(centers[0, i, 2] - sup)
    return float(-min(low))


def _launch(cfg, B, rng):
    ball = cfg["env"]["ball"]
    s = rng.uniform(*ball["initialSpeedRange"], B)
    a = np.radians(rng.uniform(*ball["tiltAngleRange"], B))
    b = np.radians(rng.uniform(*ball["tiltZAngleRange"], B))
    return np.stack([-s * np.cos(a) * np.cos(b), s * np.sin(a) * np.cos(b), s * np.sin(b)], 1)


def k4_inputs(env, kind: str, B: int, rng: np.random.RandomState):
    """K4's eleven inputs for ``kind`` (``K4_KINDS``) on ``env``, a C10 env
    (``table``: one of the ``raised_table_cfg`` scene)."""
    scene = env.scene
    slot = scene.articulations[0]
    tree = slot.model.tree
    nd = tree.n_dof
    lo, hi = tree.lower.astype(np.float64), tree.upper.astype(np.float64)
    init = scene.initial_root[slot.actor_index].astype(np.float64)
    binit = scene.initial_root[scene.free_bodies[0].actor_index].astype(np.float64)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    h = standing_height(scene)
    small = lambda sd, *shape: rng.normal(0.0, sd, (B,) + shape)
    q = np.clip(small(0.02, nd), lo, hi)
    qd = small(0.05, nd)
    tgt, eff = np.zeros((B, nd)), np.zeros((B, nd))
    bp = np.broadcast_to(init[0:3], (B, 3)).copy()
    bp[:, 2] = h + rng.uniform(-0.004, 0.001, B)
    bq = np.broadcast_to(init[3:7], (B, 4)).copy()
    blv, bav = small(0.02, 3), small(0.02, 3)
    pos = np.broadcast_to(binit[0:3], (B, 3)).copy()
    vel = _launch(env.cfg, B, rng)
    omg = np.zeros((B, 3))
    if kind == "stand":
        pass
    elif kind == "strike":
        arm = slice(nd - 5, nd)   # the right arm's five DOFs end the DOF list
        q[:, arm] = rng.uniform(lo[arm], hi[arm], (B, 5))
        tgt[:, arm] = rng.uniform(lo[arm], hi[arm], (B, 5))
        qd[:, arm] = rng.uniform(-3.0, 3.0, (B, 5))
        centers, quats, geoms = floating_geom_poses(scene, q, bp, bq)
        gi = next(i for i, g in enumerate(geoms) if g["kind"] == U.GEOM_CYLINDER)
        g = geoms[gi]
        axis = rot.quat_rotate(torch.as_tensor(quats[:, gi]),
                               torch.tensor([0.0, 0.0, 1.0]).expand(B, 3)).numpy()
        nrm = axis * np.where(rng.uniform(size=(B, 1)) < 0.5, -1.0, 1.0)
        lateral = np.cross(nrm, rng.normal(size=(B, 3)))
        lateral *= rng.uniform(0.0, 0.9 * g["size"][0], (B, 1)) / np.maximum(
            np.linalg.norm(lateral, axis=1, keepdims=True), 1e-9)
        rb = scene.free_bodies[0].radius
        pos = centers[:, gi] + nrm * (g["size"][1] + rb + rng.uniform(-0.004, 0.03, (B, 1))) \
            + lateral
        vel = -nrm * rng.uniform(1.0, 8.0, (B, 1)) + rng.normal(0.0, 1.0, (B, 3))
        omg = rng.uniform(-20.0, 20.0, (B, 3))
    elif kind == "fall":
        q = 0.5 * rng.uniform(lo, hi, (B, nd))
        qd = rng.uniform(-2.0, 2.0, (B, nd))
        tgt = rng.uniform(lo, hi, (B, nd))
        ang = rng.uniform(0.3, 1.5, B)
        yaw = rng.uniform(0.0, 2.0 * np.pi, B)
        tilt = np.stack([np.cos(yaw) * np.sin(ang / 2), np.sin(yaw) * np.sin(ang / 2),
                         np.zeros(B), np.cos(ang / 2)], 1)
        bq = rot.quat_mul(torch.as_tensor(tilt), torch.as_tensor(bq)).numpy()
        bp[:, 2] = rng.uniform(0.15, 0.6, B)
        blv = np.stack([rng.normal(0.0, 0.5, B), rng.normal(0.0, 0.5, B),
                        rng.uniform(-3.0, -0.5, B)], 1)
        bav = rng.normal(0.0, 1.5, (B, 3))
    elif kind == "table":
        slab = true_statics(scene)[0]
        top = float(slab["pos"][2] + slab["size"][2])
        side = np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0)
        bp[:, 0] = slab["pos"][0] + side * rng.uniform(0.35, 0.9, B)   # clear of the net
        bp[:, 1] = rng.uniform(-0.4, 0.4, B)
        bp[:, 2] = top + standing_height(scene, exact=True) + rng.uniform(-0.004, 0.001, B)
        pos = np.broadcast_to(np.asarray([0.0, 0.0, 0.3]), (B, 3)).copy()
        vel = small(0.5, 3)
    else:
        raise KeyError(f"unknown input kind {kind!r}; known: {K4_KINDS}")
    return tuple(map(f, (q, qd, tgt, eff, bp, bq, blv, bav, pos, vel, omg)))
