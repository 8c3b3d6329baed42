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

K3 (``k3_inputs``, balls (B, NB, 3)), on C8, on C11 or on the two-arm,
two-ball check scene of ``toy_multi_scene`` (the JAX package's own test
scene):
  reset        reset states (C8: config launch ranges; C11: both balls'
               planar launches from the task's ``sample_ball_velocities``;
               toy: the JAX test's two launches)
  paddle_ball1 ball 0 in front of articulation 0's paddle (C11 and toy:
               ball 1 at articulation 1's)
  paddle_ball2 ball 0 in front of articulation 1's paddle, the one yawed
               180 deg (C11 and toy: ball 1 at articulation 0's)
  ball_rest    C8 and C11: ball 0 resting on the table top
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

``k2_random_inputs``, ``k3_random_inputs`` and ``k4_random_inputs`` give
each kernel's inputs after 60 env steps under random actions (the timings'
states); ``k1_inputs`` turns K2's into K1's.

``k2_state`` and ``k4_state`` make a batched ``SimState`` of a scene from
such inputs (the non-kernel path's and the baked-root guard's checks);
``terrain_ball_state`` puts the ball just above a heightfield terrain,
falling onto it, over the whole field and past its edges (the ground
contact's sampling and its clamp to the field).

The force-sensor path (K2-tau, K3-tau): ``paddle_sensor_scene`` compiles a
task's scene with a force sensor on each humanoid's paddle
(``with_paddle_sensor`` does so for any scene spec, C11's too), and
``strike_state`` makes a ``SimState`` of it from a paddle_ball set: each
ball in front of a paddle, off its centre, heading in.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import compile_tree, fk_dof_frames
from isaacgym_tpu_torch.sim.scene import (DRIVE_POS, ActorSpec, PlaneParams, SceneSpec,
                                          compile_scene)
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


#: ``tests/test_mjcf.py``'s two-hinge MJCF arm (default classes, chained
#: hinges): the MJCF fixture of the asset checks
ARM_MJCF = """
<mujoco model="arm2">
  <default>
    <joint damping="0.1" armature="0.01"/>
    <default class="small"><geom type="sphere" size="0.03"/></default>
  </default>
  <worldbody>
    <body name="base" pos="0 0 1">
      <inertial mass="2.0" pos="0 0 0" diaginertia="0.01 0.01 0.01"/>
      <geom type="box" size="0.05 0.05 0.05"/>
      <body name="upper" pos="0 0 0">
        <joint name="shoulder" type="hinge" axis="0 1 0" range="-1.5 1.5"/>
        <inertial mass="1.0" pos="0 0 -0.15" diaginertia="0.005 0.005 0.001"/>
        <body name="lower" pos="0 0 -0.3">
          <joint name="elbow" type="hinge" axis="0 1 0" range="-2 2"/>
          <inertial mass="0.5" pos="0 0 -0.1" diaginertia="0.002 0.002 0.001"/>
          <geom class="small" pos="0 0 -0.2"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


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


TOY_BIPED_URDF = """
<robot name="toy_biped">
  <link name="torso">
    <inertial><origin xyz="0 0 0"/><mass value="8.0"/>
      <inertia ixx="0.3" iyy="0.3" izz="0.15" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/>
      <geometry><box size="0.25 0.2 0.45"/></geometry></collision>
  </link>
  <link name="leg_l">
    <inertial><origin xyz="0 0 -0.25"/><mass value="1.5"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.36"/>
      <geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="leg_r">
    <inertial><origin xyz="0 0 -0.25"/><mass value="1.5"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.36"/>
      <geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="upper_arm">
    <inertial><origin xyz="0.12 0 0"/><mass value="0.8"/>
      <inertia ixx="0.004" iyy="0.004" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="paddle_hand">
    <inertial><origin xyz="0.1 0 0"/><mass value="0.4"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.18 0 0"/>
      <geometry><sphere radius="0.09"/></geometry></collision>
  </link>
  <joint name="hip_l" type="revolute">
    <origin xyz="0 0.11 -0.28"/><parent link="torso"/><child link="leg_l"/>
    <axis xyz="0 1 0"/><limit lower="-1.2" upper="1.2" effort="60" velocity="20"/>
  </joint>
  <joint name="hip_r" type="revolute">
    <origin xyz="0 -0.11 -0.28"/><parent link="torso"/><child link="leg_r"/>
    <axis xyz="0 1 0"/><limit lower="-1.2" upper="1.2" effort="60" velocity="20"/>
  </joint>
  <joint name="shoulder" type="revolute">
    <origin xyz="0.14 0 0.15"/><parent link="torso"/><child link="upper_arm"/>
    <axis xyz="0 1 0"/><limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
  <joint name="elbow" type="revolute">
    <origin xyz="0.22 0 0"/><parent link="upper_arm"/><child link="paddle_hand"/>
    <axis xyz="0 0 1"/><limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
</robot>
"""


def toy_biped_scene():
    """The JAX package's floating-kernel test scene: a 4-DOF floating biped
    (torso, two 1-DOF legs with sphere feet resting on the ground, a 2-DOF
    arm with a sphere paddle) and a ball over the plane
    (``tests/test_pallas_floating.py:34-113``)."""
    parse = lambda text: compile_tree(U.parse_urdf(text, from_string=True), floating_base=True)
    biped = parse(TOY_BIPED_URDF)
    ball = compile_tree(U.parse_urdf(TOY_BALL_URDF, from_string=True))
    kp = np.full(4, 40.0, np.float32)
    return compile_scene(SceneSpec(
        actors=[ActorSpec("biped", biped, pos=(0, 0, 0.72), fixed_base=False, restitution=0.5,
                          friction=0.6, stiffness=kp, damping=kp / 20),
                ActorSpec("ball", ball, pos=(1.5, 0.05, 1.0), fixed_base=False,
                          restitution=1.3, friction=0.2)],
        plane=PlaneParams(), dt=1 / 120, substeps=2))


def toy_arm_scene():
    """One fixed-base 3-DOF arm (``TOY_ARM_URDF``) and one ball over the
    plane: K2's topology at a DOF count its library is not built for."""
    arm = compile_tree(U.parse_urdf(TOY_ARM_URDF, from_string=True))
    ball = compile_tree(U.parse_urdf(TOY_BALL_URDF, from_string=True))
    kp = np.full(3, 25.0, np.float32)
    return compile_scene(SceneSpec(
        actors=[ActorSpec("arm", arm, pos=(0, 0, 1.0), fixed_base=True, restitution=0.6,
                          friction=0.5, stiffness=kp, damping=kp / 20),
                ActorSpec("ball", ball, pos=(0.5, 0.0, 1.3), fixed_base=False,
                          restitution=1.3, friction=0.2)],
        plane=PlaneParams(), dt=1 / 120, substeps=2))


def random_state(sim, B: int, rng: np.random.RandomState):
    """``(state, targets, efforts)`` of ``sim``'s scene at its initial roots:
    joints within their limits moving at up to 1 rad/s, PD targets within
    the limits, a floating base's velocities up to 0.5, each ball's
    velocity up to 3 m/s and spin up to 20 rad/s; numpy-seeded."""
    scene, dev = sim.scene, sim.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    lo = np.concatenate([sl.model.tree.lower for sl in scene.articulations])
    hi = np.concatenate([sl.model.tree.upper for sl in scene.articulations])
    state = sim.initial_state(B)
    root = state.root.clone()
    for sl in scene.articulations:
        if sl.model.floating:
            root[:, sl.actor_index, 7:13] = t(rng.uniform(-0.5, 0.5, (B, 6)))
    for b in scene.free_bodies:
        root[:, b.actor_index, 7:10] = t(rng.uniform(-3.0, 3.0, (B, 3)))
        root[:, b.actor_index, 10:13] = t(rng.uniform(-20.0, 20.0, (B, 3)))
    q = 0.3 * rng.uniform(lo, hi, (B, len(lo)))
    state = state._replace(root=root, dof_pos=t(q), dof_vel=t(rng.uniform(-1.0, 1.0, q.shape)))
    return state, t(rng.uniform(lo, hi, q.shape)), t(np.zeros(q.shape))


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
    ``kind`` on ``env`` (a C8 or C11 env or a :class:`ToyEnv`). With
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
        if hasattr(env, "sample_ball_velocities"):   # C11: the task's own launches
            for bi, v in enumerate(env.sample_ball_velocities(B)):
                bv[:, bi] = v.cpu().numpy()
        elif env.cfg is not None:   # C8: the config's launch ranges
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


def k2_random_inputs(env, B: int, seed: int = 1, steps: int = 60):
    """K2's seven inputs, tensors on ``env``'s device, after ``steps`` env
    steps of ``env`` (a flagship env of ``B`` envs) from reset under uniform
    random actions, drawn by a generator on that device seeded ``seed``:
    the random-action states."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    nd = env.scene.articulations[0].model.tree.n_dof
    act = lambda: torch.rand((B, nd), generator=gen, device=env.device) * 2 - 1
    state, _ = env.reset()
    for _ in range(steps):
        state, *_ = env.step(state, act())
    tgt, eff = env.action_to_drive(act())
    s, ba = state.sim, env.scene.free_bodies[0].actor_index
    return tuple(t.contiguous() for t in (s.dof_pos, s.dof_vel, tgt, eff, s.root[:, ba, 0:3],
                                          s.root[:, ba, 7:10], s.root[:, ba, 10:13]))


def k1_inputs(env, ins):
    """K1's six inputs from K2's seven ``ins`` on ``env``'s flagship scene:
    q, qd, targets, efforts and, per env, the arm's base pose (its initial
    root)."""
    slot = env.scene.articulations[0]
    root = torch.as_tensor(env.scene.initial_root[slot.actor_index], dtype=torch.float32,
                           device=ins[0].device)
    B = ins[0].shape[0]
    return tuple(ins[:4]) + (root[0:3].expand(B, 3).contiguous(),
                             root[3:7].expand(B, 4).contiguous())


def k3_random_inputs(env, B: int, seed: int = 2, steps: int = 60):
    """K3's seven inputs, tensors on ``env``'s device, after ``steps`` env
    steps of ``env`` (a C8 env of ``B`` envs) from reset under uniform
    random actions, drawn by a generator on that device seeded ``seed``:
    the random-action states."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    n = sum(a.model.tree.n_dof for a in env.scene.articulations)
    act = lambda: torch.rand((B, n), generator=gen, device=env.device) * 2 - 1
    state, _ = env.reset()
    for _ in range(steps):
        state, *_ = env.step(state, act())
    tgt, eff = env.action_to_drive(act())
    s, ba = state.sim, [b.actor_index for b in env.scene.free_bodies]
    return tuple(t.contiguous() for t in (
        s.dof_pos, s.dof_vel, tgt, eff, s.root[:, ba, 0:3], s.root[:, ba, 7:10],
        s.root[:, ba, 10:13]))


def with_paddle_sensor(spec):
    """Scene spec ``spec`` compiled with a force sensor on the paddle:
    registered once on its first actor's asset, the humanoids' shared one,
    before the scene is compiled, so every humanoid carries one."""
    from isaacgym_tpu_torch.sim.asset_api import (create_asset_force_sensor,
                                                  find_asset_rigid_body_index)
    tree = spec.actors[0].tree
    create_asset_force_sensor(tree, find_asset_rigid_body_index(tree, "pingpong_paddle"))
    return compile_scene(spec)


def paddle_sensor_scene(cfg, humanoids: int = 1, floating_base: bool = False):
    """The pingpong scene of task config ``cfg`` with a force sensor on the
    paddle (``with_paddle_sensor``; ``floating_base``: C10's floating
    27-DOF humanoid)."""
    from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
    return with_paddle_sensor(build_pingpong_scene(cfg["env"], cfg["sim"], humanoids=humanoids,
                                                   floating_base=floating_base))


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


def k2_state(sim, ins):
    """``(state, targets, efforts)`` on ``sim``'s device from a one-humanoid
    scene's K2 inputs ``ins`` (numpy): the joints and the ball from ``ins``,
    every other actor at its initial root."""
    q, qd, tgt, eff, bp, bv, bw = (torch.as_tensor(a, device=sim.device) for a in ins)
    state = sim.initial_state(q.shape[0])
    root = state.root.clone()
    ba = sim.scene.free_bodies[0].actor_index
    root[:, ba, 0:3], root[:, ba, 7:10], root[:, ba, 10:13] = bp, bv, bw
    return state._replace(root=root, dof_pos=q, dof_vel=qd), tgt, eff


def k4_state(sim, ins):
    """``(state, targets, efforts)`` from C10's K4 inputs ``ins`` (numpy):
    the base's root, the joints and the ball from ``ins``."""
    q, qd, tgt, eff, bp, bq, blv, bav, pos, vel, omg = (torch.as_tensor(a, device=sim.device)
                                                       for a in ins)
    state = sim.initial_state(q.shape[0])
    root = state.root.clone()
    ai = sim.scene.articulations[0].actor_index
    ba = sim.scene.free_bodies[0].actor_index
    root[:, ai] = torch.cat([bp, bq, blv, bav], dim=1)
    root[:, ba, 0:3], root[:, ba, 7:10], root[:, ba, 10:13] = pos, vel, omg
    return state._replace(root=root, dof_pos=q, dof_vel=qd), tgt, eff


def terrain_ball_state(sim, B: int, rng: np.random.RandomState):
    """``(state, targets, efforts)`` of a one-humanoid scene on heightfield
    terrain: random joints and PD targets, the ball 4 mm inside to 30 mm
    above the terrain surface at a uniform x, y over the field and 0.2 m
    past its edges, falling onto it (vz in [-6, -1] m/s, a horizontal
    velocity up to 2 m/s) and spinning."""
    margin = 0.2
    field = sim.scene.spec.terrain
    tree = sim.scene.articulations[0].model.tree
    lo, hi = tree.lower.astype(np.float64), tree.upper.astype(np.float64)
    nd = tree.n_dof
    R, Cc = field.heights.shape
    x = rng.uniform(field.origin[0] - margin, field.origin[0] + (R - 1) * field.scale + margin, B)
    y = rng.uniform(field.origin[1] - margin, field.origin[1] + (Cc - 1) * field.scale + margin,
                    B)
    h = field.sample(torch.as_tensor(np.stack([x, y], 1), dtype=torch.float32)).numpy()
    rb = sim.scene.free_bodies[0].radius
    bp = np.stack([x, y, h + rb + rng.uniform(-0.004, 0.03, B)], 1)
    bv = np.stack([rng.uniform(-2.0, 2.0, B), rng.uniform(-2.0, 2.0, B),
                   rng.uniform(-6.0, -1.0, B)], 1)
    ins = (rng.uniform(lo, hi, (B, nd)), rng.uniform(-2.0, 2.0, (B, nd)),
           rng.uniform(lo, hi, (B, nd)), np.zeros((B, nd)), bp, bv,
           rng.uniform(-20.0, 20.0, (B, 3)))
    return k2_state(sim, tuple(np.ascontiguousarray(a, dtype=np.float32) for a in ins))


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


def k4_random_inputs(env, B: int, seed: int = 5, steps: int = 60):
    """K4's eleven inputs, tensors on ``env``'s device, after ``steps`` env
    steps of ``env`` (a C10 env of ``B`` envs) from reset under uniform
    random actions, drawn by a generator on that device seeded ``seed``:
    the random-action states."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    nd = env.scene.articulations[0].model.tree.n_dof
    act = lambda: torch.rand((B, nd), generator=gen, device=env.device) * 2 - 1
    state, _ = env.reset()
    for _ in range(steps):
        state, *_ = env.step(state, act())
    tgt, eff = env.action_to_drive(act())
    s, ba = state.sim, env.ball_actor
    return tuple(t.contiguous() for t in (
        s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 0, 0:3], s.root[:, 0, 3:7],
        s.root[:, 0, 7:10], s.root[:, 0, 10:13], s.root[:, ba, 0:3], s.root[:, ba, 7:10],
        s.root[:, ba, 10:13]))


def with_static_copies(consts, shifts):
    """A copy of a K4 pack with each static entry copied once per world
    offset (m) in ``shifts``, the copies after the originals, and the pair
    table rebuilt over every static and every articulated geom, static by
    static (a copy's pair entry is its original's): more art-vs-static
    pairs than the 32 of a warp's chunk (C10 has 18), the last statics'
    pairs past the first chunk."""
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    c = np.array(consts, dtype=np.float32, copy=True)
    lay = FF.layout(int(c[FF.C_ND]))
    ns, na = int(c[FF.C_NSTATIC]), int(c[FF.C_NART])
    n = ns * (1 + len(shifts))
    if int(c[FF.C_NPAIR]) != na * ns or n > FF.MAX_STATIC or na * n > FF.MAX_PAIRS:
        raise ValueError(f"{na} geoms x {n} statics do not fit the pack's pair table")
    sl = lambda off, i, stride: slice(off + i * stride, off + (i + 1) * stride)
    for j, d in enumerate(shifts):
        for si in range(ns):
            dst = sl(lay["static"], ns * (j + 1) + si, FF.STATIC_STRIDE)
            c[dst] = c[sl(lay["static"], si, FF.STATIC_STRIDE)]
            c[dst.start + FF.G_POS:dst.start + FF.G_POS + 3] += np.asarray(d, np.float32)
    old = [c[sl(lay["pair"], i, FF.PAIR_STRIDE)].copy() for i in range(na * ns)]
    for si in range(n):
        for gi in range(na):
            row = old[gi * ns + si % ns].copy()
            row[FF.P_STATIC] = si
            c[sl(lay["pair"], si * na + gi, FF.PAIR_STRIDE)] = row
    c[FF.C_NSTATIC], c[FF.C_NPAIR], c[F.C_NTRUE_STATIC] = n, na * n, n
    return c


# The link-vs-link scenes of the JAX package's tests (``tests/test_link_collision.py``):
# a pendulum (a 1 m arm swinging about y, a sphere tip welded to its end) and
# a base with two such arms 0.8 m apart.
PENDULUM_URDF = """
<robot name="pend">
  <link name="base"><inertial><mass value="1"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial></link>
  <link name="arm">
    <inertial><origin xyz="0 0 -0.5"/><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001"/></inertial>
  </link>
  <link name="tip">
    <inertial><mass value="0.5"/><inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial>
    <collision><geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <joint name="swing" type="revolute">
    <origin xyz="0 0 0"/><parent link="base"/><child link="arm"/>
    <axis xyz="0 1 0"/><limit lower="-6.28" upper="6.28" effort="100" velocity="100"/>
  </joint>
  <joint name="tip_weld" type="fixed">
    <origin xyz="0 0 -1.0"/><parent link="arm"/><child link="tip"/>
  </joint>
</robot>
"""

TWO_ARMS_URDF = """
<robot name="twoarms">
  <link name="base"><inertial><mass value="5"/><inertia ixx="0.5" iyy="0.5" izz="0.5"/></inertial></link>
  <link name="armL">
    <inertial><origin xyz="0 0 -0.5"/><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001"/></inertial>
  </link>
  <link name="tipL">
    <inertial><mass value="0.5"/><inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial>
    <collision><geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <link name="armR">
    <inertial><origin xyz="0 0 -0.5"/><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001"/></inertial>
  </link>
  <link name="tipR">
    <inertial><mass value="0.5"/><inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial>
    <collision><geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <joint name="swingL" type="revolute">
    <origin xyz="-0.4 0 0"/><parent link="base"/><child link="armL"/>
    <axis xyz="0 1 0"/><limit lower="-6.28" upper="6.28" effort="100" velocity="100"/>
  </joint>
  <joint name="weldL" type="fixed">
    <origin xyz="0 0 -1.0"/><parent link="armL"/><child link="tipL"/>
  </joint>
  <joint name="swingR" type="revolute">
    <origin xyz="0.4 0 0"/><parent link="base"/><child link="armR"/>
    <axis xyz="0 1 0"/><limit lower="-6.28" upper="6.28" effort="100" velocity="100"/>
  </joint>
  <joint name="weldR" type="fixed">
    <origin xyz="0 0 -1.0"/><parent link="armR"/><child link="tipR"/>
  </joint>
</robot>
"""


def pendulum_scene(link_collision: bool = True):
    """Two fixed-base pendulums 0.35 m apart, unactuated, whose tips share a
    swing arc (the JAX test's ``_two_pendulums``)."""
    pend = compile_tree(U.parse_urdf(PENDULUM_URDF, from_string=True))
    spec = lambda name, x: ActorSpec(name, pend, pos=(x, 0.0, 1.5), fixed_base=True,
                                     restitution=0.3, friction=0.3, drive_mode=DRIVE_POS,
                                     stiffness=np.zeros(1), damping=np.zeros(1))
    return compile_scene(SceneSpec(actors=[spec("pendA", 0.0), spec("pendB", 0.35)],
                                   plane=PlaneParams(), dt=1 / 120, substeps=2,
                                   link_collision=link_collision))


def sibling_arms_scene(link_collision: bool = True):
    """One fixed-base robot with two unactuated arms that fold into each
    other (the JAX test's sibling-arms scene)."""
    robot = compile_tree(U.parse_urdf(TWO_ARMS_URDF, from_string=True))
    return compile_scene(SceneSpec(
        actors=[ActorSpec("bot", robot, pos=(0.0, 0.0, 1.5), fixed_base=True, restitution=0.2,
                          friction=0.3, drive_mode=DRIVE_POS, stiffness=np.zeros(2),
                          damping=np.zeros(2))],
        plane=PlaneParams(), dt=1 / 120, substeps=2, link_collision=link_collision))


def link_strike_state(sim, B: int, rng: np.random.RandomState):
    """A batched ``SimState`` of ``pendulum_scene`` (pendulum A swinging at
    3-5 rad/s toward B's resting tip) or ``sibling_arms_scene`` (both arms
    folding inward at 2-4 rad/s), per-env velocities from ``rng``, on the
    simulator's device; with zero targets."""
    state = sim.initial_state(B)
    qd = np.zeros((B, sim.scene.num_dofs), np.float32)
    qd[:, 0] = -rng.uniform(3.0, 5.0, B)
    if sim.scene.num_dofs == 2 and len(sim.scene.articulations) == 1:
        qd[:, 0] = -rng.uniform(2.0, 4.0, B)
        qd[:, 1] = rng.uniform(2.0, 4.0, B)
    tgt = torch.zeros((B, sim.scene.num_dofs), device=sim.device)
    return state._replace(dof_vel=torch.as_tensor(qd, device=sim.device)), tgt
