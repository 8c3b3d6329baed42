"""Scene specification and static layout compilation, in numpy.

A copy of ``isaacgym_tpu/sim/scene.py``: the scene is declared once as a list
of actor specs; ``compile_scene`` produces the static layout tables (actor ->
root slot, dof slice, body slice, geom tables) that every env shares.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import KinematicTree
from isaacgym_tpu_torch.ops.dynamics import ArticulationModel, build_articulation

DRIVE_POS = 0     # PD position drive (gymapi.DOF_MODE_POS)
DRIVE_EFFORT = 1  # direct torque (gymapi.DOF_MODE_EFFORT)


@dataclass(frozen=True)
class PlaneParams:
    """Ground-plane params (reference ``gymapi.PlaneParams``)."""
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0


@dataclass
class ActorSpec:
    """One actor in the per-env scene (= one reference ``create_actor`` call)."""
    name: str
    tree: KinematicTree
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    fixed_base: bool = True
    restitution: float = 0.0
    friction: float = 0.5
    drive_mode: int = DRIVE_POS
    # PD gains per dof (length n_dof); None = zeros
    stiffness: Optional[np.ndarray] = None
    damping: Optional[np.ndarray] = None
    #: rigid-body angular-velocity clamp (reference
    #: ``AssetOptions.max_angular_velocity``; IsaacGym default 64.0, the
    #: pingpong tasks set 100.0). Applied to the floating base.
    max_angular_velocity: float = 64.0
    #: linear-velocity clamp (``AssetOptions.max_linear_velocity`` default)
    max_linear_velocity: float = 1000.0
    #: rigid-body velocity damping (``AssetOptions.linear_damping`` /
    #: ``angular_damping`` IsaacGym defaults 0.0 / 0.5 — the reference keeps
    #: them, its only override is commented out). Applied to free bodies.
    linear_damping: float = 0.0
    angular_damping: float = 0.5
    #: opt-in aerodynamics for free spheres — BEYOND the reference (PhysX has
    #: no aero): quadratic drag a = -(0.5 rho Cd pi r^2 / m)|v| v and Magnus
    #: lift a = (Cm rho pi r^3 / m)(omega x v). Physical values for the 40 mm
    #: 2.7 g ball: Cd ~ 0.4, Cm ~ 1.0. Default 0 = off (reference parity).
    drag_coefficient: float = 0.0
    magnus_coefficient: float = 0.0


@dataclass
class SceneSpec:
    actors: List[ActorSpec]
    plane: Optional[PlaneParams] = field(default_factory=PlaneParams)
    #: optional heightfield terrain replacing the flat ground (N5)
    terrain: Optional[object] = None
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    dt: float = 1.0 / 120.0
    substeps: int = 2
    bounce_threshold_velocity: float = 0.2
    #: cap on the Baumgarte depenetration bias velocity (reference PhysX
    #: ``max_depenetration_velocity``, cfg/task/*.yaml sim.physx — 10.0 in
    #: every pingpong task). Without it a deeply-jammed ragdoll's ground
    #: contact bias grows with penetration and the feedback loop diverges.
    max_depenetration_velocity: float = 10.0
    #: articulation-link vs articulation-link narrowphase; off is PhysX
    #: parity (the reference filters self-collision). The port's simulator
    #: has no link-link contacts yet and refuses a scene that asks for them.
    link_collision: bool = False
    #: cylinder/box link geoms measure their distance to static geoms by the
    #: support function along the contact normal instead of the
    #: bounding-sphere radius (on in every pingpong task config).
    exact_link_support: bool = False


@dataclass(frozen=True)
class ArticulationSlot:
    actor_index: int
    model: ArticulationModel
    dof_start: int
    dof_end: int
    body_start: int
    body_end: int
    drive_mode: int
    stiffness: np.ndarray
    damping: np.ndarray
    max_angular_velocity: float = 64.0
    max_linear_velocity: float = 1000.0


@dataclass(frozen=True)
class FreeBodySlot:
    """A single-body free actor (the ball)."""
    actor_index: int
    body_start: int
    mass: float
    radius: float
    restitution: float
    friction: float
    max_linear_velocity: float = 1000.0
    #: angular-velocity clamp (AssetOptions.max_angular_velocity; the
    #: reference loads the ball with default options -> 64 rad/s)
    max_angular_velocity: float = 64.0
    #: PhysX per-step velocity damping (AssetOptions defaults 0.0 / 0.5)
    linear_damping: float = 0.0
    angular_damping: float = 0.5
    #: lumped aero accelerations (0 = off): drag k_d in a=-k_d|v|v and
    #: Magnus k_m in a=k_m (omega x v), precomputed from the coefficients
    drag_k: float = 0.0
    magnus_k: float = 0.0
    #: isotropic moment of inertia about the COM (from the URDF inertial tag;
    #: drives the spin-friction coupling kappa = m r^2 / I)
    inertia: float = 0.0


@dataclass(frozen=True)
class StaticGeom:
    """Collision geom on a fixed-base, dof-less actor (table top, net)."""
    actor_index: int
    body_start: int
    kind: int
    local_pos: np.ndarray
    local_quat: np.ndarray
    size: np.ndarray
    restitution: float
    friction: float


@dataclass(frozen=True)
class ArtGeom:
    """Collision geom on an articulated body (paddle, hands, torso...)."""
    art_index: int           # index into CompiledScene.articulations
    body_index: int          # body index within the articulation tree
    kind: int
    local_pos: np.ndarray
    local_quat: np.ndarray
    size: np.ndarray
    restitution: float
    friction: float


@dataclass(frozen=True)
class CompiledScene:
    spec: SceneSpec
    num_actors: int
    num_dofs: int
    num_bodies: int
    articulations: Tuple[ArticulationSlot, ...]
    free_bodies: Tuple[FreeBodySlot, ...]
    static_geoms: Tuple[StaticGeom, ...]
    art_geoms: Tuple[ArtGeom, ...]
    initial_root: np.ndarray     # (num_actors, 13)
    actor_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]
    body_names: Tuple[str, ...]


def compile_scene(spec: SceneSpec) -> CompiledScene:
    articulations: List[ArticulationSlot] = []
    free_bodies: List[FreeBodySlot] = []
    static_geoms: List[StaticGeom] = []
    art_geoms: List[ArtGeom] = []
    dof_names: List[str] = []
    body_names: List[str] = []
    initial_root = np.zeros((len(spec.actors), 13), dtype=np.float32)

    dof_cursor = 0
    body_cursor = 0
    for ai, actor in enumerate(spec.actors):
        tree = actor.tree
        initial_root[ai, 0:3] = actor.pos
        initial_root[ai, 3:7] = actor.quat
        nd, nb = tree.n_dof, tree.n_bodies
        if nd > 0:
            model = build_articulation(tree)
            kp = np.zeros(nd, np.float32) if actor.stiffness is None else np.asarray(actor.stiffness, np.float32)
            kd = np.zeros(nd, np.float32) if actor.damping is None else np.asarray(actor.damping, np.float32)
            slot = ArticulationSlot(
                actor_index=ai, model=model,
                dof_start=dof_cursor, dof_end=dof_cursor + nd,
                body_start=body_cursor, body_end=body_cursor + nb,
                drive_mode=actor.drive_mode, stiffness=kp, damping=kd,
                max_angular_velocity=float(actor.max_angular_velocity),
                max_linear_velocity=float(actor.max_linear_velocity),
            )
            art_idx = len(articulations)
            articulations.append(slot)
            for g in range(len(tree.geom_kind)):
                art_geoms.append(ArtGeom(
                    art_index=art_idx, body_index=int(tree.geom_body[g]),
                    kind=int(tree.geom_kind[g]),
                    local_pos=tree.geom_pos[g], local_quat=tree.geom_quat[g],
                    size=tree.geom_size[g],
                    restitution=actor.restitution, friction=actor.friction,
                ))
        elif not actor.fixed_base:
            # free rigid body — must be a single sphere (the ball)
            if len(tree.geom_kind) != 1 or tree.geom_kind[0] != U.GEOM_SPHERE:
                raise NotImplementedError("free actors must be single spheres")
            free_bodies.append(FreeBodySlot(
                actor_index=ai, body_start=body_cursor,
                mass=float(tree.mass[0]), radius=float(tree.geom_size[0][0]),
                restitution=actor.restitution, friction=actor.friction,
                max_linear_velocity=float(actor.max_linear_velocity),
                max_angular_velocity=float(actor.max_angular_velocity),
                linear_damping=float(actor.linear_damping),
                angular_damping=float(actor.angular_damping),
                # air density 1.204 kg/m^3; sphere area pi r^2, volume-scale r^3
                drag_k=float(0.5 * 1.204 * actor.drag_coefficient
                             * np.pi * float(tree.geom_size[0][0]) ** 2
                             / float(tree.mass[0])),
                magnus_k=float(1.204 * actor.magnus_coefficient
                               * np.pi * float(tree.geom_size[0][0]) ** 3
                               / float(tree.mass[0])),
                inertia=float(tree.inertia[0][0, 0]),
            ))
        else:
            for g in range(len(tree.geom_kind)):
                static_geoms.append(StaticGeom(
                    actor_index=ai, body_start=body_cursor,
                    kind=int(tree.geom_kind[g]),
                    local_pos=tree.geom_pos[g], local_quat=tree.geom_quat[g],
                    size=tree.geom_size[g],
                    restitution=actor.restitution, friction=actor.friction,
                ))
        dof_names += [f"{actor.name}/{n}" for n in tree.dof_names]
        body_names += [f"{actor.name}/{n}" for n in tree.body_names]
        dof_cursor += nd
        body_cursor += nb

    return CompiledScene(
        spec=spec,
        num_actors=len(spec.actors),
        num_dofs=dof_cursor,
        num_bodies=body_cursor,
        articulations=tuple(articulations),
        free_bodies=tuple(free_bodies),
        static_geoms=tuple(static_geoms),
        art_geoms=tuple(art_geoms),
        initial_root=initial_root,
        actor_names=tuple(a.name for a in spec.actors),
        dof_names=tuple(dof_names),
        body_names=tuple(body_names),
    )
