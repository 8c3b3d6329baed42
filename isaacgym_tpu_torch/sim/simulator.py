"""Batched simulator for the pingpong scene classes: the fused-substep
kernels, K1 with the non-kernel contact phase, and the non-kernel path.

Counterpart of ``isaacgym_tpu/sim/simulator.py``. ``step`` routes as
``_maybe_build_pallas`` and ``_maybe_build_fused`` (``:270-311``,
``:435-566``) decide, by the scene's topology:

* one position-driven fixed-base humanoid and one ball over the plane (the
  flagship, C6): ``_substep_fused`` (``:686-734``), one K2 launch per
  substep; given ``DRParams`` (``step_dr``, ``:594-624``), K2-dr instead;
* K fixed-base articulations (position or effort drive) and up to two balls
  over the plane (C8): ``_substep_fused_multi`` (``:643-684``), one K3
  launch per substep;
* one floating-base articulation (revolute and prismatic DOFs, at most 32)
  with one ball over the plane (C10, ``:288-295``):
  ``_substep_fused_floating`` (``:388-433``), one K4 launch per substep;
* fixed-base articulations that the fused kernels turn down (terrain, no
  plane, no ball, DOFs not contiguous): ``_substep_pallas`` (``:736-777``),
  one K1 launch per articulation per substep (``ops/arm_step.py``), then
  the non-kernel contact phase on K1's frames and Cholesky factors;
* every other scene (floating bases beyond K4's, no articulation): the
  non-kernel substep ``_substep`` (``:796-887``), fixed and floating bases,
  with ``dr``.

The JAX package's kernels take any DOF count and its K3 articulations of
unequal DOF counts. The port's packs have maxima (unequal DOF counts and
more than two balls are outside K3's), and its CUDA libraries are built for
a few shapes (K1 and K2 at 7 DOFs, K3 at ``KERNEL_SHAPES``, K4 at 27). So
``route_for(scene, device_type)`` sends a scene whose kernel cannot take it
(outside the pack on any device, or a shape the library is not built for
on CUDA) to the non-kernel step, which computes what the JAX XLA path
computes. Under DR (``step`` with ``dr``) only the K2 route has a kernel,
K2-dr, as in the JAX package (only ``_fused_dr`` serves ``step_dr``); the
K1, K3 and K4 routes take the non-kernel step with ``dr``
(``_step_dr_vmapped``).

The non-kernel contact phase, ``_contacts_and_writeback`` (``:888-1105``),
is sequential Gauss-Seidel in the JAX package's order, batched over the
leading env dimension: ball by ball, each against the plane or the
heightfield terrain, then the static geoms group by group, then the
articulated geoms group by group (joint-space two-body impulses through
the factor); the ball-ball pair; the balls' clamp and integration; the
articulated geoms against the static geoms and, for floating bases, the
ground, pair by pair in scene order. It accumulates ``net_contact_force``
and ``net_contact_torque`` on every route. With ``link_collision`` the
opt-in link-vs-link narrowphase (``:1342-1527``) runs between the
art-vs-static and the ground contacts: a build-time pair list
(``_build_art_art_pairs``) of one geom's bounding sphere against another's
exact primitive, each pair's impulse on both articulations' velocities
(through the shared factor for a pair within one articulation). No kernel
carries it, so such a scene takes the non-kernel step on every device, as
the JAX package keeps it off its kernels (``:278-281``).

The baked-root guard (``_baked_roots_moved``, ``:568-592``): K2 and K3 fold
the fixed bases, and K2, K3 and K4 the static actors, at the scene's initial
poses; K1 folds nothing (it reads each base pose from the state), so its
route has no guard. A root written at run time through the tensor API
(``set_actor_root_state_tensor_indexed``) would go unseen by them, so
``step`` compares those roots with the scene constants on the device and
reads the answer (one host sync per step); if any differs in any env, the
whole batch takes the non-kernel substep, as the JAX package's
``lax.cond`` does. ``step_kernel`` and ``step_nonkernel`` are the two
routes unguarded.

A scene that registers a force sensor (``asset_api.create_asset_force_sensor``
before it is compiled) is stepped through the kernels' torque-lane builds,
K2-tau (K2-dr-tau under DR), K3-tau and K4-tau (``_sensors_want_torque``,
``:313-321``): their moment rows are written into ``net_contact_torque``, at
each articulated geom's body its contact moments about the body's frame
origin and at each ball its moments about its centre (``:410-425``,
``:653-684``, ``:710-733``). Sensor-less kernel routes leave
``net_contact_torque`` at zero; the non-kernel contact phase always fills
it.

The physics switches (``sim/switches.py``, the JAX package's
``ISAACGYM_TPU_*`` variables) come in as ``Simulator(scene, device,
switches=)``: ``pallas`` off sends every scene to the non-kernel step;
``art_static`` and ``reach_prune`` shape the art-vs-static pairs of the
non-kernel phase and of every pack; ``kappa`` forces the balls' spin
coupling in both; ``torque`` builds the ``-tau`` kernels; ``ccd`` off sets
the non-kernel phase's swept window to 0 and leaves the kernels' sweep as
the JAX kernels leave it.

State layout (the reference tensor-API contract), batched over B envs:
  root (B, num_actors, 13) = pos(3) + quat(4, xyzw) + linvel(3) + angvel(3),
  dof_pos / dof_vel / dof_force (B, num_dofs), net contact force and torque
  (B, num_bodies, 3).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.env.randomize import DRParams
from isaacgym_tpu_torch.models.kinematics import _qmul, _qrot, fk_body_states, fk_dof_frames
from isaacgym_tpu_torch.ops import arm_step as A
from isaacgym_tpu_torch.ops import contacts as C
from isaacgym_tpu_torch.ops import dynamics as D
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.ops import fused_substep_multi as M
from isaacgym_tpu_torch.ops.arm_step import ArmStep, build_arm_constants, unpack_chol
from isaacgym_tpu_torch.ops.fused_substep import FusedSubstep, build_constants
from isaacgym_tpu_torch.ops.fused_substep_floating import (
    FusedSubstepFloating, build_floating_constants,
)
from isaacgym_tpu_torch.ops.fused_substep_multi import FusedSubstepMulti, build_multi_constants
from isaacgym_tpu_torch.ops.linalg import chol_solve
from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS, CompiledScene
from isaacgym_tpu_torch.sim.switches import DEFAULT as DEFAULT_SWITCHES, PhysicsSwitches
from isaacgym_tpu_torch.utils import rotations as rot


class SimState(NamedTuple):
    root: torch.Tensor                # (B, num_actors, 13)
    dof_pos: torch.Tensor             # (B, num_dofs)
    dof_vel: torch.Tensor             # (B, num_dofs)
    dof_force: torch.Tensor           # (B, num_dofs) last applied drive torque
    net_contact_force: torch.Tensor   # (B, num_bodies, 3)
    net_contact_torque: torch.Tensor  # (B, num_bodies, 3)


class _GeomGroup(NamedTuple):
    """Static arrays of one (owner, primitive kind) geom group (``:55-71``)."""
    kind: int
    actor_index: np.ndarray   # (k,) owning actor (static geoms) or articulation actor
    link: np.ndarray          # (k,) DOF-link index in the articulation (-1 = base)
    body: np.ndarray          # (k,) env-level body index (contact-force reporting)
    offset_pos: np.ndarray    # (k,3) owner-frame offset (body_ref o local for art geoms)
    offset_quat: np.ndarray   # (k,4)
    size: np.ndarray          # (k,3)
    restitution: np.ndarray   # (k,)
    friction: np.ndarray      # (k,)
    radius_bound: np.ndarray  # (k,) bounding-sphere radius (ground and static contacts)
    body_off_pos: np.ndarray  # (k,3) the body's frame origin in the link frame
    kinds: Optional[np.ndarray] = None  # (k,) per-geom kind of a mixed group (kind -1)


RESTING_SMOOTH_BAND = 0.002  # m, the JAX package's resting-contact band (``:107``)


def _resting_smooth(dist, vn, bounce_threshold):
    """Resting-contact activation smoothing (``:110-130``): a contact whose
    |vn| is at most the bounce threshold ramps in over the first 2 mm of
    penetration; an impacting one keeps the hard activation."""
    s = torch.clamp(-dist / RESTING_SMOOTH_BAND, 0.0, 1.0)
    return torch.where(torch.abs(vn) > bounce_threshold, torch.ones_like(s), s)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _integrate_quat(quat, omega, dt):
    """Free-body orientation update q += dt/2 [w,0] o q, normalized."""
    wq = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    q2 = quat + 0.5 * dt * rot.quat_mul(wq, quat)
    return q2 / torch.linalg.norm(q2, dim=-1, keepdim=True)


def _compose(p1, q1, p2, q2):
    """Compose two transforms in numpy (compile time)."""
    p = np.asarray(p1, np.float64) + _qrot(np.asarray(q1, np.float64),
                                           np.asarray(p2, np.float64))
    q = _qmul(np.asarray(q1, np.float64), np.asarray(q2, np.float64))
    return p.astype(np.float32), q.astype(np.float32)


def true_statics(scene: CompiledScene):
    """The static actors' geoms at their actors' initial poses, as the
    kernels' static entries (kind, pos, quat, size, e, mu)."""
    out = []
    for g in scene.static_geoms:
        sroot = scene.initial_root[g.actor_index]
        gp, gq = _compose(sroot[0:3], sroot[3:7], g.local_pos, g.local_quat)
        out.append(dict(kind=g.kind, pos=gp, quat=gq, size=g.size, e=g.restitution,
                        mu=g.friction))
    return out


def fused_geom_lists(scene: CompiledScene):
    """The static and articulated geom lists ``_maybe_build_fused``
    (``simulator.py:435-535``) hands the kernels: true statics first, then
    every humanoid's base-welded geoms as statics at its own base pose; art
    geoms with their offsets folded through the welded body transform, the
    index of their articulation (``art``) and their body's frame origin in
    the link frame (``body_off``, the point the torque lanes take moments
    about).

    Returns ``(static_list, n_true_static, art_list, art_bodies)``."""
    static_list = true_statics(scene)
    n_true_static = len(static_list)
    art_list, art_bodies = [], []
    for g in scene.art_geoms:
        slot = scene.articulations[g.art_index]
        tree = slot.model.tree
        init = scene.initial_root[slot.actor_index]
        link = int(tree.body_ref_dof[g.body_index])
        offp, offq = _compose(tree.body_ref_pos[g.body_index],
                              tree.body_ref_quat[g.body_index],
                              g.local_pos, g.local_quat)
        rb = float(g.size[0]) if g.kind == U.GEOM_SPHERE else float(np.max(g.size))
        if link < 0:
            wp, wq = _compose(init[0:3], init[3:7], offp, offq)
            static_list.append(dict(kind=g.kind, pos=wp, quat=wq, size=g.size,
                                    e=g.restitution, mu=g.friction))
        else:
            art_list.append(dict(kind=g.kind, art=g.art_index, link=link,
                                 off_pos=offp, off_quat=offq,
                                 size=g.size, e=g.restitution, mu=g.friction,
                                 radius_bound=rb,
                                 body_off=np.asarray(tree.body_ref_pos[g.body_index],
                                                     np.float32)))
            art_bodies.append(slot.body_start + g.body_index)
    return static_list, n_true_static, art_list, np.asarray(art_bodies, np.int64)


def floating_geom_lists(scene: CompiledScene):
    """The geom lists ``_build_fused_floating`` (``simulator.py:323-372``)
    hands K4: the true statics at their actors' poses, and every articulated
    geom of the one floating articulation, base-welded ones included (link
    -1), with its offset folded through the welded body transform and its
    body's frame origin in the link frame (``body_off``).

    Returns ``(static_list, art_list, art_bodies)``."""
    static_list = true_statics(scene)
    slot = scene.articulations[0]
    tree = slot.model.tree
    art_list, art_bodies = [], []
    for g in scene.art_geoms:
        offp, offq = _compose(tree.body_ref_pos[g.body_index], tree.body_ref_quat[g.body_index],
                              g.local_pos, g.local_quat)
        rb = float(g.size[0]) if g.kind == U.GEOM_SPHERE else float(np.max(g.size))
        art_list.append(dict(kind=g.kind, link=int(tree.body_ref_dof[g.body_index]),
                             off_pos=offp, off_quat=offq, size=g.size, e=g.restitution,
                             mu=g.friction, radius_bound=rb,
                             body_off=np.asarray(tree.body_ref_pos[g.body_index], np.float32)))
        art_bodies.append(slot.body_start + g.body_index)
    return static_list, art_list, np.asarray(art_bodies, np.int64)


def fused_ball_cfg(scene: CompiledScene, index: int = 0,
                   switches: PhysicsSwitches = DEFAULT_SWITCHES) -> dict:
    ball, plane = scene.free_bodies[index], scene.spec.plane
    return dict(mass=ball.mass, radius=ball.radius, restitution=ball.restitution,
                friction=ball.friction, plane_e=plane.restitution,
                plane_mu=plane.dynamic_friction, max_lin=ball.max_linear_velocity,
                max_ang=ball.max_angular_velocity, lin_damp=ball.linear_damping,
                ang_damp=ball.angular_damping, drag_k=ball.drag_k,
                magnus_k=ball.magnus_k, kappa=switches.ball_kappa(ball))


def multi_art_specs(scene: CompiledScene):
    """K3's articulation dicts (model, base pose, gains, drive mode) in scene
    order."""
    return [dict(model=sl.model, base_pos=scene.initial_root[sl.actor_index][0:3],
                 base_quat=scene.initial_root[sl.actor_index][3:7], kp=sl.stiffness,
                 kd=sl.damping, drive_mode=sl.drive_mode) for sl in scene.articulations]


def topology_route(scene: CompiledScene) -> str:
    """The route the scene's topology asks for, as ``_maybe_build_pallas``
    and ``_maybe_build_fused`` decide (``:270-311``, ``:435-566``): "k4",
    "k2", "k3", "k1" or "nonkernel"."""
    spec, arts = scene.spec, scene.articulations
    if not arts:
        return "nonkernel"
    rev_or_pris = lambda sl: bool(np.all((sl.model.tree.dof_type == U.JOINT_REVOLUTE)
                                         | (sl.model.tree.dof_type == U.JOINT_PRISMATIC)))
    flat = (bool(scene.free_bodies) and spec.terrain is None and spec.plane is not None
            and all(s.drive_mode in (DRIVE_POS, DRIVE_EFFORT) for s in arts))
    if (flat and len(arts) == 1 and len(scene.free_bodies) == 1 and arts[0].model.floating
            and arts[0].model.tree.n_dof <= 32 and rev_or_pris(arts[0])):
        return "k4"
    if any(sl.model.floating or not rev_or_pris(sl) for sl in arts):
        return "nonkernel"
    if not flat or any(sl.model.tree.n_dof > 32 for sl in arts):
        return "k1"
    if len(arts) == 1 and len(scene.free_bodies) == 1 and arts[0].drive_mode == DRIVE_POS:
        return "k2"
    starts = np.cumsum([0] + [sl.model.tree.n_dof for sl in arts])[:-1]
    if any(sl.dof_start != int(o) for sl, o in zip(arts, starts)):
        return "k1"
    return "k3"


def kernel_refusal(scene: CompiledScene, route: str, device_type: str,
                   switches: PhysicsSwitches = DEFAULT_SWITCHES):
    """Why the port's kernel of ``route`` cannot take the scene on a device
    of ``device_type``, or None: its constant pack cannot hold the scene
    (on any device; the pairs counted as the build packs them under
    ``switches.art_static`` and ``switches.reach_prune``), or on CUDA its
    library is not built for the scene's shape."""
    arts = scene.articulations
    nds = [sl.model.tree.n_dof for sl in arts]
    sw = dict(art_static=switches.art_static, reach_prune=switches.reach_prune)
    if route == "k4":
        static_list, art_list, _ = floating_geom_lists(scene)
        why = FF.pack_refusal(static_list, art_list, switches.art_static)
        built = nds == [FF.KERNEL_ND]
    elif route in ("k2", "k3"):
        static_list, n_true, art_list, _ = fused_geom_lists(scene)
        if route == "k2":
            base = scene.initial_root[arts[0].actor_index][0:3]
            pairs = F.static_pairs(arts[0].model, base, art_list, static_list[:n_true], **sw)
            why = F.over_maxima(len(static_list), len(art_list), len(pairs))
            built = nds == [F.KERNEL_ND]
        else:
            why = M.pack_refusal(multi_art_specs(scene), len(scene.free_bodies), static_list,
                                 art_list, n_true, **sw)
            shape = (nds[0], len(arts), len(scene.free_bodies))
            built = shape in M.KERNEL_SHAPES and M.tree_refusal(
                shape, [sl.model.ancestor_mask[:nds[0], :nds[0]] for sl in arts]) is None
    elif route == "k1":
        why, built = None, all(nd == A.KERNEL_ND for nd in nds)
    else:
        return None
    if why is None and device_type == "cuda" and not built:
        why = f"the CUDA library of route {route} is not built for the scene's shape {nds}"
    return why


def route_for(scene: CompiledScene, device_type: str,
              switches: PhysicsSwitches = DEFAULT_SWITCHES) -> str:
    """Which substep ``Simulator.step`` runs on a device of ``device_type``
    ("cpu" or "cuda"): the topology's route (:func:`topology_route`), or
    "nonkernel" where that route's kernel cannot take the scene
    (:func:`kernel_refusal`). The JAX package steps every such scene through
    its own kernel; the non-kernel step computes what its XLA path computes.
    A scene with ``link_collision`` takes "nonkernel" on every device: no
    kernel carries the link-vs-link contacts. So does every scene with the
    switch ``pallas`` off (``ISAACGYM_TPU_PALLAS=0``, ``:276-277``)."""
    if scene.spec.link_collision or not switches.pallas:
        return "nonkernel"
    route = topology_route(scene)
    return "nonkernel" if kernel_refusal(scene, route, device_type, switches) else route


class Simulator:
    """Compiled simulator for one pingpong-class scene on one device, under
    the physics ``switches`` (``sim/switches.py``; the JAX package's
    defaults unless given)."""

    def __init__(self, scene: CompiledScene, device="cuda",
                 switches: Optional[PhysicsSwitches] = None):
        self.scene = scene
        self.device = torch.device(device)
        self.switches = switches or DEFAULT_SWITCHES
        spec = scene.spec
        self.dt = float(spec.dt)
        self.substeps = int(spec.substeps)
        self.bounce_threshold = float(spec.bounce_threshold_velocity)
        self.max_depenetration = float(spec.max_depenetration_velocity)
        self.gravity = torch.tensor(spec.gravity, dtype=torch.float32, device=self.device)
        self._build_geom_groups()
        #: the link-vs-link pairs (geom dicts, sphere side first) with
        #: ``link_collision``, else none
        self._art_art_pairs = self._build_art_art_pairs() if spec.link_collision else []
        arts = scene.articulations
        gravity = np.asarray(spec.gravity, np.float32)
        dt_s = self.dt / self.substeps
        #: the kernels carry the torque lanes only for a scene with sensors
        self.with_torque = self._sensors_want_torque()
        self._all_bodies_fn = None   # rigid_body_states, built at first use
        self._indices = {}
        #: K1 (one per articulation), K2 and K2-dr (one humanoid, one ball),
        #: K3 (fixed bases otherwise) or K4 (a floating base); the others are
        #: None. Each wrapper's ``launches`` counts its launches.
        self.arm_steps = None
        self.fused_substep = self.fused_substep_dr = self.fused_substep_multi = None
        self.fused_substep_floating = None
        self.route = route_for(scene, self.device.type, self.switches)
        baked = set()
        if self.route == "k4":
            baked = {g.actor_index for g in scene.static_geoms}
            self.slot, self.ball = arts[0], scene.free_bodies[0]
            static_list, art_list, self.art_bodies = floating_geom_lists(scene)
            self._art_bodies_t = torch.as_tensor(self.art_bodies, device=self.device)
            self.constants = build_floating_constants(
                self.slot.model, self.slot.stiffness, self.slot.damping, gravity, dt_s,
                fused_ball_cfg(scene, switches=self.switches), static_list, art_list,
                dict(e=spec.plane.restitution, mu=spec.plane.dynamic_friction,
                     max_depen=self.max_depenetration),
                bounce_threshold=self.bounce_threshold, art_static=self.switches.art_static,
                drive_mode=self.slot.drive_mode,
                max_angular_velocity=self.slot.max_angular_velocity,
                max_linear_velocity=self.slot.max_linear_velocity,
                exact_support=bool(spec.exact_link_support))
            self.fused_substep_floating = FusedSubstepFloating(self.constants,
                                                               with_torque=self.with_torque)
        elif self.route == "k1":
            # K1 folds nothing: the base pose is a per-env input
            self.arm_steps = [ArmStep(build_arm_constants(sl.model, sl.stiffness, sl.damping,
                                                          gravity, dt_s)) for sl in arts]
        elif self.route in ("k2", "k3"):
            baked = ({sl.actor_index for sl in arts}
                     | {g.actor_index for g in scene.static_geoms})
            self._build_fused(gravity, dt_s)
        self._baked_actors = np.asarray(sorted(baked), np.int64)
        self._baked_t = torch.as_tensor(self._baked_actors, device=self.device)
        self._baked_root = torch.as_tensor(scene.initial_root[self._baked_actors, 0:7],
                                           device=self.device)

    def kernel_launches(self) -> Dict[str, int]:
        """Each kernel wrapper's launch count by its attribute (K1's summed
        over the articulations)."""
        out = {n: getattr(self, n).launches for n in (
            "fused_substep", "fused_substep_dr", "fused_substep_multi", "fused_substep_floating")
            if getattr(self, n) is not None}
        if self.arm_steps:
            out["arm_steps"] = sum(k.launches for k in self.arm_steps)
        return out

    def _build_fused(self, gravity, dt_s) -> None:
        """The K2 (and K2-dr) or K3 wrapper and its constant pack."""
        scene, spec, arts = self.scene, self.scene.spec, self.scene.articulations
        static_list, n_true, art_list, self.art_bodies = fused_geom_lists(scene)
        sw = self.switches
        common = dict(bounce_threshold=self.bounce_threshold, n_true_static=n_true,
                      max_depenetration=self.max_depenetration,
                      exact_support=bool(spec.exact_link_support),
                      art_static=sw.art_static, reach_prune=sw.reach_prune)
        self._art_bodies_t = torch.as_tensor(self.art_bodies, device=self.device)
        if self.route == "k2":
            self.slot = arts[0]
            self.ball = scene.free_bodies[0]
            init = scene.initial_root[self.slot.actor_index]
            self.constants = build_constants(
                self.slot.model, init[0:3], init[3:7], self.slot.stiffness,
                self.slot.damping, gravity, dt_s, fused_ball_cfg(scene, switches=sw),
                static_list, art_list, **common)
            self.fused_substep = FusedSubstep(self.constants, with_torque=self.with_torque)
            self.fused_substep_dr = FusedSubstep(self.constants, with_dr=True,
                                                 with_torque=self.with_torque)
            return
        self.constants = build_multi_constants(
            multi_art_specs(scene),
            [fused_ball_cfg(scene, i, sw) for i in range(len(scene.free_bodies))],
            static_list, art_list, gravity, dt_s, **common)
        self.fused_substep_multi = FusedSubstepMulti(self.constants,
                                                     with_torque=self.with_torque)
        fb = scene.free_bodies
        self._ball_actors_t = torch.as_tensor([b.actor_index for b in fb], device=self.device)
        self._ball_bodies_t = torch.as_tensor([b.body_start for b in fb], device=self.device)

    def _build_geom_groups(self) -> None:
        """The non-kernel path's geom groups (``:186-268``): static geoms by
        kind; each articulation's geoms by kind, offsets folded through the
        welded body transform; and one scene-order group per articulation
        for its static and ground contacts, so their sequential order is
        the kernels' art-geom walk."""
        scene = self.scene
        static: Dict[int, List] = {}
        for g in scene.static_geoms:
            static.setdefault(g.kind, []).append(g)
        self.static_groups: List[_GeomGroup] = []
        for kind, gs in static.items():
            self.static_groups.append(_GeomGroup(
                kind=kind, actor_index=np.asarray([g.actor_index for g in gs]),
                link=np.full(len(gs), -1), body=np.asarray([g.body_start for g in gs]),
                offset_pos=np.stack([g.local_pos for g in gs]).astype(np.float32),
                offset_quat=np.stack([g.local_quat for g in gs]).astype(np.float32),
                size=np.stack([g.size for g in gs]).astype(np.float32),
                restitution=np.asarray([g.restitution for g in gs], np.float32),
                friction=np.asarray([g.friction for g in gs], np.float32),
                radius_bound=np.asarray([float(np.max(g.size)) for g in gs], np.float32),
                body_off_pos=np.zeros((len(gs), 3), np.float32)))
        self.art_groups: Dict[int, List[_GeomGroup]] = {}
        self.art_ground_groups: Dict[int, _GeomGroup] = {}
        per_art: Dict[int, Dict[int, List]] = {}
        for g in scene.art_geoms:
            per_art.setdefault(g.art_index, {}).setdefault(g.kind, []).append(g)

        def group(kind, slot, gs, kinds=None):
            tree = slot.model.tree
            offs = [_compose(tree.body_ref_pos[g.body_index], tree.body_ref_quat[g.body_index],
                             g.local_pos, g.local_quat) for g in gs]
            return _GeomGroup(
                kind=kind, actor_index=np.asarray([slot.actor_index] * len(gs)),
                link=np.asarray([int(tree.body_ref_dof[g.body_index]) for g in gs]),
                body=np.asarray([slot.body_start + g.body_index for g in gs]),
                offset_pos=np.stack([o[0] for o in offs]),
                offset_quat=np.stack([o[1] for o in offs]),
                size=np.stack([g.size for g in gs]).astype(np.float32),
                restitution=np.asarray([g.restitution for g in gs], np.float32),
                friction=np.asarray([g.friction for g in gs], np.float32),
                radius_bound=np.asarray(
                    [float(g.size[0]) if g.kind == U.GEOM_SPHERE else float(np.max(g.size))
                     for g in gs], np.float32),
                body_off_pos=np.stack(
                    [tree.body_ref_pos[g.body_index] for g in gs]).astype(np.float32),
                kinds=kinds)

        for art_idx, kinds in per_art.items():
            slot = scene.articulations[art_idx]
            self.art_groups[art_idx] = [group(kind, slot, gs) for kind, gs in kinds.items()]
            gs_all = [g for g in scene.art_geoms if g.art_index == art_idx]
            self.art_ground_groups[art_idx] = group(-1, slot, gs_all,
                                                    np.asarray([g.kind for g in gs_all]))

    def _sensors_want_torque(self) -> bool:
        """Whether the scene registers a force sensor, or the switch
        ``torque`` forces the lanes on (``simulator.py:313-321``): only then
        are the kernels built with their moment rows, so sensor-less scenes
        do no moment arithmetic."""
        return self.scene.force_sensor_bodies.size > 0 or self.switches.torque

    def initial_state(self, batch: int) -> SimState:
        sc, dev = self.scene, self.device
        z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=dev)
        root = torch.as_tensor(sc.initial_root, device=dev).expand(batch, -1, -1).clone()
        return SimState(root, z(sc.num_dofs), z(sc.num_dofs), z(sc.num_dofs),
                        z(sc.num_bodies, 3), z(sc.num_bodies, 3))

    def step(self, state: SimState, targets, efforts, dr: DRParams = None) -> SimState:
        """One env step of ``substeps`` substeps, contact forces reset, on the
        route of the scene (module docstring), behind the baked-root guard:
        when a root that the route's kernels fold was rewritten in any env,
        the whole batch takes the non-kernel substep. With ``dr`` (the
        per-env channel in the JAX package's order: kp, kd, lower, upper,
        mass, gravity offset, friction, restitution) the flagship's route
        runs K2-dr; the K1, K3 and K4 routes have no DR kernel and take the
        non-kernel substep, as the JAX package's ``step_dr`` does, with no
        guard and no host sync."""
        if self.route == "nonkernel" or (dr is not None and self.route != "k2"):
            return self.step_nonkernel(state, targets, efforts, dr)
        if self.baked_roots_moved(state):
            return self.step_nonkernel(state, targets, efforts, dr)
        return self.step_kernel(state, targets, efforts, dr)

    def baked_roots_moved(self, state: SimState) -> bool:
        """Whether a root that the kernels fold (``_baked_actors``) differs
        from the scene constant in any env (``:568-574``): compared on the
        device, read with one host sync."""
        if not self._baked_actors.size:
            return False
        return bool((state.root[:, self._baked_t, 0:7] != self._baked_root).any())

    def step_kernel(self, state: SimState, targets, efforts, dr: DRParams = None) -> SimState:
        """The kernel route unguarded (``_step_batched_pallas``, ``:626-641``,
        and the fused half of ``step_dr``); only the K2 route takes ``dr``."""
        if dr is not None and self.route != "k2":
            raise ValueError(f"step_kernel: route {self.route} has no DR kernel")
        dt_s = self.dt / self.substeps
        state = state._replace(net_contact_force=torch.zeros_like(state.net_contact_force),
                               net_contact_torque=torch.zeros_like(state.net_contact_torque))
        if self.route == "k1":
            sub = self._substep_pallas
        elif self.route == "k4":
            sub = self._substep_fused_floating
        elif self.route == "k3":
            sub = self._substep_fused_multi
        elif self.route == "k2":
            dr_chan = None if dr is None else self.dr_channel(dr)
            sub = lambda s, t, e, d: self._substep_fused(s, t, e, d, dr_chan=dr_chan)
        else:
            raise ValueError("step_kernel: the scene runs no kernel")
        for _ in range(self.substeps):
            state = sub(state, targets, efforts, dt_s)
        return state

    def step_nonkernel(self, state: SimState, targets, efforts, dr: DRParams = None) -> SimState:
        """The non-kernel step (``_step_single``, ``:796-803``, over the
        batch): ``substeps`` of ``_substep``."""
        dt_s = self.dt / self.substeps
        state = state._replace(net_contact_force=torch.zeros_like(state.net_contact_force),
                               net_contact_torque=torch.zeros_like(state.net_contact_torque))
        for _ in range(self.substeps):
            state = self._substep(state, targets, efforts, dt_s, dr)
        return state

    def step_dr(self, state: SimState, targets, efforts, dr: DRParams) -> SimState:
        """The JAX package's name for the domain-randomized step
        (``:594-624``): ``step`` with ``dr``."""
        return self.step(state, targets, efforts, dr)

    def dr_channel(self, dr: DRParams) -> torch.Tensor:
        """K2-dr's (B, 4 nd + 6) randomization channel of the articulation's
        DOFs, in the JAX package's order (``simulator.py:608-613``)."""
        sl = slice(self.slot.dof_start, self.slot.dof_end)
        return torch.cat([
            dr.kp_scale[:, sl], dr.kd_scale[:, sl], dr.lower_shift[:, sl],
            dr.upper_shift[:, sl], dr.mass_scale[:, None], dr.gravity_offset,
            dr.friction_scale[:, None], dr.restitution_scale[:, None]], dim=1)

    def _substep_fused(self, state: SimState, targets, efforts, dt_s,
                       dr_chan=None) -> SimState:
        slot, ba = self.slot, self.ball.actor_index
        sl = slice(slot.dof_start, slot.dof_end)
        root = state.root
        kernel, extra = ((self.fused_substep, ()) if dr_chan is None
                         else (self.fused_substep_dr, (dr_chan,)))
        out = kernel(
            state.dof_pos[:, sl].contiguous(), state.dof_vel[:, sl].contiguous(),
            targets[:, sl].contiguous(), efforts[:, sl].contiguous(),
            root[:, ba, 0:3].contiguous(), root[:, ba, 7:10].contiguous(),
            root[:, ba, 10:13].contiguous(), *extra)
        root = root.clone()
        root[:, ba, 3:7] = _integrate_quat(root[:, ba, 3:7], out.ball_omega, dt_s)
        root[:, ba, 0:3] = out.ball_pos
        root[:, ba, 7:10] = out.ball_vel
        root[:, ba, 10:13] = out.ball_omega
        ng = len(self.art_bodies)
        inv_dt = 1.0 / self.dt
        ncf = state.net_contact_force.clone()
        if ng:
            ncf.index_add_(1, self._art_bodies_t, out.impulses[:, :ng] * inv_dt)
        # row ng is the ball's total contact impulse (plane + statics + art)
        ncf[:, self.ball.body_start] += out.impulses[:, ng] * inv_dt
        nct = state.net_contact_torque
        if self.with_torque:
            # rows ng+1 .. 2ng: each geom body's moments; row 2ng+1: the ball's
            nct = nct.clone()
            if ng:
                nct.index_add_(1, self._art_bodies_t, out.impulses[:, ng + 1:2 * ng + 1] * inv_dt)
            nct[:, self.ball.body_start] += out.impulses[:, 2 * ng + 1] * inv_dt
        dof_pos, dof_vel, dof_force = (state.dof_pos.clone(), state.dof_vel.clone(),
                                       state.dof_force.clone())
        dof_pos[:, sl] = out.q_new
        dof_vel[:, sl] = out.qd_new
        dof_force[:, sl] = out.tau
        return SimState(root, dof_pos, dof_vel, dof_force, ncf, nct)

    def _substep_fused_floating(self, state: SimState, targets, efforts, dt_s) -> SimState:
        """One K4 (K4-tau) launch (``simulator.py:388-433``): the base's and
        the ball's roots, the DOF state, the impulse rows into
        ``net_contact_force`` (each articulated geom's body, then the ball's
        total) and, with the torque lanes, the moment rows into
        ``net_contact_torque``."""
        slot, ai, ba = self.slot, self.slot.actor_index, self.ball.actor_index
        sl = slice(slot.dof_start, slot.dof_end)
        root = state.root
        hr = root[:, ai]
        out = self.fused_substep_floating(
            state.dof_pos[:, sl].contiguous(), state.dof_vel[:, sl].contiguous(),
            targets[:, sl].contiguous(), efforts[:, sl].contiguous(),
            hr[:, 0:3].contiguous(), hr[:, 3:7].contiguous(), hr[:, 7:10].contiguous(),
            hr[:, 10:13].contiguous(), root[:, ba, 0:3].contiguous(),
            root[:, ba, 7:10].contiguous(), root[:, ba, 10:13].contiguous())
        root = root.clone()
        root[:, ai] = torch.cat([out.base_pos, out.base_quat, out.base_linvel,
                                 out.base_angvel], dim=1)
        root[:, ba, 3:7] = _integrate_quat(root[:, ba, 3:7], out.ball_omega, dt_s)
        root[:, ba, 0:3] = out.ball_pos
        root[:, ba, 7:10] = out.ball_vel
        root[:, ba, 10:13] = out.ball_omega
        ng = len(self.art_bodies)
        inv_dt = 1.0 / self.dt
        ncf = state.net_contact_force.clone()
        ncf.index_add_(1, self._art_bodies_t, out.impulses[:, :ng] * inv_dt)
        ncf[:, self.ball.body_start] += out.impulses[:, ng] * inv_dt
        nct = state.net_contact_torque
        if self.with_torque:
            # rows ng+1 .. 2ng: each geom body's moments; row 2ng+1: the ball's
            nct = nct.clone()
            nct.index_add_(1, self._art_bodies_t, out.impulses[:, ng + 1:2 * ng + 1] * inv_dt)
            nct[:, self.ball.body_start] += out.impulses[:, 2 * ng + 1] * inv_dt
        dof_pos, dof_vel, dof_force = (state.dof_pos.clone(), state.dof_vel.clone(),
                                       state.dof_force.clone())
        dof_pos[:, sl] = out.q_new
        dof_vel[:, sl] = out.qd_new
        dof_force[:, sl] = out.tau
        return SimState(root, dof_pos, dof_vel, dof_force, ncf, nct)

    def _substep_fused_multi(self, state: SimState, targets, efforts, dt_s) -> SimState:
        """One K3 launch (``simulator.py:643-684``): every DOF, every ball."""
        ba = self._ball_actors_t
        root = state.root
        out = self.fused_substep_multi(
            state.dof_pos.contiguous(), state.dof_vel.contiguous(), targets.contiguous(),
            efforts.contiguous(), root[:, ba, 0:3].contiguous(), root[:, ba, 7:10].contiguous(),
            root[:, ba, 10:13].contiguous())
        root = root.clone()
        root[:, ba, 3:7] = _integrate_quat(root[:, ba, 3:7], out.ball_omega, dt_s)
        root[:, ba, 0:3] = out.ball_pos
        root[:, ba, 7:10] = out.ball_vel
        root[:, ba, 10:13] = out.ball_omega
        ng, nb = len(self.art_bodies), len(ba)
        inv_dt = 1.0 / self.dt
        ncf = state.net_contact_force.clone()
        if ng:
            ncf.index_add_(1, self._art_bodies_t, out.impulses[:, :ng] * inv_dt)
        # per ball: its plane and static row plus its art-reaction row
        ball_imp = out.impulses[:, ng:ng + nb] + out.impulses[:, ng + nb:ng + 2 * nb]
        ncf.index_add_(1, self._ball_bodies_t, ball_imp * inv_dt)
        nct = state.net_contact_torque
        if self.with_torque:
            # after K3's rows: each geom body's moments, then each ball's
            nct = nct.clone()
            o = ng + 2 * nb
            if ng:
                nct.index_add_(1, self._art_bodies_t, out.impulses[:, o:o + ng] * inv_dt)
            nct.index_add_(1, self._ball_bodies_t, out.impulses[:, o + ng:] * inv_dt)
        return SimState(root, out.q_new, out.qd_new, out.tau, ncf, nct)

    # ------------------------------------------------------------------
    # K1 and the non-kernel path
    # ------------------------------------------------------------------

    def _substep_pallas(self, state: SimState, targets, efforts, dt_s) -> SimState:
        """One K1 launch per articulation (``:736-777``), then the shared
        non-kernel contact phase on K1's post-step frames and factors. Each
        base pose is read from the state's root (K1 takes it as an input)."""
        root = state.root
        dof_pos, dof_vel, dof_force = (state.dof_pos.clone(), state.dof_vel.clone(),
                                       state.dof_force.clone())
        art_runtime = []
        for slot, k1 in zip(self.scene.articulations, self.arm_steps):
            sl = slice(slot.dof_start, slot.dof_end)
            bp = root[:, slot.actor_index, 0:3].contiguous()
            bq = root[:, slot.actor_index, 3:7].contiguous()
            out = k1(state.dof_pos[:, sl].contiguous(), state.dof_vel[:, sl].contiguous(),
                     targets[:, sl].contiguous(), efforts[:, sl].contiguous(), bp, bq)
            dof_pos[:, sl] = out.q_new
            dof_force[:, sl] = out.tau
            art_runtime.append({
                "slot": slot, "q": out.q_new, "u": out.qd_new,
                "chol": unpack_chol(out.chol, slot.model.tree.n_dof),
                "base_pos": bp, "base_quat": bq, "frames": (out.frame_pos, out.frame_quat)})
        return self._contacts_and_writeback(root, dof_pos, dof_vel, dof_force, art_runtime,
                                            dt_s, None, state.net_contact_force,
                                            state.net_contact_torque)

    def _substep(self, state: SimState, targets, efforts, dt_s, dr=None) -> SimState:
        """The non-kernel substep (``:805-887``): per articulation the drive
        with its effort clamp, ``forward_dynamics`` (the base's six columns
        first when floating), semi-implicit Euler with the base and DOF
        velocity clamps and the joint limits, a floating base's pose and
        unit quaternion, and the post-step frames; then the contact phase."""
        scene = self.scene
        root = state.root
        dof_pos, dof_vel, dof_force = (state.dof_pos.clone(), state.dof_vel.clone(),
                                       state.dof_force.clone())
        gravity = self.gravity if dr is None else self.gravity + dr.gravity_offset
        art_runtime = []
        for slot in scene.articulations:
            model, tree = slot.model, slot.model.tree
            sl = slice(slot.dof_start, slot.dof_end)
            q, qd = state.dof_pos[:, sl], state.dof_vel[:, sl]
            ra = root[:, slot.actor_index]
            base_pos, base_quat = ra[:, 0:3], ra[:, 3:7]
            u = torch.cat([ra[:, 10:13], ra[:, 7:10], qd], dim=1) if model.floating else qd
            kp = torch.as_tensor(slot.stiffness, dtype=q.dtype, device=q.device)
            kd = torch.as_tensor(slot.damping, dtype=q.dtype, device=q.device)
            if dr is not None:
                kp, kd = kp * dr.kp_scale[:, sl], kd * dr.kd_scale[:, sl]
            tgt, eff = targets[:, sl], efforts[:, sl]
            tau = kp * (tgt - q) - kd * qd + eff if slot.drive_mode == DRIVE_POS else eff
            effort = torch.as_tensor(tree.effort, dtype=q.dtype, device=q.device)
            tau = torch.clamp(tau, -effort, effort)
            tau_gen = torch.cat([torch.zeros_like(tau[:, :1]).expand(-1, 6), tau], dim=1) \
                if model.floating else tau
            udot, chol = D.forward_dynamics(model, base_pos, base_quat, q, u, tau_gen, gravity,
                                            mass_scale=None if dr is None else dr.mass_scale)
            u = u + dt_s * udot
            if model.floating:
                omega, vel, qd_new = u[:, 0:3], u[:, 3:6], u[:, 6:]
                ma, ml = float(slot.max_angular_velocity), float(slot.max_linear_velocity)
                if ma > 0.0:
                    omega = torch.clamp(omega, -ma, ma)
                if ml > 0.0:
                    vel = torch.clamp(vel, -ml, ml)
            else:
                qd_new = u
            vmax = torch.as_tensor(np.where(tree.max_velocity > 0, tree.max_velocity, np.inf),
                                   dtype=q.dtype, device=q.device)
            qd_new = torch.clamp(qd_new, -vmax, vmax)
            q_new = q + dt_s * qd_new
            lo = torch.as_tensor(tree.lower, dtype=q.dtype, device=q.device)
            hi = torch.as_tensor(tree.upper, dtype=q.dtype, device=q.device)
            if dr is not None:
                lo, hi = lo + dr.lower_shift[:, sl], hi + dr.upper_shift[:, sl]
            at_lo, at_hi = q_new < lo, q_new > hi
            q_new = torch.clamp(q_new, lo, hi)
            qd_new = torch.where(at_lo, torch.clamp(qd_new, min=0.0), qd_new)
            qd_new = torch.where(at_hi, torch.clamp(qd_new, max=0.0), qd_new)
            if model.floating:
                base_pos = base_pos + dt_s * vel
                wq = torch.cat([omega, torch.zeros_like(omega[:, :1])], dim=1)
                base_quat = rot.quat_unit(base_quat + 0.5 * dt_s * rot.quat_mul(wq, base_quat))
                u = torch.cat([omega, vel, qd_new], dim=1)
            else:
                u = qd_new
            dof_pos[:, sl] = q_new
            dof_force[:, sl] = tau
            art_runtime.append({
                "slot": slot, "q": q_new, "u": u, "chol": chol, "base_pos": base_pos,
                "base_quat": base_quat,
                "frames": fk_dof_frames(tree, base_pos, base_quat, q_new)})
        return self._contacts_and_writeback(root, dof_pos, dof_vel, dof_force, art_runtime,
                                            dt_s, dr, state.net_contact_force,
                                            state.net_contact_torque)

    def _ground_frame(self, radius):
        """The ball's ground test: the heightfield (bilinear height, its
        normal) when the scene has terrain, else the plane z = 0."""
        terr = self.scene.spec.terrain
        if terr is None:
            return lambda p: C.sphere_plane(p, radius)

        def terrain_fn(p):
            h = terr.sample(p[..., :2])
            n = terr.normal(p[..., :2])
            dist = (p[..., 2] - h) * n[..., 2] - radius
            return C.ContactFrame(dist, n, p - n * radius)
        return terrain_fn

    def _contacts_and_writeback(self, root, dof_pos, dof_vel, dof_force, art_runtime, dt_s,
                                dr, ncf, nct) -> SimState:
        """The contact phase and the writeback (``:888-1100``), batched: the
        balls' free flight and contacts, the ball-ball pair, the balls'
        clamp and integration, articulated geoms against static geoms and
        (floating bases) the ground, then the articulations' velocities.
        ``ncf`` and ``nct`` accumulate impulse / dt, geoms of one body
        summed (``_index``)."""
        scene = self.scene
        gravity = self.gravity if dr is None else self.gravity + dr.gravity_offset
        ncf, nct = ncf.clone(), nct.clone()
        inv_dt = 1.0 / self.dt
        ccd = self.switches.ccd_dt(dt_s)   # the swept-CCD window (``_ccd_dt``)

        def add(acc, bodies, val):
            idx, S = self._index(bodies)
            val = val if val.dim() == 3 else val[:, None]
            acc[:, idx] += val if S is None else torch.einsum("uk,zkc->zuc", S, val)

        ball_states = []
        for ball in scene.free_bodies:
            ra = root[:, ball.actor_index]
            pos, vel, omega = ra[:, 0:3], ra[:, 7:10], ra[:, 10:13]
            kappa = self.switches.ball_kappa(ball)
            vel = vel + gravity * dt_s
            ld = float(getattr(ball, "linear_damping", 0.0))
            ad = float(getattr(ball, "angular_damping", 0.5))
            if ld > 0.0:
                vel = vel * max(0.0, 1.0 - ld * dt_s)
            if ad > 0.0:
                omega = omega * max(0.0, 1.0 - ad * dt_s)
            kd_aero = float(getattr(ball, "drag_k", 0.0))
            km_aero = float(getattr(ball, "magnus_k", 0.0))
            if kd_aero > 0.0:
                vel = vel - dt_s * kd_aero * torch.linalg.norm(vel, dim=-1, keepdim=True) * vel
            if km_aero > 0.0:
                vel = vel + dt_s * km_aero * _cross(omega, vel)
            if scene.spec.plane is not None:
                plane = scene.spec.plane
                e, mu = C.combine_material(ball.restitution, plane.restitution, ball.friction,
                                           plane.dynamic_friction)
                frame, now_dist = C.swept_frame(self._ground_frame(ball.radius), pos, vel, ccd)
                dv, dw, _, active = C.resolve_sphere_impulse_spin(
                    vel, omega, ball.radius, kappa, frame, torch.zeros_like(vel), e, mu,
                    self.bounce_threshold)
                vel, omega = vel + dv, omega + dw
                pos = C.depenetrate(pos, frame._replace(dist=now_dist), active)
                add(ncf, ball.body_start, dv * (ball.mass * inv_dt))
                add(nct, ball.body_start,
                    -ball.radius * _cross(frame.normal, dv) * (ball.mass * inv_dt))
            for grp in self.static_groups:
                pos, vel, omega, dv_tot, tq_ball = self._ball_vs_static_group(
                    root, grp, ball, pos, vel, omega, dt_s)
                add(ncf, ball.body_start, dv_tot * (ball.mass * inv_dt))
                add(nct, ball.body_start, tq_ball * (ball.mass * inv_dt))
            for art_idx, groups in self.art_groups.items():
                rt = art_runtime[art_idx]
                for grp in groups:
                    pos, vel, omega, du, P, tq_art, tq_ball = self._ball_vs_art_group(
                        rt, grp, ball, pos, vel, omega, dt_s, dr)
                    rt["u"] = rt["u"] + du
                    add(ncf, ball.body_start, P.sum(dim=1) * inv_dt)
                    add(ncf, grp.body, -P * inv_dt)
                    add(nct, ball.body_start, tq_ball * inv_dt)
                    add(nct, grp.body, tq_art * inv_dt)
            ball_states.append([pos, vel, omega])

        # the ball-ball pair (two free balls in one env)
        fb = scene.free_bodies
        for i in range(len(fb)):
            for j in range(i + 1, len(fb)):
                a, b = fb[i], fb[j]
                pa, va, wa = ball_states[i]
                pb, vb, wb = ball_states[j]
                ka, kb = self.switches.ball_kappa(a), self.switches.ball_kappa(b)
                inv_ma, inv_mb = 1.0 / a.mass, 1.0 / b.mass
                v_rel = va - vb
                offs = [0.0] if ccd == 0.0 else [ccd * s_ / 4 for s_ in range(5)]
                dist = torch.stack([torch.linalg.norm(pa - pb + v_rel * t, dim=-1)
                                    for t in offs]).min(dim=0).values - a.radius - b.radius
                d = pa - pb
                dn = torch.linalg.norm(d, dim=-1)
                n = d / torch.clamp(dn, min=1e-9)[:, None]
                vn = torch.sum(v_rel * n, dim=-1)
                active = (dist < 0.0) & (vn < 0.0)
                e, mu = C.combine_material(a.restitution, b.restitution, a.friction, b.friction)
                e_eff = torch.where(torch.abs(vn) > self.bounce_threshold, e, 0.0)
                Pn = torch.where(active, -(1.0 + e_eff) * vn / (inv_ma + inv_mb), 0.0)
                slip = v_rel - a.radius * _cross(wa, n) - b.radius * _cross(wb, n)
                vt = slip - torch.sum(slip * n, dim=-1)[:, None] * n
                vt_norm = torch.linalg.norm(vt, dim=-1)
                t_hat = vt / torch.clamp(vt_norm, min=1e-9)[:, None]
                w_t = (1.0 + ka) * inv_ma + (1.0 + kb) * inv_mb
                Pt = torch.where(active, torch.minimum(mu * Pn, vt_norm / w_t), 0.0)
                P = Pn[:, None] * n - Pt[:, None] * t_hat
                dwdir = _cross(n, t_hat)
                ball_states[i][1] = va + P * inv_ma
                ball_states[j][1] = vb - P * inv_mb
                ball_states[i][2] = wa + (ka * inv_ma / a.radius) * Pt[:, None] * dwdir
                ball_states[j][2] = wb + (kb * inv_mb / b.radius) * Pt[:, None] * dwdir
                push = torch.where(active, torch.clamp(-(dn - a.radius - b.radius), min=0.0),
                                   0.0)
                ball_states[i][0] = pa + 0.5 * push[:, None] * n
                ball_states[j][0] = pb - 0.5 * push[:, None] * n
                add(ncf, a.body_start, P * inv_dt)
                add(ncf, b.body_start, -P * inv_dt)
                add(nct, a.body_start, -a.radius * _cross(n, P) * inv_dt)
                add(nct, b.body_start, -b.radius * _cross(n, P) * inv_dt)

        # clamp the magnitudes, integrate, write back the balls
        root = root.clone()
        for ball, (pos, vel, omega) in zip(fb, ball_states):
            ml = float(ball.max_linear_velocity)
            if ml > 0.0:
                vel = vel * torch.clamp(
                    ml / torch.clamp(torch.linalg.norm(vel, dim=-1, keepdim=True), min=1e-9),
                    max=1.0)
            ma = float(getattr(ball, "max_angular_velocity", 64.0))
            if ma > 0.0:
                omega = omega * torch.clamp(
                    ma / torch.clamp(torch.linalg.norm(omega, dim=-1, keepdim=True), min=1e-9),
                    max=1.0)
            pos = pos + dt_s * vel
            bq = _integrate_quat(root[:, ball.actor_index, 3:7], omega, dt_s)
            root[:, ball.actor_index] = torch.cat([pos, bq, vel, omega], dim=1)

        # articulated geoms vs the static geoms, scene order per articulation
        # (none with the switch ``art_static`` off, ``:1053``)
        for art_idx, grp in (self.art_ground_groups.items() if self.switches.art_static else ()):
            rt = art_runtime[art_idx]
            for sgrp in self.static_groups:
                du, P_sum, tq_sum = self._art_vs_static_group(rt, grp, sgrp, root, dt_s)
                rt["u"] = rt["u"] + du
                add(ncf, grp.body, P_sum * inv_dt)
                add(nct, grp.body, tq_sum * inv_dt)

        # articulation links vs articulation links (``link_collision``),
        # pair by pair in the build's order
        for pa, pb in self._art_art_pairs:
            P, tq_a, tq_b = self._art_vs_art_pair(pa, pb, art_runtime, dt_s)
            add(ncf, pa["body"], P / self.dt)
            add(ncf, pb["body"], -P / self.dt)
            add(nct, pa["body"], tq_a / self.dt)
            add(nct, pb["body"], tq_b / self.dt)

        # floating articulations vs the ground (feet), scene order
        if scene.spec.plane is not None:
            for art_idx, grp in self.art_ground_groups.items():
                rt = art_runtime[art_idx]
                if rt["slot"].model.floating:
                    rt["u"] = rt["u"] + self._art_vs_ground_group(rt, grp, dt_s)

        # the articulations' state
        for rt in art_runtime:
            slot, u = rt["slot"], rt["u"]
            sl = slice(slot.dof_start, slot.dof_end)
            if slot.model.floating:
                root[:, slot.actor_index] = torch.cat(
                    [rt["base_pos"], rt["base_quat"], u[:, 3:6], u[:, 0:3]], dim=1)
                dof_vel[:, sl] = u[:, 6:]
            else:
                dof_vel[:, sl] = u
        return SimState(root, dof_pos, dof_vel, dof_force, ncf, nct)

    # -- contact helpers, vectorized over a geom group -------------------------

    def _frames_for_group(self, kind, pos, radius, gpos, gquat, size) -> C.ContactFrame:
        """Spheres at ``pos`` (..., 3) against geoms of one kind at ``gpos``,
        ``gquat``, broadcast against ``pos``; ``size`` (k, 3) numpy."""
        sz = torch.as_tensor(size, dtype=pos.dtype, device=pos.device)
        if kind == U.GEOM_BOX:
            return C.sphere_box(pos, radius, gpos, gquat, sz)
        if kind == U.GEOM_CYLINDER:
            return C.sphere_cylinder(pos, radius, gpos, gquat, sz[:, 0], sz[:, 1])
        if kind == U.GEOM_SPHERE:
            return C.sphere_sphere(pos, radius, gpos, sz[:, 0])
        raise NotImplementedError(kind)

    def _t(self, x, like):
        """A constant array as a tensor beside ``like``."""
        return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)

    def _index(self, ids):
        """``(unique bodies, S)`` for a list of body indices, made once per
        list: S is None when no body repeats, else the (unique, k) 0/1
        matrix that sums a repeated body's rows. Accumulating through it,
        and not through ``index_add_``'s atomics, keeps the contact phase
        deterministic on the card."""
        key = tuple(np.atleast_1d(ids).tolist())
        if key not in self._indices:
            uniq, inv = np.unique(np.asarray(key), return_inverse=True)
            S = None
            if len(uniq) < len(key):
                S = torch.as_tensor(np.eye(len(uniq), dtype=np.float32)[:, inv],
                                    device=self.device)
            self._indices[key] = (torch.as_tensor(uniq, device=self.device), S)
        return self._indices[key]

    def _ball_vs_static_group(self, root, grp: _GeomGroup, ball, pos, vel, omega, dt_s):
        """The ball against one static kind-group (``:1123-1144``), swept over
        two samples of the CCD window."""
        roots = root[:, grp.actor_index]                                   # (B,k,13)
        k = len(grp.actor_index)
        gpos = roots[..., 0:3] + rot.quat_rotate(
            roots[..., 3:7], self._t(grp.offset_pos, pos).expand(pos.shape[0], k, 3))
        gquat = rot.quat_mul(roots[..., 3:7],
                             self._t(grp.offset_quat, pos).expand(pos.shape[0], k, 4))
        geom_fn = lambda p: self._frames_for_group(grp.kind, p[:, None].expand(-1, k, 3),
                                                   ball.radius, gpos, gquat, grp.size)
        frame, now_dist = C.swept_frame(geom_fn, pos, vel, self.switches.ccd_dt(dt_s),
                                        samples=2)
        e, mu = C.combine_material(ball.restitution, self._t(grp.restitution, pos),
                                   ball.friction, self._t(grp.friction, pos))
        dv, dw, _, active = C.resolve_sphere_impulse_spin(
            vel[:, None], omega[:, None], ball.radius, self.switches.ball_kappa(ball), frame,
            torch.zeros_like(gpos), e, mu, self.bounce_threshold)
        dv_tot = dv.sum(dim=1)
        push = torch.where(active[..., None],
                           frame.normal * torch.clamp(-now_dist, min=0.0)[..., None], 0.0)
        tq_ball = (-ball.radius * _cross(frame.normal, dv)).sum(dim=1)
        return pos + push.sum(dim=1), vel + dv_tot, omega + dw.sum(dim=1), dv_tot, tq_ball

    def _geom_poses(self, rt, grp: _GeomGroup):
        """A group's link (or base) poses (B,k,3), (B,k,4), from the runtime
        frames."""
        fp, fq = rt["frames"]
        nd = rt["slot"].model.tree.n_dof
        pos_ext = torch.cat([fp, rt["base_pos"][:, None]], dim=1)
        quat_ext = torch.cat([fq, rt["base_quat"][:, None]], dim=1)
        ref = torch.as_tensor(np.where(grp.link < 0, nd, grp.link), device=fp.device)
        return pos_ext[:, ref], quat_ext[:, ref]

    def _minv_jt(self, rt, J):
        """Rows of M^-1 J^T for Jacobians J (B, K, 3, nv), through the factor."""
        B, K, _, nv = J.shape
        X = chol_solve(rt["chol"], J.reshape(B, K * 3, nv).transpose(1, 2))
        return X.transpose(1, 2).reshape(B, K, 3, nv)

    def _ball_vs_art_group(self, rt, grp: _GeomGroup, ball, pos, vel, omega, dt_s, dr=None):
        """The ball against one articulated kind-group (``:1146-1230``): the
        geom-point velocity folded into a four-sample sweep, joint-space
        two-body impulses with the ball's spin coupling. Returns (pos, vel,
        omega, du, P (B,k,3), the geom bodies' moments, the ball's)."""
        model = rt["slot"].model
        B, k = pos.shape[0], len(grp.link)
        bp, bq = self._geom_poses(rt, grp)
        gpos = bp + rot.quat_rotate(bq, self._t(grp.offset_pos, pos).expand(B, k, 3))
        gquat = rot.quat_mul(bq, self._t(grp.offset_quat, pos).expand(B, k, 4))
        fn = lambda p: self._frames_for_group(grp.kind, p, ball.radius, gpos, gquat, grp.size)
        frame0 = fn(pos[:, None].expand(B, k, 3))
        J = D.point_jacobians(model, rt["frames"], rt["base_pos"], grp.link, frame0.point)
        MinvJT = self._minv_jt(rt, J)
        v_point = torch.einsum("zkav,zv->zka", J, rt["u"])
        v_rel0 = vel[:, None] - v_point
        # four swept samples of the CCD window, the geom-point velocity
        # folded in; the first penetrating one is the entry side
        # (``C.swept_frame``); none with the window at 0
        ccd = self.switches.ccd_dt(dt_s)
        frame = frame0
        if ccd > 0.0:
            frames = [frame0] + [fn(pos[:, None] + v_rel0 * (ccd * s_ / 4)) for s_ in range(1, 5)]
            dists = torch.stack([f.dist for f in frames])
            normals = torch.stack([f.normal for f in frames])
            j = torch.argmax((dists < 0.0).to(torch.int8), dim=0, keepdim=True)
            frame = C.ContactFrame(
                torch.gather(dists, 0, j)[0],
                torch.gather(normals, 0, j[..., None].expand((1,) + normals.shape[1:]))[0],
                frame0.point)
        n = frame.normal
        v_rel = vel[:, None] - v_point
        vn = torch.sum(v_rel * n, dim=-1)
        active = (frame.dist < 0.0) & (vn < 0.0)
        grp_e, grp_mu = self._t(grp.restitution, pos), self._t(grp.friction, pos)
        if dr is not None:
            grp_e = grp_e * dr.restitution_scale[:, None]
            grp_mu = grp_mu * dr.friction_scale[:, None]
        e, mu = C.combine_material(ball.restitution, grp_e, ball.friction, grp_mu)
        e_eff = torch.where(torch.abs(vn) > self.bounce_threshold, e, 0.0)
        inv_m = 1.0 / ball.mass
        kappa = self.switches.ball_kappa(ball)
        w_n = inv_m + torch.einsum("zka,zkav,zkbv,zkb->zk", n, J, MinvJT, n)
        Pn = torch.where(active, -(1.0 + e_eff) * vn / torch.clamp(w_n, min=1e-9), 0.0)
        slip = v_rel - ball.radius * _cross(omega[:, None].expand_as(n), n)
        vt = slip - torch.sum(slip * n, dim=-1)[..., None] * n
        vt_norm = torch.linalg.norm(vt, dim=-1)
        t_hat = vt / torch.clamp(vt_norm, min=1e-9)[..., None]
        w_t = (1.0 + kappa) * inv_m + torch.einsum("zka,zkav,zkbv,zkb->zk", t_hat, J, MinvJT,
                                                   t_hat)
        Pt = torch.where(active, torch.minimum(mu * Pn, vt_norm / torch.clamp(w_t, min=1e-9)),
                         0.0)
        P = Pn[..., None] * n - Pt[..., None] * t_hat
        vel = vel + P.sum(dim=1) * inv_m
        omega = omega + (kappa * inv_m / ball.radius) * (_cross(n, t_hat) * Pt[..., None]).sum(1)
        du = -torch.einsum("zkav,zka->zv", MinvJT, P)
        push = torch.where(active[..., None],
                           n * torch.clamp(-frame0.dist, min=0.0)[..., None], 0.0)
        tq_ball = _cross(frame0.point - pos[:, None], P).sum(dim=1)
        borg = bp + rot.quat_rotate(bq, self._t(grp.body_off_pos, pos).expand(B, k, 3))
        tq_art = _cross(frame0.point - borg, -P)
        return pos + push.sum(dim=1), vel, omega, du, P, tq_art, tq_ball

    def _sequential(self, rt, J, MinvJT, n, dist, bias, e, mu, w_n):
        """Gauss-Seidel over contact rows (``:1309-1334``, ``:1561-1582``):
        each row sees the velocity corrected by the rows before it. ``e``
        and ``mu`` are per-row tensors or numbers. Returns (u, the rows'
        impulses (B, K, 3))."""
        u = rt["u"]
        P_rows = []
        for i in range(J.shape[1]):
            v_point = torch.einsum("zav,zv->za", J[:, i], u)
            n_i = n[:, i]
            vn_i = torch.sum(v_point * n_i, dim=-1)
            active = (dist[:, i] < 0.0) & (vn_i < 0.1)
            e_i = e[i] if torch.is_tensor(e) else e
            mu_i = mu[i] if torch.is_tensor(mu) else mu
            e_eff = torch.where(torch.abs(vn_i) > self.bounce_threshold, e_i, 0.0)
            Pn = torch.where(active, (-(1.0 + e_eff) * torch.clamp(vn_i, max=0.0) + bias[:, i])
                             / torch.clamp(w_n[:, i], min=1e-9), 0.0)
            vt = v_point - vn_i[:, None] * n_i
            vt_norm = torch.linalg.norm(vt, dim=-1)
            t_hat = vt / torch.clamp(vt_norm, min=1e-9)[:, None]
            w_t = torch.einsum("za,zav,zbv,zb->z", t_hat, J[:, i], MinvJT[:, i], t_hat)
            Pt = torch.where(active, torch.minimum(mu_i * Pn, vt_norm / torch.clamp(w_t, min=1e-9)),
                             0.0)
            s_i = _resting_smooth(dist[:, i], vn_i, self.bounce_threshold)
            P = (Pn[:, None] * n_i - Pt[:, None] * t_hat) * s_i[:, None]
            u = u + torch.einsum("zav,za->zv", MinvJT[:, i], P)
            P_rows.append(P)
        return u, torch.stack(P_rows, dim=1)

    def _art_vs_static_group(self, rt, grp: _GeomGroup, sgrp: _GeomGroup, root, dt_s):
        """An articulation's geoms (bounding spheres, or with exact link
        support their extent along each pair's normal) against one static
        group (``:1232-1340``), Baumgarte-stabilized, pair by pair. Returns
        (du, per-geom impulse sums (B,k,3), their moments about each geom
        body's origin)."""
        model = rt["slot"].model
        bp, bq = self._geom_poses(rt, grp)
        B, k, s = bp.shape[0], len(grp.link), len(sgrp.actor_index)
        centers = bp + rot.quat_rotate(bq, self._t(grp.offset_pos, bp).expand(B, k, 3))
        radii = self._t(grp.radius_bound, bp)
        roots = root[:, sgrp.actor_index]
        gpos = roots[..., 0:3] + rot.quat_rotate(
            roots[..., 3:7], self._t(sgrp.offset_pos, bp).expand(B, s, 3))
        gquat = rot.quat_mul(roots[..., 3:7], self._t(sgrp.offset_quat, bp).expand(B, s, 4))
        frame = self._frames_for_group(
            sgrp.kind, centers[:, :, None].expand(B, k, s, 3), radii[:, None],
            gpos[:, None].expand(B, k, s, 3), gquat[:, None].expand(B, k, s, 4), sgrp.size)
        dist = frame.dist.reshape(B, k * s)
        n = frame.normal.reshape(B, k * s, 3)
        points = frame.point.reshape(B, k * s, 3)
        kinds = grp.kinds if grp.kinds is not None else np.full(k, grp.kind)
        if (self.scene.spec.exact_link_support
                and np.any(np.isin(kinds, (U.GEOM_CYLINDER, U.GEOM_BOX)))):
            gq_geom = rot.quat_mul(bq, self._t(grp.offset_quat, bp).expand(B, k, 4))
            n_k = n.reshape(B, k, s, 3)
            size = self._t(grp.size, bp)
            unit = lambda i: self._t(np.eye(3, dtype=np.float32)[i], bp).expand(B, k, 3)
            axis = rot.quat_rotate(gq_geom, unit(2))
            na = torch.abs(torch.einsum("zksa,zka->zks", n_k, axis))
            sup_cyl = (na * size[:, 1:2]
                       + torch.sqrt(torch.clamp(1.0 - na * na, min=0.0)) * size[:, 0:1])
            sup_box = sum(torch.abs(torch.einsum("zksa,zka->zks", n_k,
                                                 rot.quat_rotate(gq_geom, unit(i))))
                          * size[:, i:i + 1] for i in range(3))
            is_cyl = torch.as_tensor(kinds == U.GEOM_CYLINDER, device=bp.device)[:, None]
            is_box = torch.as_tensor(kinds == U.GEOM_BOX, device=bp.device)[:, None]
            sup = torch.where(is_cyl, sup_cyl, torch.where(is_box, sup_box, radii[:, None]))
            sup = sup.reshape(B, k * s)
            dist = dist + radii.repeat_interleave(s) - sup
            points = centers.repeat_interleave(s, dim=1) - n * sup[..., None]
        J = D.point_jacobians(model, rt["frames"], rt["base_pos"],
                              np.repeat(np.asarray(grp.link), s), points)
        MinvJT = self._minv_jt(rt, J)
        bias = torch.clamp(0.2 / dt_s * torch.clamp(-dist - 0.005, min=0.0),
                           max=self.max_depenetration)
        e, mu = C.combine_material(
            self._t(np.repeat(grp.restitution, s), bp), self._t(np.tile(sgrp.restitution, k), bp),
            self._t(np.repeat(grp.friction, s), bp), self._t(np.tile(sgrp.friction, k), bp))
        w_n = torch.einsum("zka,zkav,zkbv,zkb->zk", n, J, MinvJT, n)
        u, P_all = self._sequential(rt, J, MinvJT, n, dist, bias, e, mu, w_n)
        borg = bp + rot.quat_rotate(bq, self._t(grp.body_off_pos, bp).expand(B, k, 3))
        tq_all = _cross(points - borg.repeat_interleave(s, dim=1), P_all)
        return (u - rt["u"], P_all.reshape(B, k, s, 3).sum(dim=2),
                tq_all.reshape(B, k, s, 3).sum(dim=2))

    def _build_art_art_pairs(self):
        """The build-time pair list of the link-vs-link narrowphase
        (``:1342-1442``): each articulated geom's bounding sphere against
        another's exact primitive, the side with the smaller bounding radius
        as the sphere. Left out: pairs within one articulation on the same
        or adjacent links (parent and child DOF, or a base-welded geom and a
        chain root); pairs of two fixed bases whose geoms cannot reach each
        other (the art-vs-static prune's chain-length bound); pairs where
        neither side can move; pairs overlapping at the rest pose (zero
        joint values), in either direction of the sphere-primitive test."""
        scene = self.scene
        geoms = []
        for g in scene.art_geoms:
            slot = scene.articulations[g.art_index]
            tree = slot.model.tree
            offp, offq = _compose(tree.body_ref_pos[g.body_index],
                                  tree.body_ref_quat[g.body_index], g.local_pos, g.local_quat)
            rb = float(g.size[0]) if g.kind == U.GEOM_SPHERE else float(np.max(g.size))
            geoms.append(dict(art=g.art_index, link=int(tree.body_ref_dof[g.body_index]),
                              off_pos=offp, off_quat=offq, kind=g.kind,
                              size=np.asarray(g.size, np.float32), e=float(g.restitution),
                              mu=float(g.friction), radius_bound=rb,
                              body=slot.body_start + g.body_index,
                              body_off=np.asarray(tree.body_ref_pos[g.body_index], np.float32)))
        # rest-pose world transforms: FK at zero joint values, in numpy
        world = []
        for g in geoms:
            slot = scene.articulations[g["art"]]
            tree = slot.model.tree
            init = scene.initial_root[slot.actor_index]
            p, q = np.asarray(init[0:3]), np.asarray(init[3:7])
            chain, d = [], g["link"]
            while d >= 0:
                chain.append(d)
                d = int(tree.dof_parent[d])
            for d in reversed(chain):
                p, q = _compose(p, q, tree.dof_pre_pos[d], tree.dof_pre_quat[d])
            world.append(_compose(p, q, g["off_pos"], g["off_quat"]))

        def adjacent(tree, la, lb):
            if la == lb:
                return True
            if la >= 0 and int(tree.dof_parent[la]) == lb:
                return True
            if lb >= 0 and int(tree.dof_parent[lb]) == la:
                return True
            if la < 0 and lb >= 0 and int(tree.dof_parent[lb]) < 0:
                return True
            return lb < 0 and la >= 0 and int(tree.dof_parent[la]) < 0

        def rest_dist(i, j):
            pj, qj = world[j]
            sg = dict(kind=geoms[j]["kind"], pos=pj, quat=qj, size=geoms[j]["size"])
            return F._point_geom_dist_np(world[i][0], sg) - geoms[i]["radius_bound"]

        pairs = []
        for i in range(len(geoms)):
            for j in range(i + 1, len(geoms)):
                a, b = geoms[i], geoms[j]
                sa, sb = scene.articulations[a["art"]], scene.articulations[b["art"]]
                if a["art"] == b["art"]:
                    if adjacent(sa.model.tree, a["link"], b["link"]):
                        continue
                elif not sa.model.floating and not sb.model.floating:
                    gap = float(np.linalg.norm(
                        np.asarray(scene.initial_root[sa.actor_index][0:3])
                        - np.asarray(scene.initial_root[sb.actor_index][0:3])))
                    if gap > (F._art_geom_reach_np(sa.model, a)
                              + F._art_geom_reach_np(sb.model, b) + 0.03):
                        continue
                a_mobile = a["link"] >= 0 or sa.model.floating
                b_mobile = b["link"] >= 0 or sb.model.floating
                if not (a_mobile or b_mobile):
                    continue
                if min(rest_dist(i, j), rest_dist(j, i)) < 0.005:
                    continue
                pairs.append((a, b) if a["radius_bound"] <= b["radius_bound"] else (b, a))
        return pairs

    def _link_point(self, rt, g, off):
        """Geom ``g``'s link (or base) frame applied to the link-frame point
        ``off`` (3,): ``(world point (B,3), the link's quat (B,4))``."""
        fp, fq = rt["frames"]
        if g["link"] < 0:
            bp, bq = rt["base_pos"], rt["base_quat"]
        else:
            bp, bq = fp[:, g["link"]], fq[:, g["link"]]
        return bp + rot.quat_rotate(bq, self._t(off, bp).expand_as(bp)), bq

    def _art_vs_art_pair(self, a, b, art_runtime, dt_s):
        """One link-vs-link contact (``:1443-1527``): geom ``a``'s bounding
        sphere against geom ``b``'s primitive, Baumgarte-stabilized, the
        impulse into both articulations' velocities (a pair within one
        articulation through the relative Jacobian and the shared factor).
        Updates ``rt["u"]`` and returns (P (B,3) on ``a``, the moments about
        ``a``'s and ``b``'s body origins)."""
        rta, rtb = art_runtime[a["art"]], art_runtime[b["art"]]
        ca, _ = self._link_point(rta, a, a["off_pos"])
        gp, bq = self._link_point(rtb, b, b["off_pos"])
        gq = rot.quat_mul(bq, self._t(b["off_quat"], bq).expand_as(bq))
        frame = self._frames_for_group(int(b["kind"]), ca[:, None], float(a["radius_bound"]),
                                       gp[:, None], gq[:, None], b["size"][None])
        dist, n, point = frame.dist[:, 0], frame.normal[:, 0], frame.point[:, 0]
        Ja = D.point_jacobians(rta["slot"].model, rta["frames"], rta["base_pos"],
                               np.asarray([a["link"]]), point[:, None])[:, 0]   # (B,3,nva)
        Jb = D.point_jacobians(rtb["slot"].model, rtb["frames"], rtb["base_pos"],
                               np.asarray([b["link"]]), point[:, None])[:, 0]
        same = a["art"] == b["art"]
        if same:
            Jrel = Ja - Jb
            Za = chol_solve(rta["chol"], Jrel.transpose(1, 2))                    # (B,nv,3)
            K = Jrel @ Za
            v_rel = torch.einsum("zav,zv->za", Jrel, rta["u"])
        else:
            Za = chol_solve(rta["chol"], Ja.transpose(1, 2))
            Zb = chol_solve(rtb["chol"], Jb.transpose(1, 2))
            K = Ja @ Za + Jb @ Zb
            v_rel = (torch.einsum("zav,zv->za", Ja, rta["u"])
                     - torch.einsum("zav,zv->za", Jb, rtb["u"]))
        vn = torch.sum(v_rel * n, dim=-1)
        active = (dist < 0.0) & (vn < 0.1)
        bias = torch.clamp(0.2 / dt_s * torch.clamp(-dist - 0.005, min=0.0),
                           max=self.max_depenetration)
        e, mu = C.combine_material(a["e"], b["e"], a["mu"], b["mu"])
        e_eff = torch.where(torch.abs(vn) > self.bounce_threshold, e, 0.0)
        w_n = torch.einsum("za,zab,zb->z", n, K, n)
        Pn = torch.where(active, (-(1.0 + e_eff) * torch.clamp(vn, max=0.0) + bias)
                         / torch.clamp(w_n, min=1e-9), 0.0)
        vt = v_rel - vn[:, None] * n
        vt_norm = torch.linalg.norm(vt, dim=-1)
        t_hat = vt / torch.clamp(vt_norm, min=1e-9)[:, None]
        w_t = torch.einsum("za,zab,zb->z", t_hat, K, t_hat)
        Pt = torch.where(active, torch.minimum(mu * Pn, vt_norm / torch.clamp(w_t, min=1e-9)),
                         0.0)
        P = Pn[:, None] * n - Pt[:, None] * t_hat
        rta["u"] = rta["u"] + torch.einsum("zva,za->zv", Za, P)
        if not same:
            rtb["u"] = rtb["u"] - torch.einsum("zva,za->zv", Zb, P)
        borg_a, _ = self._link_point(rta, a, a["body_off"])
        borg_b, _ = self._link_point(rtb, b, b["body_off"])
        return P, _cross(point - borg_a, P), _cross(point - borg_b, -P)

    def _art_vs_ground_group(self, rt, grp: _GeomGroup, dt_s):
        """An articulation's bounding spheres against the ground plane or the
        heightfield (``:1528-1583``), pair by pair; returns du."""
        model = rt["slot"].model
        bp, bq = self._geom_poses(rt, grp)
        B, k = bp.shape[0], len(grp.link)
        centers = bp + rot.quat_rotate(bq, self._t(grp.offset_pos, bp).expand(B, k, 3))
        radius = self._t(grp.radius_bound, bp)
        terr = self.scene.spec.terrain
        if terr is not None:
            h = terr.sample(centers[..., :2])
            n = terr.normal(centers[..., :2])
            dist = (centers[..., 2] - h) * n[..., 2] - radius
        else:
            dist = centers[..., 2] - radius
            n = torch.zeros_like(centers)
            n[..., 2] = 1.0
        points = centers - n * radius[:, None]
        J = D.point_jacobians(model, rt["frames"], rt["base_pos"], grp.link, points)
        MinvJT = self._minv_jt(rt, J)
        bias = torch.clamp(0.2 / dt_s * torch.clamp(-dist - 0.005, min=0.0),
                           max=self.max_depenetration)
        plane = self.scene.spec.plane
        e, mu = C.combine_material(0.0, plane.restitution, 0.8, plane.dynamic_friction)
        w_n = torch.einsum("zka,zkav,zkbv,zkb->zk", n, J, MinvJT, n)
        u, _ = self._sequential(rt, J, MinvJT, n, dist, bias, e, mu, w_n)
        return u - rt["u"]

    def rigid_body_states(self, state: SimState) -> torch.Tensor:
        """(B, num_bodies, 13) states of every body (``simulator.py:1589``)."""
        if self._all_bodies_fn is None:
            self._all_bodies_fn = self.make_body_state_fn(np.arange(self.scene.num_bodies))
        return self._all_bodies_fn(state)

    def make_body_state_fn(self, body_ids):
        """``state -> (B, len(body_ids), 13)`` for env-level body indices
        (``simulator.py:1589``); rows follow ``body_ids``."""
        scene = self.scene
        body_ids = np.asarray(body_ids)
        art_by_actor = {s.actor_index: s for s in scene.articulations}
        pieces, cursor = [], 0
        for ai, actor in enumerate(scene.spec.actors):
            nb = actor.tree.n_bodies
            sel = np.nonzero((body_ids >= cursor) & (body_ids < cursor + nb))[0]
            if len(sel):
                pieces.append((ai, art_by_actor.get(ai), body_ids[sel] - cursor, sel))
            cursor += nb
        order = np.concatenate([p[3] for p in pieces])
        inv_perm = np.argsort(order)
        identity = bool(np.all(inv_perm == np.arange(len(inv_perm))))
        inv_perm_t = torch.as_tensor(inv_perm, device=self.device)

        def body_states(state: SimState) -> torch.Tensor:
            parts = []
            for ai, slot, local_ids, _ in pieces:
                ra = state.root[:, ai]
                if slot is not None:
                    sl = slice(slot.dof_start, slot.dof_end)
                    # a floating base moves: its root velocity (``:1614-1618``)
                    vel = ((ra[:, 7:10], ra[:, 10:13]) if slot.model.floating
                           else (None, None))
                    parts.append(fk_body_states(slot.model.tree, ra[:, 0:3], ra[:, 3:7],
                                                state.dof_pos[:, sl], state.dof_vel[:, sl],
                                                *vel, body_ids=local_ids))
                else:
                    parts.append(ra[:, None].expand(-1, len(local_ids), -1))
            out = torch.cat(parts, dim=1)
            return out if identity else out[:, inv_perm_t]

        return body_states
