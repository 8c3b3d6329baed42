"""Batched simulator for the pingpong scene classes, on the fused-substep kernels.

Counterpart of ``isaacgym_tpu/sim/simulator.py``'s fused paths: ``step`` ->
``_step_batched_pallas`` (``:626``), run ``substeps`` times, with the
ball-quaternion integration and the net-contact-force writeback. Routing as
``_maybe_build_fused`` (``:435-566``) does it:

* one position-driven fixed-base humanoid and one ball (the flagship, C6):
  ``_substep_fused`` (``:686-734``), one K2 launch per substep; given
  ``DRParams`` (``step_dr``, ``:594-624``), K2-dr instead;
* K fixed-base articulations (position or effort drive) and up to two balls
  (C8): ``_substep_fused_multi`` (``:643-684``), one K3 launch per substep.
  The JAX package randomizes such scenes only on its non-kernel path, so
  ``step`` with ``dr`` raises here;
* one floating-base articulation (revolute and prismatic DOFs, at most 32)
  with one ball over the plane and no terrain or link collision (C10, the
  gate of ``_maybe_build_pallas``, ``:288-295``): ``_substep_fused_floating``
  (``:388-433``), one K4 launch per substep, which writes back the base's
  root, the ball's root (quaternion by ``_integrate_quat``), the DOF state
  and the impulse rows into ``net_contact_force``. The JAX package
  randomizes such scenes and runs their force sensors only on other paths
  (``:594-624``; K4-tau), so DR and sensors raise here.

A scene that registers a force sensor (``asset_api.create_asset_force_sensor``
before it is compiled) is stepped through the kernels' torque-lane builds,
K2-tau (K2-dr-tau under DR) and K3-tau (``_sensors_want_torque``,
``:313-321``): their moment rows are written into ``net_contact_torque``, at
each articulated geom's body its contact moments about the body's frame
origin and at each ball its moments about its centre (``:653-684``,
``:710-733``). Sensor-less scenes build the kernels without those lanes and
leave ``net_contact_torque`` at zero.

State layout (the reference tensor-API contract), batched over B envs:
  root (B, num_actors, 13) = pos(3) + quat(4, xyzw) + linvel(3) + angvel(3),
  dof_pos / dof_vel / dof_force (B, num_dofs), net contact force and torque
  (B, num_bodies, 3).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the non-kernel path for other scene classes and for DR on
multi-articulation and floating-base scenes, force sensors on a
floating-base scene (K4-tau), link-vs-link contacts, terrain. The JAX
package also guards the kernels' folded base and static poses
(``_baked_roots_moved``, ``:568``) in ``step`` and ``step_dr`` and falls
back to its XLA path when a root is rewritten at run time; the port has no
such path yet, and nothing in the port moves a baked root (the reset writes
``initial_root``), so the guard is left out (ROADMAP, modules). K4 folds
only the true statics (table, net), which nothing moves either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.env.randomize import DRParams
from isaacgym_tpu_torch.models.kinematics import _qmul, _qrot, fk_body_states
from isaacgym_tpu_torch.ops.fused_substep import FusedSubstep, build_constants
from isaacgym_tpu_torch.ops.fused_substep_floating import (
    FusedSubstepFloating, build_floating_constants,
)
from isaacgym_tpu_torch.ops.fused_substep_multi import FusedSubstepMulti, build_multi_constants
from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS, CompiledScene
from isaacgym_tpu_torch.utils import rotations as rot


MULTI_DR_REFUSAL = ("domain randomization of a multi-articulation scene is not ported: the "
                    "JAX package runs it on its non-kernel path (ROADMAP, module 10)")
FLOATING_DR_REFUSAL = ("domain randomization of a floating-base scene is not ported: the JAX "
                       "package runs it on its non-kernel path, simulator.py:594-624 "
                       "(ROADMAP, module 10)")
FLOATING_SENSOR_REFUSAL = ("force sensors on a floating-base scene are not ported: they need "
                           "K4-tau, the torque-lane build of K4 (ROADMAP, queued)")


class SimState(NamedTuple):
    root: torch.Tensor                # (B, num_actors, 13)
    dof_pos: torch.Tensor             # (B, num_dofs)
    dof_vel: torch.Tensor             # (B, num_dofs)
    dof_force: torch.Tensor           # (B, num_dofs) last applied drive torque
    net_contact_force: torch.Tensor   # (B, num_bodies, 3)
    net_contact_torque: torch.Tensor  # (B, num_bodies, 3)


def _integrate_quat(quat, omega, dt):
    """Free-body orientation update q += dt/2 [w,0] o q, normalized."""
    wq = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    q2 = quat + 0.5 * dt * rot.quat_mul(wq, quat)
    return q2 / torch.linalg.norm(q2, dim=-1, keepdim=True)


def _ball_kappa(ball) -> float:
    """Spin-coupling ratio kappa = m r^2 / I of a free sphere; 0 when no
    inertia is recorded (spin decoupled)."""
    if getattr(ball, "inertia", 0.0) > 0.0:
        return float(ball.mass * ball.radius ** 2 / ball.inertia)
    return 0.0


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


def fused_ball_cfg(scene: CompiledScene, index: int = 0) -> dict:
    ball, plane = scene.free_bodies[index], scene.spec.plane
    return dict(mass=ball.mass, radius=ball.radius, restitution=ball.restitution,
                friction=ball.friction, plane_e=plane.restitution,
                plane_mu=plane.dynamic_friction, max_lin=ball.max_linear_velocity,
                max_ang=ball.max_angular_velocity, lin_damp=ball.linear_damping,
                ang_damp=ball.angular_damping, drag_k=ball.drag_k,
                magnus_k=ball.magnus_k, kappa=_ball_kappa(ball))


class Simulator:
    """Compiled simulator for one pingpong-class scene on one device."""

    def __init__(self, scene: CompiledScene, device="cuda"):
        self.scene = scene
        self.device = torch.device(device)
        spec = scene.spec
        self.dt = float(spec.dt)
        self.substeps = int(spec.substeps)
        arts = scene.articulations
        flat = (bool(arts) and bool(scene.free_bodies) and spec.terrain is None
                and spec.plane is not None and not spec.link_collision
                and all(s.drive_mode in (DRIVE_POS, DRIVE_EFFORT) for s in arts))
        # one floating articulation with one ball: K4 (``:288-295``)
        floating = (flat and len(arts) == 1 and len(scene.free_bodies) == 1
                    and arts[0].model.floating and arts[0].model.tree.n_dof <= 32
                    and bool(np.all((arts[0].model.tree.dof_type == U.JOINT_REVOLUTE)
                                    | (arts[0].model.tree.dof_type == U.JOINT_PRISMATIC))))
        if not flat or (any(s.model.floating for s in arts) and not floating):
            raise NotImplementedError(
                "the port simulates fixed-base articulations with balls, or one floating-base "
                "articulation with one ball, over a flat plane on the fused kernels "
                "(ROADMAP, modules 8-11)")
        gravity = np.asarray(spec.gravity, np.float32)
        dt_s = self.dt / self.substeps
        #: the kernels carry the torque lanes only for a scene with sensors
        self.with_torque = self._sensors_want_torque()
        self._all_bodies_fn = None   # rigid_body_states, built at first use
        #: K2 and K2-dr (one humanoid, one ball), K3 (fixed bases otherwise)
        #: or K4 (a floating base); the others are None. Each wrapper's
        #: ``launches`` counts its launches.
        self.fused_substep = self.fused_substep_dr = self.fused_substep_multi = None
        self.fused_substep_floating = None
        if floating:
            if self.with_torque:
                raise NotImplementedError(FLOATING_SENSOR_REFUSAL)
            self.slot, self.ball = arts[0], scene.free_bodies[0]
            static_list, art_list, self.art_bodies = floating_geom_lists(scene)
            self._art_bodies_t = torch.as_tensor(self.art_bodies, device=self.device)
            self.constants = build_floating_constants(
                self.slot.model, self.slot.stiffness, self.slot.damping, gravity, dt_s,
                fused_ball_cfg(scene), static_list, art_list,
                dict(e=spec.plane.restitution, mu=spec.plane.dynamic_friction,
                     max_depen=float(spec.max_depenetration_velocity)),
                bounce_threshold=float(spec.bounce_threshold_velocity),
                drive_mode=self.slot.drive_mode,
                max_angular_velocity=self.slot.max_angular_velocity,
                max_linear_velocity=self.slot.max_linear_velocity,
                exact_support=bool(spec.exact_link_support))
            self.fused_substep_floating = FusedSubstepFloating(self.constants)
            return
        static_list, n_true, art_list, self.art_bodies = fused_geom_lists(scene)
        common = dict(bounce_threshold=float(spec.bounce_threshold_velocity),
                      n_true_static=n_true,
                      max_depenetration=float(spec.max_depenetration_velocity),
                      exact_support=bool(spec.exact_link_support))
        self._art_bodies_t = torch.as_tensor(self.art_bodies, device=self.device)
        if len(arts) == 1 and len(scene.free_bodies) == 1 and arts[0].drive_mode == DRIVE_POS:
            self.slot = arts[0]
            self.ball = scene.free_bodies[0]
            init = scene.initial_root[self.slot.actor_index]
            self.constants = build_constants(
                self.slot.model, init[0:3], init[3:7], self.slot.stiffness,
                self.slot.damping, gravity, dt_s, fused_ball_cfg(scene), static_list,
                art_list, **common)
            self.fused_substep = FusedSubstep(self.constants, with_torque=self.with_torque)
            self.fused_substep_dr = FusedSubstep(self.constants, with_dr=True,
                                                 with_torque=self.with_torque)
        else:
            spec_of = lambda sl: dict(
                model=sl.model, base_pos=scene.initial_root[sl.actor_index][0:3],
                base_quat=scene.initial_root[sl.actor_index][3:7], kp=sl.stiffness,
                kd=sl.damping, drive_mode=sl.drive_mode)
            self.constants = build_multi_constants(
                [spec_of(sl) for sl in arts],
                [fused_ball_cfg(scene, i) for i in range(len(scene.free_bodies))],
                static_list, art_list, gravity, dt_s, **common)
            self.fused_substep_multi = FusedSubstepMulti(self.constants,
                                                         with_torque=self.with_torque)
            fb = scene.free_bodies
            self._ball_actors_t = torch.as_tensor([b.actor_index for b in fb],
                                                  device=self.device)
            self._ball_bodies_t = torch.as_tensor([b.body_start for b in fb],
                                                  device=self.device)

    def _sensors_want_torque(self) -> bool:
        """Whether the scene registers a force sensor
        (``simulator.py:313-321``): only then are the kernels built with
        their moment rows, so sensor-less scenes do no moment arithmetic."""
        return self.scene.force_sensor_bodies.size > 0

    def initial_state(self, batch: int) -> SimState:
        sc, dev = self.scene, self.device
        z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=dev)
        root = torch.as_tensor(sc.initial_root, device=dev).expand(batch, -1, -1).clone()
        return SimState(root, z(sc.num_dofs), z(sc.num_dofs), z(sc.num_dofs),
                        z(sc.num_bodies, 3), z(sc.num_bodies, 3))

    def step(self, state: SimState, targets, efforts, dr: DRParams = None) -> SimState:
        """One env step: ``substeps`` fused substeps, contact forces reset.
        With ``dr``, every substep runs K2-dr on the per-env channel packed
        in the JAX package's order (kp, kd, lower, upper, mass, gravity
        offset, friction, restitution); without, K2, or K3 on a
        multi-articulation scene, or K4 on a floating-base one. The
        baked-root guard is left out (module docstring)."""
        dt_s = self.dt / self.substeps
        state = state._replace(net_contact_force=torch.zeros_like(state.net_contact_force),
                               net_contact_torque=torch.zeros_like(state.net_contact_torque))
        if self.fused_substep_floating is not None:
            if dr is not None:
                raise NotImplementedError(FLOATING_DR_REFUSAL)
            for _ in range(self.substeps):
                state = self._substep_fused_floating(state, targets, efforts, dt_s)
            return state
        if self.fused_substep_multi is not None:
            if dr is not None:
                raise NotImplementedError(MULTI_DR_REFUSAL)
            for _ in range(self.substeps):
                state = self._substep_fused_multi(state, targets, efforts, dt_s)
            return state
        dr_chan = None if dr is None else self.dr_channel(dr)
        for _ in range(self.substeps):
            state = self._substep_fused(state, targets, efforts, dt_s, dr_chan=dr_chan)
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
        """One K4 launch (``simulator.py:388-433``): the base's and the ball's
        roots, the DOF state, and the impulse rows into ``net_contact_force``
        (each articulated geom's body, then the ball's total)."""
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
        dof_pos, dof_vel, dof_force = (state.dof_pos.clone(), state.dof_vel.clone(),
                                       state.dof_force.clone())
        dof_pos[:, sl] = out.q_new
        dof_vel[:, sl] = out.qd_new
        dof_force[:, sl] = out.tau
        return SimState(root, dof_pos, dof_vel, dof_force, ncf, state.net_contact_torque)

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
