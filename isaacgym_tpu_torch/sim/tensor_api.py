"""The reference-named tensor API over the port's batched state
(``isaacgym_tpu/sim/tensor_api.py``).

The reference hands out GPU buffers through ``acquire_*_tensor``, brings them
up to date with ``refresh_*_tensor`` and writes them back with ``set_*``. In
the port the state is a :class:`SimState` of tensors on the env's device:
an ``acquire_*`` call returns a view of it (or a tensor computed from it),
``refresh_*`` returns the state unchanged (it is always current), and every
``set_*`` returns a new state with the rows written, leaving its argument as
it was. Layouts are the reference's:

  root state   (B, num_actors, 13) = pos(3) + quat(4, xyzw) + linvel(3) + angvel(3)
  dof state    (B, num_dofs, 2)    = pos, vel
  rigid body   (B, num_bodies, 13)
  force sensor (B, n_sensors, 6)   = force(3) + torque(3)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np
import torch

from isaacgym_tpu_torch.sim.scene import CompiledScene, SceneSpec
from isaacgym_tpu_torch.sim.simulator import SimState, Simulator


def _ids(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=like.device)


def _val(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# acquire_* and refresh_*
# ---------------------------------------------------------------------------

def acquire_actor_root_state_tensor(state: SimState) -> torch.Tensor:
    """(B, num_actors, 13) root states (a view)."""
    return state.root


def acquire_dof_state_tensor(state: SimState) -> torch.Tensor:
    """(B, num_dofs, 2): position and velocity of every DOF."""
    return torch.stack([state.dof_pos, state.dof_vel], dim=-1)


def acquire_rigid_body_state_tensor(sim: Simulator, state: SimState) -> torch.Tensor:
    """(B, num_bodies, 13) rigid-body states, by forward kinematics."""
    return sim.rigid_body_states(state)


def acquire_dof_force_tensor(state: SimState) -> torch.Tensor:
    """(B, num_dofs) drive torques applied in the last substep."""
    return state.dof_force


def acquire_net_contact_force_tensor(state: SimState) -> torch.Tensor:
    """(B, num_bodies, 3) net contact force of every body over the last step."""
    return state.net_contact_force


def acquire_force_sensor_tensor(sim: Simulator, state: SimState,
                                body_indices=None) -> torch.Tensor:
    """(B, n_sensors, 6) wrenches: the body's net contact force, then its
    contact moment over the last step (``state.net_contact_torque``), about
    the body's frame origin (a ball's about its centre). The moments come
    from the kernels' torque lanes, which a scene with registered sensors is
    built with. ``body_indices`` are env-level body rows; by default every
    sensor registered with ``asset_api.create_asset_force_sensor``, in actor
    order."""
    if body_indices is None:
        body_indices = sim.scene.force_sensor_bodies
    rows = _ids(body_indices, state.net_contact_force)
    return torch.cat([state.net_contact_force[:, rows], state.net_contact_torque[:, rows]],
                     dim=-1)


def acquire_camera_image_tensor(camera, sim: Simulator, state: SimState,
                                image_type: str = "depth"):
    """Camera sensors are not ported yet (ROADMAP, module 12)."""
    raise NotImplementedError("camera sensors are not ported yet (ROADMAP, module 12)")


def refresh_all(state: SimState) -> SimState:
    """The ``refresh_*_tensor`` family: the state is always current."""
    return state


refresh_actor_root_state_tensor = refresh_all
refresh_dof_state_tensor = refresh_all
refresh_rigid_body_state_tensor = refresh_all
refresh_dof_force_tensor = refresh_all
refresh_net_contact_force_tensor = refresh_all
refresh_force_sensor_tensor = refresh_all


# ---------------------------------------------------------------------------
# set_* (a new state with the rows written)
# ---------------------------------------------------------------------------

def set_actor_root_state_tensor_indexed(state: SimState, values, env_ids,
                                        actor_ids=None) -> SimState:
    """Replace the root states of ``actor_ids`` (default: every actor) in
    ``env_ids``."""
    root = state.root.clone()
    envs = _ids(env_ids, root)
    if actor_ids is None:
        root[envs] = _val(values, root)
    else:
        root[envs[:, None], _ids(actor_ids, root)[None, :]] = _val(values, root)
    return state._replace(root=root)


def set_dof_state_tensor_indexed(state: SimState, dof_pos, dof_vel, env_ids) -> SimState:
    envs = _ids(env_ids, state.dof_pos)
    pos, vel = state.dof_pos.clone(), state.dof_vel.clone()
    pos[envs] = _val(dof_pos, pos)
    vel[envs] = _val(dof_vel, vel)
    return state._replace(dof_pos=pos, dof_vel=vel)


def set_dof_position_target_tensor(targets):
    """PD targets are an input of ``Simulator.step``: returned unchanged."""
    return targets


def set_dof_actuation_force_tensor(efforts):
    """Drive torques are an input of ``Simulator.step`` (effort drive)."""
    return efforts


def set_rigid_linear_velocity(state: SimState, actor_index: int, velocity) -> SimState:
    """Set a free actor's linear velocity in every env."""
    root = state.root.clone()
    root[:, actor_index, 7:10] = _val(velocity, root)
    return state._replace(root=root)


def set_rigid_angular_velocity(state: SimState, actor_index: int, velocity) -> SimState:
    """Set a free actor's angular velocity in every env."""
    root = state.root.clone()
    root[:, actor_index, 10:13] = _val(velocity, root)
    return state._replace(root=root)


def set_actor_root_state_tensor(state: SimState, values) -> SimState:
    """Replace every actor's root state in every env (broadcast)."""
    return state._replace(root=_val(values, state.root).expand_as(state.root).clone())


# ---------------------------------------------------------------------------
# handles: every env shares one layout, so a handle is an index into it
# ---------------------------------------------------------------------------

def _scene_of(obj: Union[Simulator, CompiledScene]) -> CompiledScene:
    return obj.scene if isinstance(obj, Simulator) else obj


def get_actor_index(sim: Union[Simulator, CompiledScene], actor: Union[str, int]) -> int:
    """Per-env actor index by name (the reference's DOMAIN_ENV index; a
    DOMAIN_SIM index is ``env_id * num_actors`` plus this)."""
    scene = _scene_of(sim)
    return actor if isinstance(actor, int) else scene.actor_names.index(actor)


def get_actor_rigid_body_names(sim, actor) -> List[str]:
    scene = _scene_of(sim)
    prefix = scene.actor_names[get_actor_index(scene, actor)] + "/"
    return [n[len(prefix):] for n in scene.body_names if n.startswith(prefix)]


def get_rigid_handle(sim, actor, body_name: str) -> int:
    """Env-level body row of ``actor``'s body ``body_name``: its row in the
    rigid-body, net-contact-force and torque tensors."""
    scene = _scene_of(sim)
    ai = get_actor_index(scene, actor)
    return scene.body_names.index(scene.actor_names[ai] + "/" + body_name)


find_actor_rigid_body_handle = get_rigid_handle
find_actor_rigid_body_index = get_rigid_handle


def _slot_of(scene: CompiledScene, actor):
    ai = get_actor_index(scene, actor)
    for slot in scene.articulations:
        if slot.actor_index == ai:
            return slot
    raise ValueError(f"actor {actor!r} has no DOFs")


def _dof_slice(scene: CompiledScene, actor) -> slice:
    slot = _slot_of(scene, actor)
    return slice(slot.dof_start, slot.dof_end)


def set_actor_dof_states(state: SimState, sim, actor, dof_pos, dof_vel,
                         env_ids=None) -> SimState:
    """Write one actor's DOF positions and velocities (every env, or
    ``env_ids``); the other actors' DOFs keep their values."""
    sl = _dof_slice(_scene_of(sim), actor)
    pos, vel = state.dof_pos.clone(), state.dof_vel.clone()
    envs = slice(None) if env_ids is None else _ids(env_ids, pos)
    pos[envs, sl] = _val(dof_pos, pos)
    vel[envs, sl] = _val(dof_vel, vel)
    return state._replace(dof_pos=pos, dof_vel=vel)


# ---------------------------------------------------------------------------
# shape and DOF properties: set on the scene spec before it is compiled, or
# at run time as per-env scales on the DR channel the step reads
# ---------------------------------------------------------------------------

@dataclass
class RigidShapeProperties:
    """The fields of ``gymapi.RigidShapeProperties`` the tasks use."""
    friction: float
    restitution: float


def get_actor_rigid_shape_properties(sim, actor) -> List[RigidShapeProperties]:
    """One entry per collision geom of the actor, articulated geoms first."""
    scene = _scene_of(sim)
    ai = get_actor_index(scene, actor)
    art = {slot.actor_index: i for i, slot in enumerate(scene.articulations)}
    props = [RigidShapeProperties(g.friction, g.restitution) for g in scene.art_geoms
             if ai in art and g.art_index == art[ai]]
    props += [RigidShapeProperties(g.friction, g.restitution) for g in scene.static_geoms
              if g.actor_index == ai]
    props += [RigidShapeProperties(fb.friction, fb.restitution) for fb in scene.free_bodies
              if fb.actor_index == ai]
    return props


def _spec_actor(spec: SceneSpec, actor):
    names = [a.name for a in spec.actors]
    return spec.actors[actor if isinstance(actor, int) else names.index(actor)]


def set_actor_rigid_shape_properties(spec: SceneSpec, actor,
                                     props: List[RigidShapeProperties]) -> None:
    """Set an actor's material on a scene spec before it is compiled; an
    actor has one material, so the first entry's is taken."""
    a = _spec_actor(spec, actor)
    a.friction = float(props[0].friction)
    a.restitution = float(props[0].restitution)


def get_actor_dof_properties(sim, actor) -> Dict[str, np.ndarray]:
    """An actor's per-DOF arrays under gymapi's field names."""
    slot = _slot_of(_scene_of(sim), actor)
    tree = slot.model.tree
    f32 = lambda a: np.asarray(a, np.float32).copy()
    return {"driveMode": np.full(tree.n_dof, slot.drive_mode, np.int32),
            "stiffness": f32(slot.stiffness), "damping": f32(slot.damping),
            "lower": f32(tree.lower), "upper": f32(tree.upper), "effort": f32(tree.effort),
            "velocity": f32(tree.max_velocity),
            "armature": f32(slot.model.armature[-tree.n_dof:])}


def set_actor_dof_properties(spec: SceneSpec, actor, props: Dict) -> None:
    """Set an actor's PD gains and drive mode on a scene spec before it is
    compiled."""
    a = _spec_actor(spec, actor)
    if "stiffness" in props:
        a.stiffness = np.asarray(props["stiffness"], np.float32)
    if "damping" in props:
        a.damping = np.asarray(props["damping"], np.float32)
    if "driveMode" in props:
        a.drive_mode = int(np.asarray(props["driveMode"]).reshape(-1)[0])


def runtime_shape_property_scales(sim: Simulator, dr, actor, friction=None,
                                  restitution=None):
    """Per-env friction or restitution of an articulated actor at run time,
    as the DR channel's scales of its compiled material. ``friction`` and
    ``restitution`` are absolute values, scalars or (B,); returns the new
    ``DRParams``."""
    base = get_actor_rigid_shape_properties(sim, actor)[0]
    if friction is not None:
        s = dr.friction_scale
        dr = dr._replace(friction_scale=(_val(friction, s) / max(base.friction, 1e-9))
                         .expand_as(s).clone())
    if restitution is not None:
        s = dr.restitution_scale
        dr = dr._replace(restitution_scale=(_val(restitution, s) / max(base.restitution, 1e-9))
                         .expand_as(s).clone())
    return dr


def runtime_dof_property_scales(sim: Simulator, dr, actor, stiffness=None, damping=None):
    """Per-env PD gains of an actor at run time, as the DR channel's scales
    of its compiled gains (absolute gains, scalar or (B, n_dof); a zero
    compiled gain stays zero)."""
    slot = _slot_of(sim.scene, actor)
    sl = slice(slot.dof_start, slot.dof_end)
    for name, value, base in (("kp_scale", stiffness, slot.stiffness),
                              ("kd_scale", damping, slot.damping)):
        if value is None:
            continue
        cur = getattr(dr, name)
        new = cur.clone()
        b = _val(np.where(base > 0, base, 1.0), cur)
        new[:, sl] = (_val(value, cur) / b).expand_as(new[:, sl])
        dr = dr._replace(**{name: new})
    return dr
