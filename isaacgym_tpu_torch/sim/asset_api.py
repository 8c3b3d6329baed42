"""The reference-named asset queries, force-sensor registration and handle
helpers (``isaacgym_tpu/sim/asset_api.py``).

An "asset" is the port's compiled :class:`KinematicTree`
(``models/kinematics.py``), a frozen numpy description, so every query is a
plain read of its tables. Handles are integer indices into the compiled
layout, the rows of the (B, num_bodies, ...) and (B, num_dofs) state
tensors.

Force sensors ride on the asset, as the reference registers them with
``create_asset_force_sensor`` before its actors are created: every actor made
from the asset inherits them, and :func:`scene_force_sensor_body_indices`
resolves them to env-level body rows in actor order. A scene that registers
any sensor is simulated with the kernels' moment rows (K2-tau, K3-tau), and
``tensor_api.acquire_force_sensor_tensor`` reads them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import KinematicTree, fk_dof_frames
from isaacgym_tpu_torch.utils import rotations as rot

# the reference's ``gymapi.DofType`` values
DOF_INVALID = 0
DOF_ROTATION = 1
DOF_TRANSLATION = 2

_DOF_TYPE_STRINGS = {DOF_INVALID: "DOF_INVALID", DOF_ROTATION: "DOF_ROTATION",
                     DOF_TRANSLATION: "DOF_TRANSLATION"}


# ---------------------------------------------------------------------------
# get_asset_* family
# ---------------------------------------------------------------------------

def get_asset_rigid_body_count(asset: KinematicTree) -> int:
    return asset.n_bodies


def get_asset_rigid_body_names(asset: KinematicTree) -> List[str]:
    return list(asset.body_names)


def get_asset_rigid_body_name(asset: KinematicTree, index: int) -> str:
    return asset.body_names[index]


def find_asset_rigid_body_index(asset: KinematicTree, name: str) -> int:
    """Index of the body called ``name``; -1 when absent, as gymapi."""
    try:
        return asset.body_index(name)
    except ValueError:
        return -1


def get_asset_dof_count(asset: KinematicTree) -> int:
    return asset.n_dof


def get_asset_dof_names(asset: KinematicTree) -> List[str]:
    return list(asset.dof_names)


def get_asset_dof_name(asset: KinematicTree, index: int) -> str:
    return asset.dof_names[index]


def get_asset_dof_type(asset: KinematicTree, index: int) -> int:
    """DOF_ROTATION for a revolute joint, DOF_TRANSLATION for a prismatic one."""
    t = int(asset.dof_type[index])
    if t == U.JOINT_REVOLUTE:
        return DOF_ROTATION
    if t == U.JOINT_PRISMATIC:
        return DOF_TRANSLATION
    return DOF_INVALID


def get_dof_type_string(dof_type: int) -> str:
    return _DOF_TYPE_STRINGS.get(int(dof_type), "DOF_INVALID")


def get_asset_joint_count(asset: KinematicTree) -> int:
    """Joints including fixed ones: every body but the root hangs off one."""
    return asset.n_bodies - 1


def get_asset_joint_names(asset: KinematicTree) -> List[str]:
    """Joints named by their child body, in the compiled body order."""
    return [asset.body_names[b] for b in range(asset.n_bodies) if int(asset.parent[b]) >= 0]


def get_asset_dof_properties(asset: KinematicTree) -> Dict[str, np.ndarray]:
    """Per-DOF arrays under gymapi's field names. Asset-level defaults: zero
    stiffness and ``driveMode`` 0 (DOF_MODE_NONE); an actor's gains and drive
    mode live on its ``ActorSpec`` (``tensor_api.get_actor_dof_properties``)."""
    n = asset.n_dof
    f32 = lambda a: np.asarray(a, np.float32).copy()
    return {"hasLimits": np.isfinite(asset.lower) & np.isfinite(asset.upper),
            "lower": f32(asset.lower), "upper": f32(asset.upper),
            "driveMode": np.zeros(n, np.int32), "velocity": f32(asset.max_velocity),
            "effort": f32(asset.effort), "stiffness": np.zeros(n, np.float32),
            "damping": f32(asset.damping), "friction": f32(asset.friction),
            "armature": f32(asset.armature)}


# ---------------------------------------------------------------------------
# force sensors
# ---------------------------------------------------------------------------

def create_asset_force_sensor(asset: KinematicTree, body_index: int,
                              local_pos=(0.0, 0.0, 0.0)) -> int:
    """Register a wrench sensor on ``body_index``; returns its index within
    the asset. The sensor reads the body's net contact force and its contact
    moment about the body's frame origin (``local_pos`` is kept for the
    reference's signature; the moment is not shifted to it)."""
    sensors = getattr(asset, "_force_sensors", None)
    if sensors is None:
        sensors = []
        object.__setattr__(asset, "_force_sensors", sensors)
    sensors.append((int(body_index), tuple(float(x) for x in local_pos)))
    return len(sensors) - 1


def get_asset_force_sensor_count(asset: KinematicTree) -> int:
    return len(getattr(asset, "_force_sensors", ()))


def scene_force_sensor_body_indices(scene) -> np.ndarray:
    """Env-level body rows of every force sensor of a compiled scene, in
    actor order (the reference orders its force-sensor tensor by actor
    creation): the sensors registered before the scene was compiled."""
    return np.asarray(scene.force_sensor_bodies, np.int64)


# ---------------------------------------------------------------------------
# env and actor handles
# ---------------------------------------------------------------------------

def get_env_origin(sim, env_id: int = 0) -> np.ndarray:
    """Every env is simulated in its own coordinates (the batch axis keeps
    them apart), so each origin is the world origin, as a (3,) array."""
    return np.zeros(3, np.float64)


def get_actor_dof_handle(sim, actor: Union[str, int], dof_index: int) -> int:
    """Env-level DOF row of ``actor``'s ``dof_index``."""
    from isaacgym_tpu_torch.sim.tensor_api import _dof_slice, _scene_of
    sl = _dof_slice(_scene_of(sim), actor)
    if dof_index < 0 or sl.start + dof_index >= sl.stop:
        raise IndexError(f"dof {dof_index} out of range for actor {actor!r}")
    return sl.start + dof_index


def get_dof_frame(sim, state, actor: Union[str, int], dof_index: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World origin and axis of one DOF at the current state, each (B, 3)."""
    from isaacgym_tpu_torch.sim.tensor_api import _dof_slice, _scene_of, get_actor_index
    scene = _scene_of(sim)
    ai = get_actor_index(scene, actor)
    slot = next(s for s in scene.articulations if s.actor_index == ai)
    tree = slot.model.tree
    q = state.dof_pos[:, _dof_slice(scene, actor)]
    pos, quat = fk_dof_frames(tree, state.root[:, ai, 0:3], state.root[:, ai, 3:7], q)
    axis = torch.as_tensor(np.asarray(tree.dof_axis[dof_index], np.float32), device=q.device)
    return pos[:, dof_index], rot.quat_rotate(quat[:, dof_index], axis.expand(q.shape[0], 3))


def add_ground(spec, plane_params=None) -> None:
    """Install the ground plane on a scene spec before it is compiled (the
    reference's ``gym.add_ground``); ``None`` installs the default plane."""
    from isaacgym_tpu_torch.sim.scene import PlaneParams
    spec.plane = plane_params if plane_params is not None else PlaneParams()
