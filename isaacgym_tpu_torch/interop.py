"""Carry state across between the JAX package and the port.

For this system the "weights" are the simulator state and the scene
constants. These functions turn the arrays of the JAX package's ``SimState``
and ``EnvState``, handed over as numpy (``{field: np.ndarray}``), into the
port's tensors and back, so a check can start both packages from one state.
The JAX package's per-env PRNG keys have no counterpart (the port keeps one
``torch.Generator`` per env object) and are dropped.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from isaacgym_tpu_torch.env.vec_task import EnvState
from isaacgym_tpu_torch.sim.simulator import SimState


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def sim_state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> SimState:
    """``{root, dof_pos, dof_vel, dof_force, net_contact_force,
    net_contact_torque}`` (batched numpy) -> :class:`SimState`."""
    return SimState(**{f: _t(d[f], device, torch.float32) for f in SimState._fields})


def env_state_from_numpy(d: Dict[str, Any], device="cpu") -> EnvState:
    """``{sim: {...}, progress, flags: {...}, pre_ball_root, ep_return}`` ->
    :class:`EnvState` (an ``rng`` entry, if present, is ignored)."""
    return EnvState(
        sim=sim_state_from_numpy(d["sim"], device),
        progress=_t(d["progress"], device, torch.int32),
        flags={k: _t(v, device, torch.bool) for k, v in d["flags"].items()},
        pre_ball_root=_t(d["pre_ball_root"], device, torch.float32),
        ep_return=_t(d["ep_return"], device, torch.float32),
    )


def to_numpy(state) -> Dict[str, Any]:
    """A :class:`SimState` or :class:`EnvState` (nested) -> numpy dicts."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    return {f: to_numpy(getattr(state, f)) for f in state._fields}
