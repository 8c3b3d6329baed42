"""Carry state and weights across between the JAX package and the port.

The arrays of the JAX package's ``SimState``, ``EnvState`` (with its
domain-randomization fields), ``DRParams``, ``RunningStats`` and flax
actor-critic parameters, handed over as numpy, become the port's tensors and
modules, so a check can start both packages from one state and one set of
weights, for every task of the port (C10's floating base rides in its root
row; its policy is obs 313, act 27). ``SimState`` carries the contact
moments (``net_contact_torque``) with the forces. The force sensors registered on a JAX asset
(``create_asset_force_sensor``, kept on the asset as ``_force_sensors``)
carry over to the port's asset with :func:`copy_force_sensors`. The JAX
package's per-env PRNG keys have no counterpart (the port keeps one
``torch.Generator`` per env object) and are dropped.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from isaacgym_tpu_torch.env.randomize import DRParams
from isaacgym_tpu_torch.env.vec_task import EnvState
from isaacgym_tpu_torch.rl.normalizer import RunningStats
from isaacgym_tpu_torch.sim.simulator import SimState


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def sim_state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> SimState:
    """``{root, dof_pos, dof_vel, dof_force, net_contact_force,
    net_contact_torque}`` (batched numpy) -> :class:`SimState`."""
    return SimState(**{f: _t(d[f], device, torch.float32) for f in SimState._fields})


def dr_params_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> DRParams:
    """Batched ``DRParams`` fields (numpy) -> :class:`DRParams`."""
    return DRParams(**{f: _t(d[f], device, torch.float32) for f in DRParams._fields})


def env_state_from_numpy(d: Dict[str, Any], device="cpu") -> EnvState:
    """``{sim: {...}, progress, flags: {...}, pre_ball_root, ep_return}`` and,
    with DR, ``dr: {...}``, ``randomize_buf``, ``global_step`` ->
    :class:`EnvState` (an ``rng`` entry, if present, is ignored)."""
    dr = d.get("dr")
    return EnvState(
        sim=sim_state_from_numpy(d["sim"], device),
        progress=_t(d["progress"], device, torch.int32),
        flags={k: _t(v, device, torch.bool) for k, v in d["flags"].items()},
        pre_ball_root=_t(d["pre_ball_root"], device, torch.float32),
        ep_return=_t(d["ep_return"], device, torch.float32),
        dr=None if dr is None else dr_params_from_numpy(dr, device),
        randomize_buf=(None if d.get("randomize_buf") is None
                       else _t(d["randomize_buf"], device, torch.int32)),
        global_step=(None if d.get("global_step") is None
                     else _t(d["global_step"], device, torch.int32)),
    )


def running_stats_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> RunningStats:
    """``{mean, var, count}`` -> :class:`RunningStats`."""
    return RunningStats(**{f: _t(d[f], device, torch.float32) for f in RunningStats._fields})


def actor_critic_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``ActorCritic`` parameters as numpy -> the port's ``state_dict``.

    ``params_np`` is ``{"params": {"actor_mlp": {"Dense_i": {kernel, bias}},
    "critic_mlp": ..., "mu": {...}, "value": {...}, "log_sigma": (A,)}}`` (the
    outer ``params`` level may be omitted). A flax kernel is ``(in, out)``;
    ``nn.Linear.weight`` is ``(out, in)``, so kernels are transposed."""
    p = params_np.get("params", params_np)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    out = {}
    for trunk in ("actor_mlp", "critic_mlp"):
        if trunk not in p:
            continue
        for name, dense in p[trunk].items():
            i = int(name.split("_")[-1])
            out[f"{trunk}.layers.{i}.weight"] = f32(dense["kernel"]).t().contiguous()
            out[f"{trunk}.layers.{i}.bias"] = f32(dense["bias"])
    for head in ("mu", "value"):
        out[f"{head}.weight"] = f32(p[head]["kernel"]).t().contiguous()
        out[f"{head}.bias"] = f32(p[head]["bias"])
    out["log_sigma"] = f32(p["log_sigma"])
    return out


def copy_force_sensors(src_asset, dst_asset) -> int:
    """Register on ``dst_asset`` (the port's ``KinematicTree``) every force
    sensor registered on ``src_asset`` (the JAX package's), in order; returns
    how many. Both assets must be the same model."""
    from isaacgym_tpu_torch.sim.asset_api import create_asset_force_sensor
    if tuple(src_asset.body_names) != tuple(dst_asset.body_names):
        raise ValueError("copy_force_sensors: the assets' bodies differ")
    sensors = list(getattr(src_asset, "_force_sensors", ()))
    for body, local_pos in sensors:
        create_asset_force_sensor(dst_asset, body, local_pos)
    return len(sensors)


def to_numpy(state) -> Dict[str, Any]:
    """A :class:`SimState`, :class:`EnvState`, :class:`DRParams` or
    :class:`RunningStats` (nested) -> numpy dicts (``None`` fields stay)."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    return {f: to_numpy(getattr(state, f)) for f in state._fields}
