"""Domain randomization, batched over envs (``isaacgym_tpu/env/randomize.py``).

The task config's ``randomization_params`` spec compiles into a sampler of
per-env :class:`DRParams` that ride in the env state and feed K2-dr, the
randomized fused substep. Terms, as in the JAX package:
  observations/actions: additive gaussian noise (range = [mean, std]),
  sim_params.gravity: additive gaussian on z only,
  actor_params.<first actor>.rigid_body_properties.mass: scaling uniform,
  .rigid_shape_properties.friction/restitution: scaling uniform,
  .dof_properties.stiffness/damping: scaling uniform, per DOF,
  .dof_properties.lower/upper: additive gaussian, per DOF.
Mass, friction and restitution are one scalar per env. A linear schedule
scales a term's deviation from the identity by ``min(step / schedule_steps,
1)``, so every scheduled term is the identity at step 0.

Draws come from the caller's ``torch.Generator``; the JAX package's per-env
keys give other numbers, so the two agree in distribution, not draw by draw.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


class DRParams(NamedTuple):
    """Per-env randomization parameters, batched: (B, ...)."""
    gravity_offset: torch.Tensor     # (B, 3)
    mass_scale: torch.Tensor         # (B,) on the articulated link masses
    friction_scale: torch.Tensor     # (B,)
    restitution_scale: torch.Tensor  # (B,)
    kp_scale: torch.Tensor           # (B, nD)
    kd_scale: torch.Tensor           # (B, nD)
    lower_shift: torch.Tensor        # (B, nD)
    upper_shift: torch.Tensor        # (B, nD)


def identity_params(num_dofs: int, batch: int, device="cpu") -> DRParams:
    z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=device)
    o = lambda *s: torch.ones((batch,) + s, dtype=torch.float32, device=device)
    return DRParams(gravity_offset=z(3), mass_scale=o(), friction_scale=o(),
                    restitution_scale=o(), kp_scale=o(num_dofs), kd_scale=o(num_dofs),
                    lower_shift=z(num_dofs), upper_shift=z(num_dofs))


def _sched(spec: Dict[str, Any], step: torch.Tensor) -> torch.Tensor:
    """Linear schedule factor in [0, 1] (reference schedule semantics)."""
    if spec.get("schedule") == "linear":
        n = float(spec.get("schedule_steps", 1))
        return torch.clamp(step.to(torch.float32) / n, max=1.0)
    return torch.ones((), dtype=torch.float32, device=step.device)


class DomainRandomizer:
    """Compiled sampler for one task's ``randomization_params`` spec."""

    def __init__(self, spec: Dict[str, Any], num_dofs: int):
        self.spec = spec or {}
        self.num_dofs = num_dofs
        self.frequency = int(self.spec.get("frequency", 600))
        obs_spec = self.spec.get("observations", {})
        act_spec = self.spec.get("actions", {})
        self.obs_noise = float(obs_spec.get("range", [0, 0])[1]) if obs_spec else 0.0
        self.act_noise = float(act_spec.get("range", [0, 0])[1]) if act_spec else 0.0
        self.gravity_spec = self.spec.get("sim_params", {}).get("gravity")
        # first actor entry = the humanoid (the reference randomizes 'humanoid')
        actors = self.spec.get("actor_params", {})
        self.actor_spec = next(iter(actors.values())) if actors else {}

    def sample(self, generator: torch.Generator, global_step, batch: int) -> DRParams:
        """``batch`` envs' DRParams at ``global_step`` (an int or a 0-d
        tensor on the generator's device; no host sync)."""
        dev = generator.device
        step = torch.as_tensor(global_step, device=dev)
        nd = self.num_dofs
        p = identity_params(nd, batch, dev)

        def uniform(spec, shape):
            lo, hi = (float(v) for v in spec["range"])
            u = torch.rand(shape, generator=generator, device=dev)
            return 1.0 + ((lo + (hi - lo) * u) - 1.0) * _sched(spec, step)

        def gauss(spec, shape):
            n = torch.randn(shape, generator=generator, device=dev)
            return n * float(spec["range"][1]) * _sched(spec, step)

        if self.gravity_spec is not None:
            gz = gauss(self.gravity_spec, (batch,))
            p = p._replace(gravity_offset=torch.stack(
                [torch.zeros_like(gz), torch.zeros_like(gz), gz], dim=-1))
        rb = self.actor_spec.get("rigid_body_properties", {})
        if "mass" in rb:
            p = p._replace(mass_scale=uniform(rb["mass"], (batch,)))
        rs = self.actor_spec.get("rigid_shape_properties", {})
        if "friction" in rs:
            p = p._replace(friction_scale=uniform(rs["friction"], (batch,)))
        if "restitution" in rs:
            p = p._replace(restitution_scale=uniform(rs["restitution"], (batch,)))
        dp = self.actor_spec.get("dof_properties", {})
        if "stiffness" in dp:
            p = p._replace(kp_scale=uniform(dp["stiffness"], (batch, nd)))
        if "damping" in dp:
            p = p._replace(kd_scale=uniform(dp["damping"], (batch, nd)))
        if "lower" in dp:
            p = p._replace(lower_shift=gauss(dp["lower"], (batch, nd)))
        if "upper" in dp:
            p = p._replace(upper_shift=gauss(dp["upper"], (batch, nd)))
        return p

    def observation_noise(self, generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        if self.obs_noise <= 0.0:
            return obs
        return obs + torch.randn(obs.shape, generator=generator,
                                 device=obs.device) * self.obs_noise

    def action_noise(self, generator: torch.Generator, actions: torch.Tensor) -> torch.Tensor:
        if self.act_noise <= 0.0:
            return actions
        return actions + torch.randn(actions.shape, generator=generator,
                                     device=actions.device) * self.act_noise
