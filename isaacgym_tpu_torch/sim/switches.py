"""The physics switches: the JAX package's seven environment variables, as
one explicit option of the scene.

The JAX package reads each switch from the environment where it uses it
(the sites below). The port takes them as a frozen
:class:`PhysicsSwitches` that ``make(..., switches=)`` hands to the task,
which hands it to ``load_asset`` and to ``Simulator(scene, device,
switches=)``. Nothing below the simulator reads the environment: the
switches reach the kernels only through what the simulator packs for them.

Each variable (its JAX site), its field, and where it reaches in the port:

* ``ISAACGYM_TPU_BALL_KAPPA`` (``sim/simulator.py:91``), ``kappa``: a float
  forces every ball's spin-coupling ratio, None keeps ``m r^2 / I``; the
  non-kernel contacts and every kernel's ``C_KAPPA`` slots.
* ``ISAACGYM_TPU_ART_STATIC`` (``:104``), ``art_static``: the
  articulation-vs-static-geom narrowphase; the non-kernel contact phase,
  K2's and K3's pair lists (empty when off), K4's ``C_ART_STATIC``.
* ``ISAACGYM_TPU_CCD`` (``:140``), ``ccd``: off, a swept window of 0
  (penetration-only activation) in the non-kernel contact phase only. The
  kernels sweep over the substep whatever it says, as the JAX kernels do.
* ``ISAACGYM_TPU_PALLAS`` (``:276``), ``pallas``: off, no kernel (K1-K4)
  runs; ``route_for`` gives "nonkernel" on every device.
* ``ISAACGYM_TPU_TORQUE`` (``:321``), ``torque``: the kernels' moment lanes
  even on a scene with no force sensor (K2-tau, K2-dr-tau, K3-tau, K4-tau).
* ``ISAACGYM_TPU_REACH_PRUNE`` (``ops/pallas_dynamics.py:339``),
  ``reach_prune``: off, K2's and K3's build-time broadphase keeps every
  art-vs-static pair (more pairs in the pack, the same physics).
* ``ISAACGYM_TPU_NATIVE`` (``native/__init__.py:85``), ``native``: off,
  ``load_asset`` uses the Python URDF and MJCF parsers.

Timing: the JAX package reads ``ART_STATIC`` and ``CCD`` when it traces its
XLA step and the others when it builds the scene or its kernels. The port
reads all seven once, when the scene is built (:meth:`from_env`, called by
``make`` and the tools when the caller passes no switches); changing a
variable afterwards changes nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

#: the environment variable of each field
VARIABLES = {"kappa": "ISAACGYM_TPU_BALL_KAPPA", "art_static": "ISAACGYM_TPU_ART_STATIC",
             "ccd": "ISAACGYM_TPU_CCD", "pallas": "ISAACGYM_TPU_PALLAS",
             "torque": "ISAACGYM_TPU_TORQUE", "reach_prune": "ISAACGYM_TPU_REACH_PRUNE",
             "native": "ISAACGYM_TPU_NATIVE"}


@dataclasses.dataclass(frozen=True)
class PhysicsSwitches:
    """The seven switches; the defaults are the JAX package's."""
    kappa: Optional[float] = None
    art_static: bool = True
    ccd: bool = True
    pallas: bool = True
    torque: bool = False
    reach_prune: bool = True
    native: bool = True

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "PhysicsSwitches":
        """The switches the environment sets, by the JAX package's parse
        rules: a kappa is any float; ``ART_STATIC``, ``CCD``, ``PALLAS``,
        ``REACH_PRUNE`` and ``NATIVE`` are off only at "0"; ``TORQUE`` is on
        only at "1"."""
        env = os.environ if environ is None else environ
        get = lambda field, default=None: env.get(VARIABLES[field], default)
        kappa = get("kappa")
        return cls(kappa=None if kappa is None else float(kappa),
                   art_static=get("art_static", "1") != "0",
                   ccd=get("ccd", "1") != "0",
                   pallas=get("pallas", "1") != "0",
                   torque=get("torque") == "1",
                   reach_prune=get("reach_prune", "1") != "0",
                   native=get("native", "1") != "0")

    def ball_kappa(self, ball) -> float:
        """A free sphere's spin-coupling ratio ``m r^2 / I`` (0 when no
        inertia is recorded: spin decoupled), or the forced ``kappa``
        (``simulator.py:81-96``)."""
        if self.kappa is not None:
            return float(self.kappa)
        if getattr(ball, "inertia", 0.0) > 0.0:
            return float(ball.mass * ball.radius ** 2 / ball.inertia)
        return 0.0

    def ccd_dt(self, dt_s: float) -> float:
        """The swept-CCD window of the non-kernel contact phase
        (``_ccd_dt``, ``simulator.py:133-142``): one substep, or 0."""
        return dt_s if self.ccd else 0.0

    def report(self) -> dict:
        """The switches in force: ``pallas``, ``kappa_override`` and ``ccd``
        as ``tools/probe_ball.py:88-90`` reports them ("1" or "0"; the
        forced kappa, or None), the other four by field."""
        return {"pallas": "1" if self.pallas else "0",
                "kappa_override": self.kappa,
                "ccd": "1" if self.ccd else "0",
                "art_static": self.art_static, "torque": self.torque,
                "reach_prune": self.reach_prune, "native": self.native}


DEFAULT = PhysicsSwitches()
