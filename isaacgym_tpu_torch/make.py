"""Environment factory of the port (``isaacgym_tpu/make.py``)."""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional


def make(seed: int, task: str, num_envs: Optional[int] = None, device: str = "cuda",
         cfg: Optional[Mapping[str, Any]] = None, switches=None, **overrides):
    """Create a vectorized pingpong environment by registered task name.

    Runs on the card unless ``device="cpu"``; ``device="cuda"`` with no GPU
    raises. ``switches`` (``sim/switches.PhysicsSwitches``) sets the physics
    switches; by default they are read from the environment's
    ``ISAACGYM_TPU_*`` variables, once, as the JAX package reads them."""
    from isaacgym_tpu_torch.sim.switches import PhysicsSwitches
    from isaacgym_tpu_torch.tasks import task_registry
    from isaacgym_tpu_torch.utils.config import load_task_config

    registry = task_registry()
    if task not in registry:
        raise KeyError(f"unknown task {task!r}; known: {sorted(registry)}")
    task_cfg = copy.deepcopy(dict(cfg)) if cfg is not None else load_task_config(task)
    if num_envs is not None:
        task_cfg["env"]["numEnvs"] = int(num_envs)
    for key, val in overrides.items():
        task_cfg["env"][key] = val
    if switches is None:
        switches = PhysicsSwitches.from_env()
    return registry[task](task_cfg, seed=seed, device=device, switches=switches)
