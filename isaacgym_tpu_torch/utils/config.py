"""Configs of the port: resolved JSON files and dotted overrides, no YAML.

``cfg/<Task>.json`` holds what the JAX package's YAML/OmegaConf-style loader
(``isaacgym_tpu/utils/config.py``, ``load_task_config``) returns for the
task, and ``cfg/train/<Task>PPO.json`` what its ``compose`` returns under
``train``, both already resolved. The port reads them with the standard
library alone; ``tests/test_torch_scene.py`` and ``tests/test_torch_ppo.py``
hold them equal to the JAX package's.

``compose`` adds the launcher's own keys and applies ``key=value``
overrides, the surface of ``python -m isaacgym_tpu_torch.train``:
  task.randomize=true   domain randomization on (the task's ``task.randomize``)
  num_envs=N            the task's ``env.numEnvs``
  max_iterations=N  seed=N  checkpoint=PATH  test=true  device=cpu|cuda
  experiment=NAME  sigma=X  episodes=N
and any other dotted path into the composed dict (``train.params.config.
learning_rate=1e-4``). Values parse as JSON where they can (``true``,
``3``, ``1e-4``) and stay strings otherwise.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")

#: launcher-level keys and their defaults (the JAX root config's, plus device)
LAUNCHER_DEFAULTS = {"experiment": "", "num_envs": "", "seed": 42, "max_iterations": "",
                     "test": False, "checkpoint": "", "sigma": "", "device": "cuda"}


def load_task_config(task: str) -> Dict[str, Any]:
    """Resolved task config (the dict handed to the task class)."""
    return _load(os.path.join(CFG_DIR, f"{task}.json"), task)


def load_train_config(task: str) -> Dict[str, Any]:
    """Resolved train config (rl_games format, ``params.*``)."""
    return _load(os.path.join(CFG_DIR, "train", f"{task}PPO.json"), task)


def _load(path: str, task: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise KeyError(f"no config for task {task!r} at {path}")
    with open(path) as f:
        return json.load(f)


def parse_value(text: str) -> Any:
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    try:
        return json.loads(text)
    except ValueError:
        return text


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides in place; returns ``cfg``."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, text = ov.partition("=")
        val = parse_value(text)
        if key == "num_envs":
            cfg["task"]["env"]["numEnvs"] = int(val)
        if key == "task.randomize":   # the task config's own ``task.randomize``
            key = "task.task.randomize"
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return cfg


def compose(task: str, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Task + train configs and the launcher keys, with overrides applied."""
    cfg = copy.deepcopy(LAUNCHER_DEFAULTS)
    cfg.update(task_name=task, task=load_task_config(task), train=load_train_config(task))
    return apply_overrides(cfg, list(overrides or []))
