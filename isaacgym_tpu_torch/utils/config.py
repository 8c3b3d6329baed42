"""Task configs for the port: resolved JSON files, no YAML.

``cfg/<Task>.json`` holds what the JAX package's YAML/OmegaConf-style loader
(``isaacgym_tpu/utils/config.py``, ``load_task_config``) returns for the
task, already resolved. The port reads it with the standard library alone;
``tests/test_torch_scene.py`` holds the two equal.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")


def load_task_config(task: str) -> Dict[str, Any]:
    """Resolved task config (the dict handed to the task class)."""
    path = os.path.join(CFG_DIR, f"{task}.json")
    if not os.path.exists(path):
        raise KeyError(f"no config for task {task!r} in {CFG_DIR}")
    with open(path) as f:
        return json.load(f)
