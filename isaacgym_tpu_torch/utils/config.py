"""Configs of the port: resolved JSON files and dotted overrides, no YAML.

``cfg/<Task>.json`` holds what the JAX package's YAML/OmegaConf-style loader
(``isaacgym_tpu/utils/config.py``, ``load_task_config``) returns for the
task, and ``cfg/train/<Task>PPO.json`` what its ``compose`` returns under
``train``, both already resolved. The port reads them with the standard
library alone; ``tests/test_torch_scene.py`` and ``tests/test_torch_ppo.py``
hold them equal to the JAX package's.

``cfg/interpolations.json`` (written from the YAMLs by
``tools/torch_cfg_export.py``) holds the JAX root config and, for each
task, the leaves of the task and train configs that the YAMLs interpolate
(``numEnvs: ${resolve_default:4,${...num_envs}}``) with their expressions.
``compose`` puts those expressions back, applies the ``key=value``
overrides and resolves them as the JAX loader does (``resolve_default``,
``eq``, ``contains``, ``if`` and relative ``${..x}`` references), so a
root-level key reaches the task where the YAML routes it:
  num_envs=N  seed=N  max_iterations=N  checkpoint=PATH  test=true
  experiment=NAME  and the reward hooks alpha_velocity_reward,
  power_coefficient, penalty, hit_reward, hit_penalty, cross_net_reward,
  landing_shaping, die_penalty, two_player (an empty value keeps the task's
  default)
besides the port's own ``device=cpu|cuda``, ``sigma=X``, ``episodes=N``,
``task.randomize=true`` (the task config's own ``task.randomize``) and any
other dotted path into the composed dict (``train.params.config.
learning_rate=1e-4``). Values parse as JSON where they can (``true``,
``3``, ``1e-4``) and stay strings otherwise; where the JAX loader's YAML
parse differs (``1e-4`` stays a string there), the configs' readers take
either.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")

#: the port's own launcher keys besides the JAX root config's
PORT_DEFAULTS = {"device": "cuda", "sigma": ""}

_RESOLVER_RE = re.compile(r"\$\{([^{}]+)\}")


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
    """An override's value: JSON where it parses, ``None`` where empty (as
    the JAX loader's YAML parse), else the string."""
    if not text.strip():
        return None
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
        if key == "task.randomize":   # the task config's own ``task.randomize``
            key = "task.task.randomize"
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(text)
    return cfg


def interpolations() -> Dict[str, Any]:
    """The root config and each task's interpolated leaves (``cfg/interpolations.json``)."""
    with open(os.path.join(CFG_DIR, "interpolations.json")) as f:
        return json.load(f)


def compose(task: str, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """Root, task and train configs with the overrides applied, then resolved
    (the JAX ``compose``: load, override, resolve)."""
    table = interpolations()
    if task not in table["tasks"]:
        raise KeyError(f"no config for task {task!r}")
    cfg = copy.deepcopy(table["root"])
    cfg.update(PORT_DEFAULTS)
    cfg.update(task_name=task, task=load_task_config(task), train=load_train_config(task))
    for section, leaves in table["tasks"][task].items():
        for path, expr in leaves.items():
            node = cfg[section]
            *head, last = path.split(".")
            for p in head:
                node = node[p]
            node[last] = expr
    apply_overrides(cfg, list(overrides or []))
    return resolve(cfg)


# -- the JAX loader's resolver (``isaacgym_tpu/utils/config.py``) ----------

def _lookup(root: Dict[str, Any], path: str, node_path: List[str]):
    """A dotted reference; leading dots climb from the node (``${..x}``)."""
    if path.startswith("."):
        ups = len(path) - len(path.lstrip("."))
        rel = path.lstrip(".")
        parts = node_path[: max(0, len(node_path) - ups)] + (rel.split(".") if rel else [])
    else:
        parts = path.split(".")
    node: Any = root
    for p in parts:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"config interpolation ${{{path}}} not found")
        node = node[p]
    return node, parts


def _split_args(body: str) -> List[str]:
    """Resolver arguments, split on the commas outside ``${...}``."""
    args, depth, cur = [], 0, []
    for ch in body:
        depth += (ch == "{") - (ch == "}")
        if ch == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    args.append("".join(cur))
    return [a.strip() for a in args]


def _resolve_value(value: Any, root: Dict[str, Any], node_path: List[str]) -> Any:
    if isinstance(value, str):
        m = _RESOLVER_RE.fullmatch(value.strip())
        if m:
            return _resolve_expr(m.group(1), root, node_path)
        if _RESOLVER_RE.search(value):
            return _RESOLVER_RE.sub(
                lambda mm: str(_resolve_expr(mm.group(1), root, node_path)), value)
    return value


def _resolve_expr(expr: str, root: Dict[str, Any], node_path: List[str]) -> Any:
    if ":" in expr:
        name, _, body = expr.partition(":")
        args = [_resolve_value(a, root, node_path) for a in _split_args(body)]
        args = [_resolve_value(a, root, node_path) if isinstance(a, str) else a for a in args]
        args = [parse_value(a) if isinstance(a, str) and not a.startswith("$") else a
                for a in args]
        if name == "resolve_default":
            default, alt = args[0], args[1]
            return default if alt in (None, "", "None") else alt
        if name == "eq":
            return str(args[0]).lower() == str(args[1]).lower()
        if name == "contains":
            return str(args[0]).lower() in str(args[1]).lower()
        if name == "if":
            return args[1] if args[0] else args[2]
        raise KeyError(f"unknown resolver {name!r}")
    out, target_path = _lookup(root, expr, node_path)
    if isinstance(out, str):   # a chained interpolation resolves at its target
        return _resolve_value(out, root, target_path)
    return out


def resolve(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Every ``${...}`` of the tree resolved, on a copy (two passes, so
    chained interpolations settle)."""
    def walk(node: Any, root, path: List[str]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, root, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, root, path) for v in node]
        return _resolve_value(node, root, path)

    once = walk(cfg, cfg, [])
    return walk(once, once, [])


def preprocess_train_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX ``preprocess_train_config``: inject the launcher fields into
    ``cfg['train']['params']['config']`` (``device`` is the port's
    ``device`` key) and apply the PBT ``model_size_multiplier`` to the MLP
    units. Mutates and returns ``cfg['train']``; missing keys are skipped as
    the reference's ``try/except KeyError`` does."""
    train = cfg.get("train") or {}
    params = train.setdefault("params", {})
    train_cfg = params.setdefault("config", {})
    train_cfg["device"] = cfg.get("device", "cuda")
    pbt = cfg.get("pbt") or {}
    train_cfg["population_based_training"] = bool(pbt.get("enabled", False))
    train_cfg["pbt_idx"] = pbt.get("policy_idx") if pbt.get("enabled") else None
    train_cfg["full_experiment_name"] = cfg.get("full_experiment_name")
    try:
        mlp = params["network"]["mlp"]
        multiplier = mlp["model_size_multiplier"]
        if multiplier != 1:
            mlp["units"] = [u * multiplier for u in mlp["units"]]
            print(f"Modified MLP units by x{multiplier} to {mlp['units']}")
    except KeyError:
        pass
    cfg["train"] = train
    return train
