"""Write the port's table of config interpolations from the JAX package's YAMLs.

The port reads each task's config already resolved (``isaacgym_tpu_torch/
cfg/<Task>.json`` and ``cfg/train/<Task>PPO.json``). What it cannot get from
them is how a root-level key (``num_envs``, ``seed``, the reward hooks
``hit_reward`` ... ``two_player``) reaches the task and train configs. This
tool takes that from the YAMLs once: the root config as written, and for
every task each leaf whose YAML value is an interpolation (``${...}``),
with the expression as written. The port's ``utils/config.py`` puts those
expressions back, applies the overrides and resolves them as the JAX
loader does.

    python tools/torch_cfg_export.py [--out isaacgym_tpu_torch/cfg/interpolations.json]

``tests/test_torch_config.py`` holds the committed table equal to what
this writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join("isaacgym_tpu_torch", "cfg", "interpolations.json")


def _leaves(node, prefix=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(node, str) and "${" in node:
        yield ".".join(prefix), node


def table() -> dict:
    from isaacgym_tpu.utils.config import CFG_DIR, load_yaml
    tasks = sorted(f[:-5] for f in os.listdir(os.path.join(CFG_DIR, "task"))
                   if f.endswith(".yaml"))
    out = {"root": load_yaml(os.path.join(CFG_DIR, "config.yaml")), "tasks": {}}
    for task in tasks:
        raw = {"task": load_yaml(os.path.join(CFG_DIR, "task", f"{task}.yaml")),
               "train": load_yaml(os.path.join(CFG_DIR, "train", f"{task}PPO.yaml"))}
        out["tasks"][task] = {sec: dict(_leaves(raw[sec])) for sec in ("task", "train")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        json.dump(table(), f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
