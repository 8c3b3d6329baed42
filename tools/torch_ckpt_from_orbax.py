"""Convert a JAX package's orbax train-state checkpoint into the port's
``torch.save`` checkpoint (``isaacgym_tpu_torch/rl/checkpoint.py``).

    python tools/torch_ckpt_from_orbax.py runs/c6_r4_curr/ckpt_0003500 \\
        runs/c6_r4_curr/ckpt_0003500.pt [task=HumanoidPingpongTiltG1] [key=value ...]

The task and the overrides (the launcher's, e.g.
``train.params.network.mlp.units=[...]``) size the JAX template the
checkpoint restores into (``isaacgym_tpu.rl.checkpoint.restore``). Carried
across: the parameters (flax kernels transposed by
``interop.actor_critic_from_jax``), Adam's moments and step count, both
normalizers, the epoch and the last learning rate. The JAX PRNG key has no
torch counterpart: the file holds no generator state, and the port's
``restore`` keeps the fresh trainer's generator. Needs JAX and orbax (the
JAX package's machine); the port reads the file without them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` inside an ``inject_hyperparams`` chain."""
    import jax
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "mu") and hasattr(leaf, "nu") and hasattr(leaf, "count"):
            return leaf
    raise ValueError("no Adam state in the optimizer state (flatten_optimizer "
                     "checkpoints hold one flat vector and are not converted)")


def torch_checkpoint(jts) -> dict:
    """A JAX ``PPOTrainState`` -> the dict the port's ``checkpoint.save`` writes."""
    import jax
    import torch
    from isaacgym_tpu_torch.interop import actor_critic_from_jax
    from isaacgym_tpu_torch.rl.networks import ActorCritic

    np_tree = lambda t: jax.tree.map(np.asarray, t)
    params = actor_critic_from_jax(np_tree(jts.params))
    p = np_tree(jts.params)
    p = p.get("params", p)
    units = [int(np.asarray(p["actor_mlp"][f"Dense_{i}"]["kernel"]).shape[1])
             for i in range(len(p["actor_mlp"]))]
    net = ActorCritic(int(np.asarray(p["actor_mlp"]["Dense_0"]["kernel"]).shape[0]),
                      int(np.asarray(p["log_sigma"]).shape[0]), units=units,
                      separate="critic_mlp" in p)
    order = [name for name, _ in net.named_parameters()]
    if sorted(order) != sorted(params):
        raise ValueError(f"parameter names differ: {sorted(order)} vs {sorted(params)}")
    adam = _adam_state(jts.opt_state)
    mu, nu = actor_critic_from_jax(np_tree(adam.mu)), actor_critic_from_jax(np_tree(adam.nu))
    stats = lambda s: {f: torch.tensor(np.asarray(getattr(s, f), np.float32))
                       for f in ("mean", "var", "count")}
    return {
        "params": params,
        "opt_state": {"count": int(np.asarray(adam.count)), "mu": [mu[n] for n in order],
                      "nu": [nu[n] for n in order]},
        "obs_stats": stats(jts.obs_stats),
        "value_stats": stats(jts.value_stats),
        "rng": None,
        "epoch": int(np.asarray(jts.epoch)),
        "last_lr": torch.tensor(float(np.asarray(jts.last_lr)), dtype=torch.float32),
    }


def convert(src: str, dst: str, template) -> dict:
    """Restore the orbax checkpoint ``src`` into ``template`` (a JAX
    ``PPOTrainState`` of the same shapes) and write the port's ``dst``."""
    import torch
    from isaacgym_tpu.rl import checkpoint as jckpt
    d = torch_checkpoint(jckpt.restore(src, template))
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(d, dst)
    return d


def main(argv):
    paths = [a for a in argv if "=" not in a]
    if len(paths) != 2:
        raise SystemExit(__doc__)
    overrides = [a for a in argv if "=" in a]
    kv = dict(o.split("=", 1) for o in overrides)
    task = kv.get("task", "HumanoidPingpongTiltNoEarlyStopG1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from isaacgym_tpu.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu.tasks import task_registry
    from isaacgym_tpu.utils.config import compose, preprocess_train_config
    cfg = compose(task, [o for o in overrides if not o.startswith("task=")])
    preprocess_train_config(cfg)
    env = task_registry()[task](cfg["task"], seed=int(cfg.get("seed", 42)))
    template = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"])).init_state()
    d = convert(paths[0], paths[1], template)
    print(f"wrote {paths[1]}: epoch {d['epoch']}, Adam count {d['opt_state']['count']}")


if __name__ == "__main__":
    main(sys.argv[1:])
