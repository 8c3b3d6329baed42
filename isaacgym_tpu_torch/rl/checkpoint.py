"""Save and restore a whole :class:`PPOTrainState` (``isaacgym_tpu/rl/checkpoint.py``).

One ``torch.save`` file holds the parameters, the Adam moments and step
count, both normalizers, the generator state, the epoch and the learning
rate. ``restore`` loads it onto the device of the template state
(``map_location``), so a checkpoint saved on the card restores on the CPU
and back. The JAX package's orbax checkpoints are not read here:
``tools/torch_ckpt_from_orbax.py`` converts one (with JAX) into this
format, without a generator state; ``restore`` then keeps the template's.
"""

from __future__ import annotations

import os

import torch

from isaacgym_tpu_torch.rl.normalizer import RunningStats
from isaacgym_tpu_torch.rl.ppo import AdamState, PPOTrainState


def save(path: str, ts: PPOTrainState) -> None:
    """Write ``ts`` to ``path`` (directories are created)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "params": ts.params.state_dict(),
        "opt_state": {"count": ts.opt_state.count, "mu": list(ts.opt_state.mu),
                      "nu": list(ts.opt_state.nu)},
        "obs_stats": ts.obs_stats._asdict(),
        "value_stats": ts.value_stats._asdict(),
        "rng": ts.rng.get_state(),
        "epoch": ts.epoch,
        "last_lr": ts.last_lr,
    }, path)


def restore(path: str, template: PPOTrainState) -> PPOTrainState:
    """Load ``path`` into the module and generator of ``template`` (a fresh
    ``init_state()``) and return the restored state."""
    dev = template.last_lr.device
    d = torch.load(path, map_location=dev, weights_only=True)
    template.params.load_state_dict(d["params"])
    if d["rng"] is not None:   # a checkpoint converted from orbax holds none
        template.rng.set_state(d["rng"].cpu())
    opt = d["opt_state"]
    return PPOTrainState(
        params=template.params,
        opt_state=AdamState(int(opt["count"]), list(opt["mu"]), list(opt["nu"])),
        obs_stats=RunningStats(**d["obs_stats"]),
        value_stats=RunningStats(**d["value_stats"]),
        rng=template.rng, epoch=int(d["epoch"]), last_lr=d["last_lr"])
