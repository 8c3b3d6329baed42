"""The port's half of the paired KL run: the flagship trained from the JAX
launcher's own initial weights, env state and draws.

    python -m isaacgym_tpu_torch.parity.kl_pair DIR [--device cuda|cpu]
        [--epochs N] [--out docs/runs/kl_pair_r15.json] [--jax-only]

``DIR`` is what ``tools/torch_kl_pair_export.py`` wrote on a machine with
JAX (``build/kl_pair/``): ``meta.json``, ``weights.npz``, ``state.npz``,
``noise.npy``, ``perms.npy``, ``launches.npy`` and the JAX run's
``jax_metrics.json``. The port's trainer is built at the same config
(``HumanoidPingpongTiltNoEarlyStopG1``, ``task.randomize=false``, the
export's seed, width and overrides; bf16 trunks as the launcher's), starts
from the exported weights (``interop.actor_critic_from_jax``) and env state
(``interop.env_state_from_numpy``), and draws nothing of its own:

* each rollout step's action noise comes through ``ppo.action_noise``, and
  each mini-epoch's permutation through ``ppo.minibatch_permutation``, in
  the order the JAX trainer drew them;
* each env's ball launches through the task's ``sample_ball_velocity``:
  the env step's reset asks every env for a launch and keeps it where the
  env resets, so the sampler hands env i its launch k + 1 after k resets
  (launch 0 is the exported state's), and a wrapper of ``env.step`` counts
  each env's resets.

Per epoch it records the KL the launcher logs (the last mini-epoch's
mean), the first minibatch's KL (before the epoch's first optimizer step),
``reward_mean``, ``a_loss``, ``c_loss`` and the other metrics, and rewrites
``--out`` as each epoch ends: ``runs["port_<device>"]`` is this run,
``runs["jax_cpu"]`` the JAX run's records from ``DIR`` (``--jax-only``
writes those alone); an existing file keeps its other runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from isaacgym_tpu_torch.parity import nvidia_smi
from isaacgym_tpu_torch.rl import ppo as P

TASK = "HumanoidPingpongTiltNoEarlyStopG1"


def nested_params(path: str) -> dict:
    """An ``.npz`` of ``/``-joined flax parameter names -> the nested dict
    ``interop.actor_critic_from_jax`` takes."""
    out = {}
    with np.load(path) as f:
        for name in f.files:
            node = out
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[name]
    return out


def load_state(path: str, device):
    """``state.npz`` -> (EnvState, obs) on ``device``."""
    from isaacgym_tpu_torch.interop import env_state_from_numpy
    with np.load(path) as f:
        a = {k: f[k] for k in f.files}
    part = lambda p: {k[len(p) + 1:]: v for k, v in a.items() if k.startswith(p + ".")}
    state = env_state_from_numpy(dict(sim=part("sim"), flags=part("flags"),
                                      progress=a["progress"], pre_ball_root=a["pre_ball_root"],
                                      ep_return=a["ep_return"]), device)
    return state, torch.as_tensor(a["obs"], device=device)


class FirstKLTrainer(P.PPOTrainer):
    """A :class:`PPOTrainer` that keeps each epoch's first minibatch KL."""

    first_kl = None

    def loss(self, net, obs_stats, mbatch):
        total, aux = super().loss(net, obs_stats, mbatch)
        if self.first_kl is None:
            self.first_kl = aux["kl"].detach().clone()
        return total, aux


class Draws:
    """The exported draws, handed out in the order the port asks for them."""

    def __init__(self, directory: str, device):
        self.noise = np.load(os.path.join(directory, "noise.npy"), mmap_mode="r")
        self.perms = np.load(os.path.join(directory, "perms.npy"), mmap_mode="r")
        self.launches = torch.as_tensor(np.load(os.path.join(directory, "launches.npy")),
                                        device=device)
        self.device = device
        self.n_noise = self.n_perm = 0
        self.resets = torch.zeros(self.launches.shape[0], dtype=torch.long, device=device)

    def action_noise(self, shape, generator, device):
        if self.n_noise >= len(self.noise):
            raise RuntimeError(f"the export holds {len(self.noise)} steps of action noise")
        x = torch.as_tensor(np.array(self.noise[self.n_noise]), device=device)
        self.n_noise += 1
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"action noise {tuple(x.shape)} for a draw of {tuple(shape)}")
        return x

    def minibatch_permutation(self, T, generator, device):
        if self.n_perm >= len(self.perms):
            raise RuntimeError(f"the export holds {len(self.perms)} permutations")
        x = torch.as_tensor(np.array(self.perms[self.n_perm]), dtype=torch.long, device=device)
        self.n_perm += 1
        if x.numel() != T:
            raise ValueError(f"a permutation of {x.numel()} rows for a batch of {T}")
        return x

    def ball_velocity(self, n):
        """Each env's next launch: launch k + 1 after k resets."""
        B, L = self.launches.shape[:2]
        k = torch.clamp(self.resets + 1, max=L - 1)
        return self.launches[torch.arange(B, device=self.device), k][:n]

    def counting_step(self, step):
        def run(state, actions):
            out = step(state, actions)
            self.resets += out[3].to(torch.long)
            return out
        return run


def _write(out: str, doc: dict):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, out)


def _doc(out: str, meta: dict) -> dict:
    doc = {}
    if out and os.path.exists(out):
        with open(out) as f:
            doc = json.load(f)
    doc.setdefault("config", {k: meta[k] for k in meta if k not in ("draws_seconds",)})
    doc.setdefault("runs", {})
    return doc


def build(directory: str, device="cuda", dtype=torch.bfloat16):
    """(meta, env, trainer, ts, env_state, obs, draws) from the export."""
    from isaacgym_tpu_torch.interop import actor_critic_from_jax
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.utils.config import compose
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    dev = torch.device(device)
    cfg = compose(TASK, ["task.randomize=false", f"num_envs={meta['num_envs']}",
                         f"seed={meta['seed']}", f"device={dev.type}"] + meta["overrides"])
    env = make(seed=int(meta["seed"]), task=TASK, device=dev, cfg=cfg["task"])
    trainer = FirstKLTrainer(env, P.PPOConfig.from_train_cfg(cfg["train"]),
                             seed=int(meta["seed"]), compute_dtype=dtype)
    ts = trainer.init_state()
    weights = actor_critic_from_jax(nested_params(os.path.join(directory, "weights.npz")))
    ts.params.load_state_dict({k: v.to(dev) for k, v in weights.items()})
    env_state, obs = load_state(os.path.join(directory, "state.npz"), dev)
    draws = Draws(directory, dev)
    env.sample_ball_velocity = draws.ball_velocity
    env.step = draws.counting_step(env.step)
    return meta, env, trainer, ts, env_state, obs, draws


def epochs_run(trainer, ts, env_state, obs, draws, epochs: int):
    """Yield (epoch, record, ts, env_state, obs) for each epoch, the draws
    injected into ``ppo``'s hooks for the run's length."""
    saved = P.action_noise, P.minibatch_permutation
    P.action_noise, P.minibatch_permutation = draws.action_noise, draws.minibatch_permutation
    try:
        for it in range(epochs):
            trainer.first_kl = None
            ts, env_state, obs, metrics = trainer.train_epoch(ts, env_state, obs)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["kl_first_minibatch"] = float(trainer.first_kl)
            if int(draws.resets.max()) >= draws.launches.shape[1]:
                raise RuntimeError("an env reset more often than the export has launches for")
            yield it, rec, ts, env_state, obs
    finally:
        P.action_noise, P.minibatch_permutation = saved


def _with_jax_run(doc: dict, directory: str) -> dict:
    path = os.path.join(directory, "jax_metrics.json")
    if os.path.exists(path):
        with open(path) as f:
            doc["runs"]["jax_cpu"] = {"device": "cpu", "records": json.load(f)}
    return doc


def run(directory: str, device="cuda", epochs=None, out="", log=print) -> dict:
    meta, env, trainer, ts, env_state, obs, draws = build(directory, device)
    doc = _with_jax_run(_doc(out, meta), directory)
    epochs = int(epochs or meta["epochs"])
    label = f"port_{env.device.type}"
    this = {"device": env.device.type, "route": env.sim.route,
            "card": nvidia_smi() if env.device.type == "cuda" else None, "records": []}
    doc["runs"][label] = this
    t0 = time.time()
    for it, rec, ts, env_state, obs in epochs_run(trainer, ts, env_state, obs, draws, epochs):
        rec = dict(epoch=it, seconds=time.time() - t0, resets_per_env=int(draws.resets.max()),
                   **rec)
        this["records"].append(rec)
        if out:
            _write(out, doc)
        log(f"{label} epoch {it:3d} kl {rec['kl']:.6g} kl_first_mb "
            f"{rec['kl_first_minibatch']:.6g} reward_mean {rec['reward_mean']:.6g}", flush=True)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--epochs", type=int, default=0, help="default: the export's")
    ap.add_argument("--out", default=os.path.join("docs", "runs", "kl_pair_r15.json"))
    ap.add_argument("--jax-only", action="store_true")
    a = ap.parse_args(argv)
    if a.jax_only:
        with open(os.path.join(a.dir, "meta.json")) as f:
            _write(a.out, _with_jax_run(_doc(a.out, json.load(f)), a.dir))
        return 0
    run(a.dir, a.device, a.epochs or None, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
