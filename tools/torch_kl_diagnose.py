"""Per-epoch diagnostics of the PyTorch port's PPO KL on the flagship, in
fixed variants.

    python tools/torch_kl_diagnose.py --variant a [--num-envs 4096]
        [--epochs 21] [--seed 42] [--device cuda] [--out kl_a.json]
        [--init-from flax_params.npz] [key=value ...]

Trains ``HumanoidPingpongTiltNoEarlyStopG1`` with the launcher's config and
``task.randomize=false`` (the config of ``docs/runs/c7_r5_exact.jsonl``)
and records, for every epoch, the KL the launcher logs (the last
mini-epoch's mean), the KL of the very first minibatch (taken before any
optimizer step of the epoch, so it shows only the shift of the observation
normalizer), ``reward_min`` / ``reward_max``, the losses, and the median and
largest gradient norm before the clip (all, actor, critic); and at the
epochs of ``detail`` the per-lane ``obs_stats`` mean and var, the epoch's
per-lane max |obs|, the log-std, and for every minibatch of the last
mini-epoch its KL, the fraction of rows whose probability ratio lies outside
the clip range, its largest |mu| and its bounds loss.

Variants:
  a  the trainer as it stands;
  b  cuBLAS's reduced-precision bf16 and fp16 reductions and TF32 off
     (``torch.backends.cuda.matmul``);
  c  the trunks computed in float32 (``compute_dtype=torch.float32``);
  d  the env stepped through K2's plain PyTorch version on the card (a
     diagnostic route, not the main path).
Launcher overrides (``key=value``) change the config, e.g.
``train.params.config.bounds_loss_coef=0``. ``--init-from`` starts the
networks from flax ``ActorCritic`` parameters saved as an ``.npz`` of
``/``-joined names (``actor_mlp/Dense_0/kernel`` ..., ``log_sigma``), the
JAX launcher's initial weights for instance, instead of the port's own
draw. Writes one JSON object with the records to ``--out`` and prints the
per-epoch KL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from isaacgym_tpu_torch.rl import ppo as P
from isaacgym_tpu_torch.rl.networks import gaussian_logp

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
VARIANTS = ("a", "b", "c", "d")


class RecordingTrainer(P.PPOTrainer):
    """A :class:`PPOTrainer` that keeps every minibatch's KL, and with
    ``detail`` set its clip fraction, largest |mu| and bounds loss, and the
    epoch's per-lane max |obs|."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.kls, self.stats, self.detail, self.obs_absmax = [], [], False, None

    def loss(self, net, obs_stats, mbatch):
        total, aux = super().loss(net, obs_stats, mbatch)
        self.kls.append(aux["kl"])
        if self.detail:
            with torch.no_grad():
                mu, log_sig, _ = self._policy(net, obs_stats, mbatch["obs"])
                ratio = torch.exp(gaussian_logp(mu, log_sig, mbatch["action"]) - mbatch["logp"])
                out = (ratio - 1.0).abs() > self.cfg.e_clip
                self.stats.append(torch.stack([out.float().mean(), mu.abs().max(),
                                               aux["b_loss"]]))
        return total, aux

    def _rollout_and_gae(self, ts, env_state, obs):
        out = super()._rollout_and_gae(ts, env_state, obs)
        self.obs_absmax = out[2]["obs"].abs().amax(dim=0)
        return out


def _flax_params(path: str) -> dict:
    """An ``.npz`` of ``/``-joined flax parameter names -> the nested dict
    ``interop.actor_critic_from_jax`` takes."""
    import numpy as np
    out = {}
    with np.load(path) as f:
        for name in f.files:
            node = out
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[name]
    return out


def run(variant: str, num_envs: int = 4096, epochs: int = 21, seed: int = 42,
        device: str = "cuda", detail=(0, 10, 18, 19, 20), overrides=(),
        init_from: str = "") -> dict:
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.ops import fused_substep as FS
    from isaacgym_tpu_torch.utils.config import compose

    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    cfg = compose(TASK, ["task.randomize=false", f"num_envs={num_envs}", f"seed={seed}",
                         f"device={device}"] + list(overrides))
    env = make(seed=seed, task=TASK, device=device, cfg=cfg["task"])
    if variant == "d":
        k2 = env.sim.fused_substep
        env.sim.fused_substep = lambda *ins: FS.fused_substep_reference(k2.consts, *ins)
    dtype = torch.float32 if variant == "c" else torch.bfloat16
    trainer = RecordingTrainer(env, P.PPOConfig.from_train_cfg(cfg["train"]), seed=seed,
                               compute_dtype=dtype)
    matmul = torch.backends.cuda.matmul
    if variant == "b":
        matmul.allow_bf16_reduced_precision_reduction = False
        matmul.allow_fp16_reduced_precision_reduction = False
        matmul.allow_tf32 = False
    flags = {k: getattr(matmul, k) for k in ("allow_bf16_reduced_precision_reduction",
                                             "allow_fp16_reduced_precision_reduction",
                                             "allow_tf32")}
    ts = trainer.init_state()
    if init_from:
        from isaacgym_tpu_torch.interop import actor_critic_from_jax
        ts.params.load_state_dict({k: v.to(env.device) for k, v in
                                   actor_critic_from_jax(_flax_params(init_from)).items()})
    is_actor = torch.tensor([not n.startswith(("critic_mlp", "value"))
                             for n, _ in ts.params.named_parameters()], device=env.device)
    norms = []
    adam = P.clip_and_adam

    def recording_adam(params, grads, state, lr, max_norm=None):
        sq = torch.stack([g.float().pow(2).sum() for g in grads])
        norms.append(torch.stack([sq.sum(), sq[is_actor].sum(), sq[~is_actor].sum()]).sqrt())
        return adam(params, grads, state, lr, max_norm)

    env_state, obs = env.reset()
    records, t0 = [], time.time()
    P.clip_and_adam = recording_adam   # the update calls it by its module name
    try:
        for it in range(epochs):
            trainer.kls, trainer.stats, norms[:] = [], [], []
            trainer.detail = it in detail
            ts, env_state, obs, metrics = trainer.train_epoch(ts, env_state, obs)
            gn = torch.stack(norms).cpu()
            m = {k: float(v) for k, v in metrics.items()}
            num_mb = len(trainer.kls) // trainer.cfg.mini_epochs
            rec = dict(epoch=it, kl=m["kl"], kl_first_minibatch=float(trainer.kls[0]),
                       **{k: m[k] for k in ("reward_min", "reward_max", "episode_count",
                                            "a_loss", "c_loss", "b_loss")},
                       grad_norm_median=gn.median(dim=0).values.tolist(),
                       grad_norm_max=gn.max(dim=0).values.tolist())
            if trainer.detail:
                st = torch.stack(trainer.stats[-num_mb:]).cpu()
                rec.update(kl_last_mini_epoch=[float(k) for k in trainer.kls[-num_mb:]],
                           obs_mean=ts.obs_stats.mean.tolist(),
                           obs_var=ts.obs_stats.var.tolist(),
                           obs_absmax=trainer.obs_absmax.tolist(),
                           clip_fraction=st[:, 0].tolist(), mu_absmax=st[:, 1].tolist(),
                           b_loss_last_mini_epoch=st[:, 2].tolist(),
                           log_sigma=ts.params.log_sigma.tolist())
            records.append(rec)
            print(f"variant {variant} epoch {it:3d} kl {rec['kl']:.6g} "
                  f"kl_first_mb {rec['kl_first_minibatch']:.6g} reward "
                  f"[{rec['reward_min']:.4g}, {rec['reward_max']:.4g}]", flush=True)
    finally:
        P.clip_and_adam = adam
    return dict(variant=variant, overrides=list(overrides), init_from=init_from,
                num_envs=num_envs, epochs=epochs, seed=seed, device=device, compute_dtype=str(dtype), matmul_flags=flags,
                seconds=time.time() - t0, records=records)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", required=True, choices=VARIANTS)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=21)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--init-from", default="", help="flax parameters, .npz")
    ap.add_argument("overrides", nargs="*", help="launcher overrides, key=value")
    a = ap.parse_args(argv)
    res = run(a.variant, a.num_envs, a.epochs, a.seed, a.device, overrides=a.overrides,
              init_from=a.init_from)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(dict(variant=a.variant, overrides=a.overrides,
                          seconds=round(res["seconds"], 1),
                          kl=[r["kl"] for r in res["records"]])), flush=True)
    return res


if __name__ == "__main__":
    main()
