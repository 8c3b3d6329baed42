"""PPO trainer (``isaacgym_tpu/rl/ppo.py``, rl_games ``a2c_continuous``).

The hyperparameter surface and the loss follow the reference train config:
GAE (gamma, tau), constant / linear / adaptive lr, e_clip with value
clipping, critic_coef, global-norm gradient clipping, sigma entropy, the mu
bounds loss, reward scaling, value bootstrap on time-outs, running input and
value normalization.

An epoch is a rollout of ``horizon_length`` env steps (a Python loop over
the env step, which launches K2 or K2-dr on the card), GAE, the normalizer
updates, then ``mini_epochs`` passes of minibatch updates. The rollout keeps
everything on the device: no ``.item()``, no branch on a tensor; episode
sums stay tensors until the caller reads the metrics. The parameters live in
one :class:`ActorCritic` module that the update changes in place.

The optimizer is written out as optax's ``chain(clip_by_global_norm,
adam(eps=1e-8))`` computes it: gradients are scaled by ``max_norm / norm``
only when ``norm > max_norm``, then Adam's bias-corrected step. The
learning rate is a 0-d tensor on the device, so the adaptive schedule needs
no host sync either; it takes effect from the next minibatch. The JAX
package's ``flatten_optimizer`` (``optax.flatten`` of that chain) selects
the same step: optax's flattened chain differs from its per-tensor chain
only in the rounding of the global norm's sum, and the per-tensor step,
already a few multi-tensor ``_foreach`` launches, equals ``optax.flatten``
within the optax gate (``tests/test_torch_flatten.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from isaacgym_tpu_torch.rl import normalizer as N
from isaacgym_tpu_torch.rl.networks import ActorCritic, gaussian_entropy, gaussian_logp

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 2e-5
    lr_schedule: str = "constant"  # constant | linear | adaptive (rl_games)
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    horizon_length: int = 32
    minibatch_size: int = 4096
    mini_epochs: int = 5
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 10.0
    truncate_grads: bool = True
    clip_value: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = True
    reward_scale: float = 0.01
    max_epochs: int = 200000
    units: Tuple[int, ...] = (2048, 1536, 1024, 1024, 512, 512)
    activation: str = "elu"
    sigma_init: float = -2.0
    separate: bool = True
    #: ``optax.flatten`` in the JAX package; the same per-tensor step here
    flatten_optimizer: bool = False

    @staticmethod
    def from_train_cfg(train_cfg: Dict[str, Any]) -> "PPOConfig":
        """Build from a reference-format train config dict (``params.*``)."""
        p = train_cfg.get("params", train_cfg)
        c = p.get("config", {})
        net = p.get("network", {})
        mlp = net.get("mlp", {})
        sigma = (net.get("space", {}).get("continuous", {})
                 .get("sigma_init", {}).get("val", -2.0))
        return PPOConfig(
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            learning_rate=float(c.get("learning_rate", 2e-5)),
            lr_schedule=str(c.get("lr_schedule", "constant") or "constant").lower(),
            kl_threshold=float(c.get("kl_threshold", 0.008)),
            e_clip=float(c.get("e_clip", 0.2)),
            horizon_length=int(c.get("horizon_length", 32)),
            minibatch_size=int(c.get("minibatch_size", 4096)),
            mini_epochs=int(c.get("mini_epochs", 5)),
            critic_coef=float(c.get("critic_coef", 4.0)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 1e-4) or 0.0),
            grad_norm=float(c.get("grad_norm", 10.0)),
            truncate_grads=bool(c.get("truncate_grads", True)),
            clip_value=bool(c.get("clip_value", True)),
            normalize_input=bool(c.get("normalize_input", True)),
            normalize_value=bool(c.get("normalize_value", True)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            value_bootstrap=bool(c.get("value_bootstrap", True)),
            reward_scale=float(c.get("reward_shaper", {}).get("scale_value", 1.0)),
            max_epochs=int(c.get("max_epochs", 200000)),
            units=tuple(mlp.get("units", (2048, 1536, 1024, 1024, 512, 512))),
            activation=str(mlp.get("activation", "elu")),
            sigma_init=float(sigma),
            separate=bool(net.get("separate", True)),
            flatten_optimizer=bool(c.get("flatten_optimizer", False)),
        )


class AdamState(NamedTuple):
    count: int                   # steps taken
    mu: List[torch.Tensor]       # first moments, one per parameter
    nu: List[torch.Tensor]       # second moments


class PPOTrainState(NamedTuple):
    params: ActorCritic          # float32 master weights, updated in place
    opt_state: AdamState
    obs_stats: N.RunningStats
    value_stats: N.RunningStats
    rng: torch.Generator         # action noise and minibatch permutations
    epoch: int
    last_lr: torch.Tensor        # () float32 on the device


def gaussian_kl_rows(mu0, log_sig0, mu1, log_sig1):
    """Analytic KL(N0 || N1) of each row, summed over action dims (rl_games
    ``policy_kl`` before its mean over the batch, called with (new, old))."""
    kl = (log_sig1 - log_sig0
          + (torch.exp(2.0 * log_sig0) + (mu0 - mu1) ** 2)
          / (2.0 * torch.exp(2.0 * log_sig1) + 1e-10) - 0.5)
    return torch.sum(kl, dim=-1)


def action_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The rollout's unit normal action noise for one step, drawn here so a
    check can hand both packages the same draws (the JAX package's come from
    ``jax.random.normal``)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def minibatch_permutation(T: int, generator: torch.Generator, device) -> torch.Tensor:
    """One mini-epoch's order of the batch's ``T`` rows. ``_update`` draws
    every permutation here, so a check can hand both packages the same ones
    (the JAX package draws them with ``jax.random.permutation``)."""
    return torch.randperm(T, generator=generator, device=device)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the norm of the tensors' norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_and_adam(params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
                  lr: torch.Tensor, max_norm: float = None) -> AdamState:
    """One optimizer step in place on ``params``: optax's
    ``clip_by_global_norm(max_norm)`` (skipped when ``max_norm`` is None),
    then ``adam(lr, eps=1e-8)``."""
    grads = list(grads)
    if max_norm is not None:
        norm = global_norm(grads)
        coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        grads = torch._foreach_mul(grads, coef)
    count = state.count + 1
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
    # optax forms the bias corrections 1 - b ** count in float32
    bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(count))
                for b in (ADAM_B1, ADAM_B2))
    mu_hat = torch._foreach_div(mu, bc1)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    step = torch._foreach_div(mu_hat, denom)
    torch._foreach_mul_(step, lr)
    with torch.no_grad():
        torch._foreach_sub_(params, step)
    return AdamState(count, mu, nu)


class PPOTrainer:
    """Owns the network, the optimizer and the epoch over a port env.

    Runs on the env's device (the card unless the env was made with
    ``device="cpu"``). Every draw and every reduction over the batch goes
    through the methods under "the batch" below; the data-parallel trainer
    (``parallel/data_parallel.py``) overrides them to draw and reduce over
    the global batch of all ranks."""

    def __init__(self, env, cfg: PPOConfig, seed: int = 42,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.env = env
        self.cfg = cfg
        self.seed = int(seed)
        self.device = env.device
        self.compute_dtype = compute_dtype

    # ------------------------------------------------------------------

    def init_state(self) -> PPOTrainState:
        cfg, env = self.cfg, self.env
        net = ActorCritic(env.num_obs, env.num_actions, units=cfg.units,
                          activation=cfg.activation, sigma_init=cfg.sigma_init,
                          separate=cfg.separate, compute_dtype=self.compute_dtype)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        net.to(self.device)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.seed)
        zeros = [torch.zeros_like(p) for p in net.parameters()]
        return PPOTrainState(
            params=net,
            opt_state=AdamState(0, zeros, [torch.zeros_like(p) for p in net.parameters()]),
            obs_stats=N.init_stats((env.num_obs,), self.device),
            value_stats=N.init_stats((), self.device),
            rng=rng, epoch=0,
            last_lr=torch.tensor(cfg.learning_rate, dtype=torch.float32, device=self.device))

    def _policy(self, net, obs_stats, obs):
        obs_n = N.normalize(obs_stats, obs) if self.cfg.normalize_input else obs
        return net(obs_n)

    # -- the batch: draws and reductions (one process: the local batch) -----

    def _action_noise(self, shape, rng):
        return action_noise(shape, rng, self.device)

    def _sum(self, x):
        """A sum already taken over this process's envs, over the batch."""
        return x

    def _mean(self, x):
        return x.mean()

    def _min(self, x):
        return x.min()

    def _max(self, x):
        return x.max()

    def _mean_std(self, x):
        return x.mean(), x.std(correction=0)

    def _update_stats(self, stats, rows):
        return N.update_stats(stats, rows)

    def _minibatch_rows(self, T: int, rng):
        """One mini-epoch's minibatches: a list of row indices each."""
        mb = min(self.cfg.minibatch_size, T)
        num_mb = T // mb
        perm = minibatch_permutation(T, rng, self.device)
        return list(perm[:num_mb * mb].view(num_mb, mb))

    def _loss_mean(self, x):
        """The mean of a per-row loss term over the minibatch."""
        return x.mean()

    def _reduce_grads(self, grads, aux):
        return grads, aux

    # ------------------------------------------------------------------

    def train_epoch(self, ts: PPOTrainState, env_state, obs):
        """One PPO epoch: rollout + GAE, then the minibatch updates.
        Returns ``(ts', env_state', obs', metrics)``; the metrics are 0-d
        tensors on the device."""
        env_state, last_obs, batch, obs_stats, value_stats, roll_metrics = \
            self._rollout_and_gae(ts, env_state, obs)
        params, opt_state, last_lr, aux = self._update(ts, batch, obs_stats)
        metrics = {**roll_metrics, **aux, "last_lr": last_lr}
        new_ts = PPOTrainState(params=params, opt_state=opt_state, obs_stats=obs_stats,
                               value_stats=value_stats, rng=ts.rng, epoch=ts.epoch + 1,
                               last_lr=last_lr)
        return new_ts, env_state, last_obs, metrics

    @torch.no_grad()
    def _rollout_and_gae(self, ts: PPOTrainState, env_state, obs):
        cfg, env, dev = self.cfg, self.env, self.device
        B, H, A = env.num_envs, cfg.horizon_length, env.num_actions
        f32 = dict(dtype=torch.float32, device=dev)
        traj = dict(obs=torch.empty((H, B, env.num_obs), **f32),
                    action=torch.empty((H, B, A), **f32), logp=torch.empty((H, B), **f32),
                    value=torch.empty((H, B), **f32), reward=torch.empty((H, B), **f32),
                    done=torch.empty((H, B), **f32), time_out=torch.empty((H, B), **f32),
                    mu=torch.empty((H, B, A), **f32), sigma=torch.empty((H, B, A), **f32))
        zero = torch.zeros((), **f32)
        ep_return_sum, ep_length_sum, ep_count = zero.clone(), zero.clone(), zero.clone()
        event_sums: Dict[str, torch.Tensor] = {}

        for t in range(H):
            mu, log_sig, value_n = self._policy(ts.params, ts.obs_stats, obs)
            value = (N.denormalize(ts.value_stats, value_n)
                     if cfg.normalize_value else value_n)
            noise = self._action_noise(mu.shape, ts.rng)
            action = mu + torch.exp(log_sig) * noise
            traj["obs"][t] = obs
            traj["action"][t] = action
            traj["logp"][t] = gaussian_logp(mu, log_sig, action)
            traj["value"][t] = value
            traj["mu"][t] = mu
            traj["sigma"][t] = log_sig
            env_state, obs, rew, done, info = env.step(env_state, action)
            traj["reward"][t] = rew
            traj["done"][t] = done.to(torch.float32)
            traj["time_out"][t] = info["time_outs"].to(torch.float32)
            ep_return_sum += info["episode_return"].sum()
            ep_length_sum += info["episode_length"].to(torch.float32).sum()
            ep_count += info["episode_done"].to(torch.float32).sum()
            for k, v in info.get("episode_events", {}).items():
                event_sums[k] = event_sums.get(k, zero) + v.to(torch.float32).sum()

        # bootstrap value for the final state
        _, _, last_value_n = self._policy(ts.params, ts.obs_stats, obs)
        last_value = (N.denormalize(ts.value_stats, last_value_n)
                      if cfg.normalize_value else last_value_n)

        rewards = traj["reward"] * cfg.reward_scale
        if cfg.value_bootstrap:
            # rl_games: add gamma * V(s) on truncation-only terminations
            rewards = rewards + cfg.gamma * traj["value"] * traj["time_out"]

        # GAE, a reverse loop over the horizon
        not_done = 1.0 - traj["done"]
        adv = torch.empty((H, B), **f32)
        gae = torch.zeros(B, **f32)
        next_value = last_value
        for t in reversed(range(H)):
            delta = rewards[t] + cfg.gamma * next_value * not_done[t] - traj["value"][t]
            gae = delta + cfg.gamma * cfg.tau * not_done[t] * gae
            adv[t] = gae
            next_value = traj["value"][t]
        returns = adv + traj["value"]

        # normalizers update on this rollout's observations and returns
        obs_stats = (self._update_stats(ts.obs_stats, traj["obs"].reshape(-1, env.num_obs))
                     if cfg.normalize_input else ts.obs_stats)
        value_stats = (self._update_stats(ts.value_stats, returns.reshape(-1))
                       if cfg.normalize_value else ts.value_stats)
        inf = float("inf")
        returns_n = N.normalize(value_stats, returns, clip=inf) if cfg.normalize_value else returns
        values_n = (N.normalize(value_stats, traj["value"], clip=inf)
                    if cfg.normalize_value else traj["value"])
        if cfg.normalize_advantage:
            adv_mean, adv_std = self._mean_std(adv)
            adv = (adv - adv_mean) / (adv_std + 1e-8)

        T = H * B
        batch = dict(obs=traj["obs"].reshape(T, -1), action=traj["action"].reshape(T, -1),
                     logp=traj["logp"].reshape(T), mu=traj["mu"].reshape(T, -1),
                     sigma=traj["sigma"].reshape(T, -1), value_n=values_n.reshape(T),
                     adv=adv.reshape(T), returns_n=returns_n.reshape(T))
        roll_metrics = {
            "episode_return_sum": self._sum(ep_return_sum),
            "episode_length_sum": self._sum(ep_length_sum),
            "episode_count": self._sum(ep_count),
            "reward_mean": self._mean(traj["reward"]),
            "reward_min": self._min(traj["reward"]),
            "reward_max": self._max(traj["reward"]),
            "episode_reward_scale": self._mean(rewards),
            "value_mean": self._mean(traj["value"]),
            "adv_std": self._mean_std(adv)[1],
        }
        for k, v in event_sums.items():
            roll_metrics[f"event_{k}_sum"] = self._sum(v)
        return env_state, obs, batch, obs_stats, value_stats, roll_metrics

    def loss(self, net, obs_stats, mbatch):
        """PPO loss on one minibatch -> (total, aux): the clipped surrogate,
        the clipped value loss with 0.5 critic_coef, the bounds loss at
        +-1.1, the entropy, and KL(new || old) on the detached new policy."""
        cfg = self.cfg
        mu, log_sig, value = self._policy(net, obs_stats, mbatch["obs"])
        logp = gaussian_logp(mu, log_sig, mbatch["action"])
        ratio = torch.exp(logp - mbatch["logp"])
        surr1 = mbatch["adv"] * ratio
        surr2 = mbatch["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -self._loss_mean(torch.minimum(surr1, surr2))
        if cfg.clip_value:
            v_clipped = mbatch["value_n"] + torch.clamp(value - mbatch["value_n"],
                                                        -cfg.e_clip, cfg.e_clip)
            c_loss = self._loss_mean(torch.maximum((value - mbatch["returns_n"]) ** 2,
                                                   (v_clipped - mbatch["returns_n"]) ** 2))
        else:
            c_loss = self._loss_mean((value - mbatch["returns_n"]) ** 2)
        entropy = self._loss_mean(gaussian_entropy(log_sig))
        b_loss = self._loss_mean(torch.sum(torch.clamp(mu - 1.1, min=0.0) ** 2
                                           + torch.clamp(-1.1 - mu, min=0.0) ** 2, dim=-1))
        total = (a_loss + 0.5 * cfg.critic_coef * c_loss
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
        kl = self._loss_mean(gaussian_kl_rows(mu.detach(), log_sig.detach(),
                                              mbatch["mu"], mbatch["sigma"]))
        return total, dict(a_loss=a_loss.detach(), c_loss=c_loss.detach(),
                           entropy=entropy.detach(), b_loss=b_loss.detach(), kl=kl)

    def _update(self, ts: PPOTrainState, batch, obs_stats):
        """``mini_epochs`` passes over the batch in fresh random minibatches.
        Returns ``(params, opt_state, last_lr, aux)``, aux the last
        mini-epoch's means."""
        cfg = self.cfg
        T = batch["logp"].shape[0]
        if cfg.lr_schedule == "linear":
            # rl_games LinearScheduler: linear decay to 0 over max_epochs, floor 1e-6
            frac = min(max(1.0 - ts.epoch / float(cfg.max_epochs), 0.0), 1.0)
            lr = torch.tensor(max(cfg.learning_rate * frac, 1e-6), dtype=torch.float32,
                              device=self.device)
        else:
            lr = ts.last_lr
        net, opt_state = ts.params, ts.opt_state
        params = list(net.parameters())
        max_norm = cfg.grad_norm if cfg.truncate_grads else None
        aux_means = {}
        for _ in range(cfg.mini_epochs):
            minibatches = self._minibatch_rows(T, ts.rng)
            num_mb = len(minibatches)
            sums: Dict[str, torch.Tensor] = {}
            for idx in minibatches:
                mbatch = {k: v[idx] for k, v in batch.items()}
                total, aux = self.loss(net, obs_stats, mbatch)
                grads, aux = self._reduce_grads(torch.autograd.grad(total, params), aux)
                opt_state = clip_and_adam(params, grads, opt_state, lr, max_norm)
                if cfg.lr_schedule == "adaptive":
                    # rl_games AdaptiveScheduler: x / 1.5 on the minibatch KL,
                    # clamped to [1e-6, 1e-2]; takes effect next minibatch
                    kl = aux["kl"]
                    lr = torch.where(kl > 2.0 * cfg.kl_threshold,
                                     torch.clamp(lr / 1.5, min=1e-6), lr)
                    lr = torch.where(kl < 0.5 * cfg.kl_threshold,
                                     torch.clamp(lr * 1.5, max=1e-2), lr)
                aux["last_lr"] = lr
                for k, v in aux.items():
                    sums[k] = sums[k] + v if k in sums else v
            aux_means = {k: v / num_mb for k, v in sums.items()}
        return net, opt_state, lr, aux_means
