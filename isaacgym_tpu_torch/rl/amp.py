"""Adversarial Motion Prior (AMP) (``isaacgym_tpu/rl/amp.py``).

A discriminator over (s, s') transition features, the LSGAN-style
discriminator loss with a gradient penalty on the demos, the style-reward
transform, and :class:`AMPTrainer`, which composes the discriminator update
with the port's PPO epoch (the task reward blended with the style reward).
The discriminator is an ``nn.Module`` on the env's device, float32, updated
in place by Adam (``ppo.clip_and_adam`` without the clip); its weights start
as flax's (LeCun-normal kernels, zero biases), and
``interop.amp_discriminator_from_jax`` carries a flax discriminator's across.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from isaacgym_tpu_torch.rl.networks import lecun_normal_
from isaacgym_tpu_torch.rl.ppo import (AdamState, PPOConfig, PPOTrainer, PPOTrainState,
                                       clip_and_adam)


class AMPDiscriminator(nn.Module):
    """MLP discriminator over AMP observation pairs (rl_games units default)."""

    def __init__(self, amp_obs_dim: int, units: Sequence[int] = (1024, 512)):
        super().__init__()
        dims = [amp_obs_dim] + list(units) + [1]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, amp_obs):
        x = amp_obs
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


class AMPState(NamedTuple):
    disc: AMPDiscriminator       # updated in place
    disc_opt: AdamState


def disc_loss(disc, agent_obs, demo_obs, grad_penalty: float = 5.0):
    """LSGAN discriminator loss with an R1-style gradient penalty on the
    demos (the AMP paper's, rl_games amp_continuous) -> (total, aux); the
    penalty's gradient is built (``create_graph``), so ``total`` can be
    differentiated with respect to the discriminator."""
    agent_logits = disc(agent_obs)
    demo = demo_obs.detach().requires_grad_(True)
    demo_logits = disc(demo)
    loss_agent = torch.mean((agent_logits + 1.0) ** 2)
    loss_demo = torch.mean((demo_logits - 1.0) ** 2)
    grads, = torch.autograd.grad(demo_logits.sum(), demo, create_graph=True)
    gp = torch.mean(torch.sum(grads ** 2, dim=-1))
    total = 0.5 * (loss_agent + loss_demo) + grad_penalty * gp
    return total, {"disc_agent_logit": agent_logits.mean().detach(),
                   "disc_demo_logit": demo_logits.mean().detach(),
                   "disc_grad_penalty": gp.detach()}


@torch.no_grad()
def style_reward(disc, amp_obs, scale: float = 2.0):
    """AMP style reward (Peng et al. 2021): r = max(0, 1 - 0.25 (d - 1)^2)."""
    d = disc(amp_obs)
    return scale * torch.clamp(1.0 - 0.25 * (d - 1.0) ** 2, min=0.0)


class _BlendedEnv:
    """Env wrapper whose ``step`` blends the AMP style reward into the task
    reward. Its state is ``(inner_state, prev_obs, disc)``; the discriminator
    is the module :meth:`AMPTrainer.disc_update` changes in place."""

    def __init__(self, env, amp: "AMPTrainer"):
        self._env = env
        self._amp = amp
        self.device = env.device
        self.num_envs = env.num_envs
        self.num_obs = env.num_obs
        self.num_actions = env.num_actions
        self.max_episode_length = getattr(env, "max_episode_length", 1000)

    def step(self, state, action):
        inner, prev_obs, disc = state
        inner, obs2, rew, done, info = self._env.step(inner, action)
        amp = self._amp
        style = style_reward(disc, amp.amp_obs_fn(prev_obs, obs2))
        rew = amp.task_w * rew + amp.style_w * style
        return (inner, obs2, disc), obs2, rew, done, info

    def reset(self, disc):
        inner, obs = self._env.reset()
        return (inner, obs, disc), obs


class AMPTrainer:
    """PPO with an AMP discriminator; the style reward blended into the task
    reward. Runs on the env's device.

    ``demo_sampler(generator, n) -> (n, amp_obs_dim)`` supplies
    reference-motion transitions (e.g. from :class:`MotionLib`).
    ``amp_obs_fn(prev_obs, next_obs) -> (B, amp_obs_dim)`` extracts the
    transition features the discriminator judges (by default the
    concatenated observation pair).
    """

    def __init__(self, env, cfg: PPOConfig, amp_obs_dim: int, demo_sampler,
                 task_reward_weight: float = 0.5, style_reward_weight: float = 0.5,
                 disc_lr: float = 1e-4, seed: int = 42, amp_obs_fn=None,
                 disc_rollout_steps: int = 4, disc_units: Sequence[int] = (1024, 512)):
        self.env = env
        self.device = env.device
        self.demo_sampler = demo_sampler
        self.task_w = task_reward_weight
        self.style_w = style_reward_weight
        self.amp_obs_dim = amp_obs_dim
        self.amp_obs_fn = amp_obs_fn or (lambda o, o2: torch.cat([o, o2], dim=-1))
        self.disc_units = tuple(disc_units)
        self.disc_lr = torch.tensor(disc_lr, dtype=torch.float32, device=self.device)
        self.seed = int(seed)
        self.disc_rollout_steps = disc_rollout_steps
        self.wrapped = _BlendedEnv(env, self)
        self.ppo = PPOTrainer(self.wrapped, cfg, seed=seed)
        self.demo_rng = torch.Generator(device=self.device)
        self.demo_rng.manual_seed(self.seed)

    def init_state(self) -> Tuple[PPOTrainState, AMPState]:
        ppo_state = self.ppo.init_state()
        disc = AMPDiscriminator(self.amp_obs_dim, self.disc_units)
        disc.reset_parameters(torch.Generator().manual_seed(self.seed + 1))
        disc.to(self.device)
        zeros = lambda: [torch.zeros_like(p) for p in disc.parameters()]
        return ppo_state, AMPState(disc=disc, disc_opt=AdamState(0, zeros(), zeros()))

    def reset(self, amp_state: AMPState):
        return self.wrapped.reset(amp_state.disc)

    def disc_update(self, amp_state: AMPState, agent_obs, demo_obs):
        """One Adam step of the discriminator on ``disc_loss``."""
        params = list(amp_state.disc.parameters())
        loss, aux = disc_loss(amp_state.disc, agent_obs, demo_obs)
        grads = torch.autograd.grad(loss, params)
        opt = clip_and_adam(params, grads, amp_state.disc_opt, self.disc_lr)
        return AMPState(amp_state.disc, opt), {"disc_loss": loss.detach(), **aux}

    def blended_reward(self, amp_state: AMPState, task_reward, amp_obs):
        style = style_reward(amp_state.disc, amp_obs)
        return self.task_w * task_reward + self.style_w * style

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _collect_amp_obs(self, ppo_state: PPOTrainState, inner_state, obs):
        """A short deterministic rollout of the raw env (the policy's mean)
        collecting agent transition features for the discriminator."""
        pairs = []
        for _ in range(self.disc_rollout_steps):
            mu = self.ppo._policy(ppo_state.params, ppo_state.obs_stats, obs)[0]
            inner_state, obs2, _r, _d, _info = self.env.step(inner_state, mu)
            pairs.append(self.amp_obs_fn(obs, obs2))
            obs = obs2
        return inner_state, obs, torch.cat(pairs, dim=0)

    def train_epoch(self, ppo_state: PPOTrainState, amp_state: AMPState, env_state, obs,
                    generator: Optional[torch.Generator] = None):
        """One AMP iteration (rl_games amp_continuous's epoch): a
        discriminator update on fresh agent transitions against a demo
        batch, then a whole PPO epoch on style-blended rewards. The demos
        are drawn from ``generator`` (the trainer's own by default)."""
        inner, _prev_obs, _ = env_state
        inner, obs, agent_obs = self._collect_amp_obs(ppo_state, inner, obs)
        demo_obs = self.demo_sampler(generator or self.demo_rng, agent_obs.shape[0])
        amp_state, disc_metrics = self.disc_update(amp_state, agent_obs, demo_obs)
        env_state = (inner, obs, amp_state.disc)
        ppo_state, env_state, obs, metrics = self.ppo.train_epoch(ppo_state, env_state, obs)
        return ppo_state, amp_state, env_state, obs, {**metrics, **disc_metrics}
