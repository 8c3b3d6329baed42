"""Deterministic play / evaluation (``isaacgym_tpu/rl/player.py``, the
rl_games player): the policy's mean action, or mean + sigma * noise when a
sigma is given, over whole episodes of every env."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def resolve_hit_flag(env, flags) -> str:
    """Name of the env-state flag that latches an actual paddle hit: the
    flag the env's event map names ``hit_paddle`` (the flagship latches it as
    ``paddle_condition_calculated``)."""
    ev_map = (env.event_flag_names if getattr(env, "event_flag_names", None)
              else {k: k[: -len("_count")] for k in flags if k.endswith("_count")})
    return next((fl for fl, name in ev_map.items() if name == "hit_paddle"),
                "paddle_condition_calculated")


@torch.no_grad()
def play(env, trainer, train_state, episodes: int = 4, sigma: Optional[float] = None,
         seed: int = 0):
    """Run ``episodes`` episodes of every env; returns aggregate stats."""
    ts = train_state
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    env_state, obs = env.reset()
    B = env.num_envs
    ep_returns = np.zeros(B)
    done_returns = []
    hits = steps = 0
    prev_hit = np.zeros(B, bool)
    hit_flag = resolve_hit_flag(env, env_state.flags)
    while (len(done_returns) < episodes * B
           and steps < env.max_episode_length * (episodes + 1)):
        mu, _, _ = trainer._policy(ts.params, ts.obs_stats, obs)
        action = mu if sigma is None else mu + sigma * torch.randn(
            mu.shape, generator=gen, device=mu.device)
        env_state, obs, rew, done, info = env.step(env_state, action)
        ep_returns += rew.double().cpu().numpy()
        steps += 1
        # the hit flag is one-shot per episode: count rising edges only
        cur_hit = env_state.flags[hit_flag].cpu().numpy()
        hits += int((cur_hit & ~prev_hit).sum())
        prev_hit = cur_hit
        d = done.cpu().numpy().astype(bool)
        if d.any():
            done_returns.extend(ep_returns[d].tolist())
            ep_returns[d] = 0.0
            prev_hit = prev_hit & ~d
    n_ep = len(done_returns)
    return {
        "episodes": n_ep,
        "return_mean": float(np.mean(done_returns)) if done_returns else 0.0,
        "return_std": float(np.std(done_returns)) if done_returns else 0.0,
        "hits": hits,
        "hit_rate": float(hits) / max(n_ep, 1),
        "steps": steps,
    }
