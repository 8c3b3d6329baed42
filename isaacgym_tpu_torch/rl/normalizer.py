"""Running mean/std normalizers (``isaacgym_tpu/rl/normalizer.py``,
rl_games ``RunningMeanStd`` parity).

The state is a small named tuple of tensors; an update merges a batch with
Chan's parallel variance formula. ``torch.var(correction=0)`` is the
population variance, as ``jnp.var`` is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor   # () float32


def init_stats(shape, device="cpu") -> RunningStats:
    return RunningStats(mean=torch.zeros(shape, dtype=torch.float32, device=device),
                        var=torch.ones(shape, dtype=torch.float32, device=device),
                        count=torch.tensor(1e-4, dtype=torch.float32, device=device))


def update_stats(stats: RunningStats, batch: torch.Tensor, axis=(0,)) -> RunningStats:
    """Merge a batch (reduced over ``axis``) into the running stats."""
    axis = tuple(axis)
    b_mean = batch.mean(dim=axis)
    b_var = batch.var(dim=axis, correction=0)
    n = 1
    for a in axis:
        n *= batch.shape[a]
    return merge_moments(stats, b_mean, b_var, n)


def merge_moments(stats: RunningStats, b_mean: torch.Tensor, b_var: torch.Tensor,
                  n: int) -> RunningStats:
    """Merge a batch of ``n`` rows, given its mean and population variance."""
    b_count = torch.tensor(float(n), dtype=torch.float32, device=b_mean.device)
    delta = b_mean - stats.mean
    tot = stats.count + b_count
    new_mean = stats.mean + delta * (b_count / tot)
    m_a = stats.var * stats.count
    m_b = b_var * b_count
    m2 = m_a + m_b + delta ** 2 * (stats.count * b_count / tot)
    return RunningStats(mean=new_mean, var=m2 / tot, count=tot)


def normalize(stats: RunningStats, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    out = (x - stats.mean) / torch.sqrt(stats.var + 1e-5)
    return torch.clamp(out, -clip, clip)


def denormalize(stats: RunningStats, x: torch.Tensor) -> torch.Tensor:
    return x * torch.sqrt(stats.var + 1e-5) + stats.mean
