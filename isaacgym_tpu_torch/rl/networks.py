"""Actor-critic networks (``isaacgym_tpu/rl/networks.py``, rl_games
``actor_critic`` builder parity).

Separate actor and critic MLPs ``[2048, 1536, 1024, 1024, 512, 512]`` with
ELU, a state-independent learnable log-std initialised to -2.0, linear mu and
value heads. Parameters are float32; the trunks compute in ``compute_dtype``
(bfloat16 by default: inputs, weights and biases are cast, the product and
the activation are bfloat16) and the heads in float32, as the JAX package's
flax modules do. Kernels start LeCun-normal (``variance_scaling(1, fan_in,
truncated_normal)``, flax's default) and biases zero; torch's own
``nn.Linear`` start differs and changes early training.

The products are ``torch.nn.functional.linear``: the JAX package computes
them outside any Pallas kernel. The trunk's layers are called as modules, so
that ``shard_params_tp`` (``parallel/mesh.py``) can shard them with
``torch.distributed.tensor.parallel``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as Fn

_ACTIVATIONS = {"elu": Fn.elu, "relu": Fn.relu, "selu": Fn.selu, "silu": Fn.silu,
                "tanh": torch.tanh}

# std of a unit normal truncated to [-2, 2] (flax's truncated_normal scale)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal`` on a torch ``(out, in)`` weight: a normal
    truncated to two standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    lo, hi = [0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0)]
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    with torch.no_grad():
        w.copy_((z.clamp(-2.0, 2.0) * std).to(w.dtype))
    return w


class CastLinear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype: the weight and the bias
    are cast to it."""

    def forward(self, x):
        return Fn.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class MLP(nn.Module):
    def __init__(self, in_dim: int, units: Sequence[int], activation: str = "elu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dims = [in_dim] + list(units)
        self.layers = nn.ModuleList(CastLinear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = _ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x = x.to(self.compute_dtype)
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class ActorCritic(nn.Module):
    """``forward(obs) -> (mu, log_sigma broadcast to mu, value)``."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (2048, 1536, 1024, 1024, 512, 512),
                 activation: str = "elu", sigma_init: float = -2.0, separate: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.actor_mlp = MLP(num_obs, units, activation, compute_dtype)
        self.critic_mlp = MLP(num_obs, units, activation, compute_dtype) if separate else None
        self.mu = nn.Linear(units[-1], num_actions)
        self.value = nn.Linear(units[-1], 1)
        self.log_sigma = nn.Parameter(torch.full((num_actions,), float(sigma_init)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's start: LeCun-normal kernels, zero biases, log_sigma kept."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, obs):
        actor_trunk = self.actor_mlp(obs)
        mu = self.mu(actor_trunk.to(torch.float32))
        critic_trunk = self.critic_mlp(obs) if self.critic_mlp is not None else actor_trunk
        value = self.value(critic_trunk.to(torch.float32))[..., 0]
        return mu, self.log_sigma.expand_as(mu), value


def gaussian_logp(mu, log_sigma, actions):
    """Diagonal-Gaussian log prob (summed over action dims)."""
    inv_var = torch.exp(-2.0 * log_sigma)
    return torch.sum(-0.5 * (actions - mu) ** 2 * inv_var - log_sigma
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_sigma):
    return torch.sum(log_sigma + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
