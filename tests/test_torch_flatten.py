"""``flatten_optimizer`` in the port (``rl/ppo.py``): the flag selects the
per-tensor clip and Adam step, which equals ``optax.flatten``.

The trainer that the launcher's config builds with
``flatten_optimizer=true`` runs its step (``_update`` on an injected
gradient) against the JAX package's form, ``optax.flatten(chain(
clip_by_global_norm, adam(eps=1e-8)))`` (``isaacgym_tpu/rl/ppo.py:137``),
over four steps whose gradient norms cross the config's clip, at the gate
of ``test_clip_and_adam_matches_optax``: two float32 ulps of each parameter
plus 4e-6 lr. Without the clip (``truncate_grads=false``) the same steps
miss it by far. The flag changes nothing else of the update, and
checkpoints of a trainer with the flag restore into one without and back.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp
import optax

from isaacgym_tpu.rl.networks import ActorCritic as JActorCritic
from isaacgym_tpu_torch.interop import actor_critic_from_jax
from isaacgym_tpu_torch.rl import checkpoint
from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from isaacgym_tpu_torch.utils.config import compose

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
OBS, ACT, UNITS = 80, 7, (64, 32)
LR = 1e-3


class _StubEnv:
    num_envs, num_obs, num_actions = 16, OBS, ACT
    device = torch.device("cpu")


def _trainer(flat, **kw):
    cfg = PPOConfig(units=UNITS, horizon_length=8, minibatch_size=32, mini_epochs=2,
                    learning_rate=LR, flatten_optimizer=flat, **kw)
    return PPOTrainer(_StubEnv(), cfg, seed=0, compute_dtype=torch.float32)


def _launcher_trainer(overrides=()):
    """The flagship's launcher config with the flag, at narrow widths, one
    minibatch of 16 rows an update."""
    cfg = compose(TASK, ["train.params.config.flatten_optimizer=true",
                         "train.params.network.mlp.units=[64,32]",
                         "train.params.config.horizon_length=1",
                         "train.params.config.minibatch_size=16",
                         "train.params.config.mini_epochs=1", *overrides])
    pcfg = PPOConfig.from_train_cfg(cfg["train"])
    assert pcfg.flatten_optimizer and pcfg.units == UNITS
    return PPOTrainer(_StubEnv(), pcfg, seed=0, compute_dtype=torch.float32)


def _jax_params():
    net = JActorCritic(num_actions=ACT, units=UNITS, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS))))


def _excess(net, params_np, lr):
    want = actor_critic_from_jax(params_np)
    worst = -np.inf
    for n, p in net.named_parameters():
        w = want[n].numpy().astype(np.float64)
        ulp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
        d = np.abs(p.detach().numpy().astype(np.float64) - w) - (2 * ulp + 4e-6 * lr)
        worst = max(worst, float(d.max()))
    return worst


@pytest.mark.parametrize("clip", (True, False), ids=("clipped", "clip_dropped"))
def test_flat_step_matches_optax_flatten(clip):
    """Four steps at global norms 5, 0.3, 2 and 0.5 times the config's
    ``grad_norm``: the clip scales steps 1 and 3. The trainer's ``_update``
    takes each gradient through a loss whose gradient it is.
    ``clip_dropped`` is the same trainer with ``truncate_grads=false`` and
    must miss the gate (the check's bite)."""
    tr = _launcher_trainer(() if clip else ["train.params.config.truncate_grads=false"])
    cfg = tr.cfg
    lr, max_norm = cfg.learning_rate, cfg.grad_norm
    assert cfg.truncate_grads == clip and cfg.lr_schedule == "constant"
    params = _jax_params()
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(max_norm),
                                   optax.adam(lr, eps=1e-8)))
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jparams)
    ts = tr.init_state()
    net = ts.params
    net.load_state_dict(actor_critic_from_jax(params))
    names = [n for n, _ in net.named_parameters()]
    injected = {}

    def loss(net_, obs_stats, mbatch):
        total = sum((p * injected[n]).sum() for n, p in net_.named_parameters())
        return total, {"kl": torch.tensor(cfg.kl_threshold)}

    tr.loss = loss
    batch = {"logp": torch.zeros(cfg.minibatch_size)}
    rng = np.random.RandomState(8)
    excess = []
    for norm in (5.0, 0.3, 2.0, 0.5):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        scale = norm * max_norm / np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                                              for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * scale).astype(np.float32), g)
        updates, jopt = tx.update(jax.tree.map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        injected.update(actor_critic_from_jax(g))
        net, opt, last_lr, _ = tr._update(ts, batch, ts.obs_stats)
        ts = ts._replace(params=net, opt_state=opt, last_lr=last_lr)
        excess.append(_excess(net, jax.tree.map(np.asarray, jparams), lr))
    assert ts.opt_state.count == 4 and len(ts.opt_state.mu) == len(names)
    if clip:
        assert max(excess) <= 0, excess
    else:
        assert max(excess) > 0.1 * lr, excess


def test_flat_update_equals_the_per_tensor_update():
    """A whole ``_update`` (2 mini-epochs x 4 minibatches, the same
    permutations, every minibatch clipped) from the same weights and batch:
    the flag's parameters and moments equal the unflagged trainer's bit for
    bit, and the update moved the weights."""
    rng = np.random.RandomState(3)
    T = 128
    batch = {k: torch.as_tensor(v.astype(np.float32)) for k, v in dict(
        obs=rng.standard_normal((T, OBS)), action=rng.standard_normal((T, ACT)),
        logp=rng.standard_normal(T) - 5.0, mu=rng.standard_normal((T, ACT)) * 0.3,
        sigma=np.full((T, ACT), -2.0), value_n=rng.standard_normal(T),
        adv=rng.standard_normal(T) * 50.0, returns_n=rng.standard_normal(T)).items()}
    out = {}
    for flat in (False, True):
        tr = _trainer(flat, grad_norm=1.0)
        ts = tr.init_state()
        params, opt, _lr, aux = tr._update(ts, batch, ts.obs_stats)
        out[flat] = (torch.cat([p.detach().reshape(-1) for p in params.parameters()]),
                     torch.cat([m.reshape(-1) for m in opt.mu + opt.nu]), opt.count)
    (p0, m0, c0), (p1, m1, c1) = out[False], out[True]
    assert c0 == c1 == 8
    assert torch.equal(p1, p0) and torch.equal(m1, m0)
    start = torch.cat([p.detach().reshape(-1) for p in
                       _trainer(False).init_state().params.parameters()])
    assert (p0 - start).abs().max() > 10 * LR * 1e-2    # the update moved the weights


def test_launcher_flag_reaches_the_trainer_and_checkpoints_cross_forms(tmp_path):
    cfg = compose(TASK, ["train.params.config.flatten_optimizer=true"])
    assert PPOConfig.from_train_cfg(cfg["train"]).flatten_optimizer
    assert not PPOConfig.from_train_cfg(compose(TASK)["train"]).flatten_optimizer
    flat_tr, per_tr = _trainer(True), _trainer(False)
    ts = flat_tr.init_state()
    net = ts.params
    gen = torch.Generator().manual_seed(5)
    moments = lambda: [torch.rand(p.shape, generator=gen) for p in net.parameters()]
    ts = ts._replace(opt_state=ts.opt_state._replace(count=3, mu=moments(), nu=moments()))
    checkpoint.save(str(tmp_path / "flat.pt"), ts)
    back = checkpoint.restore(str(tmp_path / "flat.pt"), per_tr.init_state())
    assert back.opt_state.count == 3
    for a, b in zip(back.opt_state.mu + back.opt_state.nu, ts.opt_state.mu + ts.opt_state.nu):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(net.named_parameters(), back.params.named_parameters()):
        assert torch.equal(a, b), n
    checkpoint.save(str(tmp_path / "per.pt"), back)
    again = checkpoint.restore(str(tmp_path / "per.pt"), flat_tr.init_state())
    for a, b in zip(again.opt_state.nu, ts.opt_state.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(again.params.parameters(), net.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
