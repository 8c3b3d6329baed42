"""The port's PPO against the JAX package's, on the same inputs and weights.

Networks are built at units (64, 32); the JAX parameters (flax, made from a
PRNG key) are carried into the port with ``interop.actor_critic_from_jax``.
Batches, observations and normalizer states come from numpy seeds. Both
packages run in float32 (``compute_dtype``) except where bf16 is the point.

Tolerances, and why:
  * networks in float32: 1e-5 absolute. The same float32 products, summed in
    another order by XLA and by torch's CPU kernels.
  * networks in bf16: 1e-2 absolute on mu and value (outputs up to ~3).
    The trunks round every product and activation to bf16 (8 mantissa bits,
    a relative step of 2^-8 ~ 4e-3); the two packages round at the same
    places today, so they agree far inside the bound, but a product summed
    in another order can land on the other side of a bf16 rounding step, and
    one such step in a hidden unit moves the outputs by ~1e-3.
  * rollout values, GAE and returns: 1e-5 (absolute, relative to the values'
    scale of ~1): float32 network outputs in the same reverse recursion.
  * losses and KL: 1e-5 relative; gradients: 1e-4 relative in global norm
    (backward products add their own summation-order noise).
  * parameter changes after one clipped Adam step (at lr 1e-3): 1e-3 lr
    where the starting gradient is above 1e-5 (1e3 x Adam's eps), where the
    step is a smooth function of the gradients; up to 2 lr per step
    elsewhere, since a gradient component near zero may change sign between
    the packages. After three steps 5e-3 lr, and the last step's losses
    1e-4 relative: such a flip in the first step feeds the later gradients
    (test_update_three_adam_steps_match). Adam's first step is about lr sign(g) whatever the
    gradient's size, so the clip shows only from the second step on; the
    optimizer alone is held to optax's chain over four steps whose gradient
    norms cross the clip, to two float32 ulps of each parameter plus 4e-6 lr.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp
import optax

from isaacgym_tpu.rl import normalizer as JN
from isaacgym_tpu.rl.networks import ActorCritic as JActorCritic
from isaacgym_tpu.rl.ppo import PPOConfig as JPPOConfig, PPOTrainer as JPPOTrainer
from isaacgym_tpu.utils.config import compose as jax_compose

from isaacgym_tpu_torch.interop import actor_critic_from_jax, running_stats_from_numpy
from isaacgym_tpu_torch.rl import normalizer as N
from isaacgym_tpu_torch.rl.networks import ActorCritic
from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer, clip_and_adam
from isaacgym_tpu_torch.utils.config import compose, load_train_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
OBS, ACT, UNITS = 80, 7, (64, 32)
B, H = 16, 8


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _jax_params(compute_dtype=jnp.float32, seed=0):
    net = JActorCritic(num_actions=ACT, units=UNITS, compute_dtype=compute_dtype)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    # move the mu head's bias off zero so the bounds loss and the clipped
    # terms have something to act on
    p = jax.tree.map(np.asarray, params)
    p["params"]["mu"]["bias"] = np.linspace(-1.6, 1.6, ACT).astype(np.float32)
    return net, jax.tree.map(jnp.asarray, p)


def _port_net(params, compute_dtype=torch.float32):
    net = ActorCritic(OBS, ACT, units=UNITS, compute_dtype=compute_dtype)
    net.load_state_dict(actor_critic_from_jax(_np_tree(params)))
    return net


def _stats(rng, shape):
    return dict(mean=rng.standard_normal(shape).astype(np.float32) * 0.5,
                var=rng.uniform(0.5, 2.0, shape).astype(np.float32),
                count=np.float32(100.0))


# ---------------------------------------------------------------- configs --

def test_train_config_equals_the_yaml_loader():
    assert load_train_config(TASK) == jax_compose(TASK)["train"]


def test_ppo_config_and_overrides():
    cfg = compose(TASK, ["task.randomize=true", "num_envs=256", "seed=7", "test=true",
                         "train.params.config.learning_rate=1e-4", "device=cpu"])
    assert cfg["task"]["task"]["randomize"] is True
    assert cfg["task"]["env"]["numEnvs"] == 256 and cfg["seed"] == 7
    assert cfg["test"] is True and cfg["device"] == "cpu"
    ppo = PPOConfig.from_train_cfg(cfg["train"])
    assert ppo.learning_rate == 1e-4
    want = JPPOConfig.from_train_cfg(jax_compose(TASK)["train"])
    got = PPOConfig.from_train_cfg(load_train_config(TASK))
    assert {k: getattr(got, k) for k in got.__dataclass_fields__} == {
        k: getattr(want, k) for k in got.__dataclass_fields__}
    # flatten_optimizer is ported (tests/test_torch_flatten.py holds it to optax.flatten)
    flat = PPOConfig.from_train_cfg({"params": {"config": {"flatten_optimizer": True}}})
    assert flat.flatten_optimizer and not ppo.flatten_optimizer


# --------------------------------------------------------------- networks --

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_networks_match(dtype, tol):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jnet, params = _jax_params(jdt)
    net = _port_net(params, tdt)
    obs = np.random.RandomState(1).standard_normal((64, OBS)).astype(np.float32)
    mu_j, ls_j, v_j = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mu, ls, v = net(torch.as_tensor(obs))
    assert mu.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=tol, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=tol, rtol=0)
    np.testing.assert_array_equal(ls.detach().numpy(), np.asarray(ls_j))


def test_initialisation_is_lecun_normal():
    """flax's start: kernel std sqrt(1/fan_in), truncated at 2 std; biases
    zero; log_sigma -2."""
    net = ActorCritic(OBS, ACT, units=(512, 256))
    net.reset_parameters(torch.Generator().manual_seed(0))
    w = net.actor_mlp.layers[1].weight.detach().double()
    std = np.sqrt(1.0 / 512)
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(net.mu.bias.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(net.log_sigma.detach().numpy(), -2.0)


def test_normalizer_matches():
    rng = np.random.RandomState(2)
    s = _stats(rng, (5,))
    batch = rng.standard_normal((300, 5)).astype(np.float32) * 3 + 1
    want = JN.update_stats(JN.RunningStats(**{k: jnp.asarray(v) for k, v in s.items()}),
                           jnp.asarray(batch))
    got = N.update_stats(running_stats_from_numpy(s), torch.as_tensor(batch))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6)
    x = torch.as_tensor(batch)
    np.testing.assert_allclose(N.normalize(got, x).numpy(),
                               np.asarray(JN.normalize(want, jnp.asarray(batch))), atol=1e-5)
    np.testing.assert_allclose(N.denormalize(got, x).numpy(),
                               np.asarray(JN.denormalize(want, jnp.asarray(batch))), atol=1e-5)


# ---------------------------------------------------- rollout, GAE, stats --

def _scripted_sequences():
    """Obs, reward, done and time-out sequences that ignore the actions:
    some envs time out (bootstrapped), some terminate, some run on."""
    rng = np.random.RandomState(3)
    obs = rng.standard_normal((H + 1, B, OBS)).astype(np.float32)
    rew = (rng.standard_normal((H, B)) * 50).astype(np.float32)
    done = np.zeros((H, B), bool)
    done[3, :6] = True
    done[6, 4:10] = True
    time_out = np.zeros((H, B), bool)
    time_out[3, :3] = True
    time_out[6, 8:10] = True
    return obs, rew, done, time_out


class _JaxStubEnv:
    num_envs, num_obs, num_actions = B, OBS, ACT

    def __init__(self):
        self.obs, self.rew, self.done, self.to = (jnp.asarray(x) for x in _scripted_sequences())

    def step_fn(self, t, action):
        done = self.done[t]
        info = dict(time_outs=self.to[t], episode_done=done,
                    episode_return=jnp.where(done, self.rew[t], 0.0),
                    episode_length=jnp.where(done, t + 1, 0), episode_events={})
        return t + 1, self.obs[t + 1], self.rew[t], done, info


class _TorchStubEnv:
    num_envs, num_obs, num_actions = B, OBS, ACT
    device = torch.device("cpu")

    def __init__(self):
        self.obs, self.rew, self.done, self.to = (torch.as_tensor(x)
                                                  for x in _scripted_sequences())

    def step(self, t, action):
        done = self.done[t]
        info = dict(time_outs=self.to[t], episode_done=done,
                    episode_return=torch.where(done, self.rew[t], 0.0),
                    episode_length=torch.where(done, torch.tensor(t + 1), 0),
                    episode_events={})
        return t + 1, self.obs[t + 1], self.rew[t], done, info


def _trainers(**cfg_kw):
    cfg_kw = dict(dict(horizon_length=H, units=UNITS, minibatch_size=B * H, mini_epochs=1),
                  **cfg_kw)
    jt = JPPOTrainer(_JaxStubEnv(), JPPOConfig(**cfg_kw), seed=0)
    jnet, params = _jax_params()
    jt.net = jnet
    pt = PPOTrainer(_TorchStubEnv(), PPOConfig(**cfg_kw), seed=0,
                    compute_dtype=torch.float32)
    jts = jt.init_state()._replace(params=params, opt_state=jt.optimizer.init(params))
    pts = pt.init_state()
    pts.params.load_state_dict(actor_critic_from_jax(_np_tree(params)))
    return jt, jts, pt, pts


def test_rollout_and_gae_match():
    jt, jts, pt, pts = _trainers()
    rng = np.random.RandomState(4)
    so, sv = _stats(rng, (OBS,)), _stats(rng, ())
    jts = jts._replace(obs_stats=JN.RunningStats(**{k: jnp.asarray(v) for k, v in so.items()}),
                       value_stats=JN.RunningStats(**{k: jnp.asarray(v) for k, v in sv.items()}))
    pts = pts._replace(obs_stats=running_stats_from_numpy(so),
                       value_stats=running_stats_from_numpy(sv))
    obs0 = _scripted_sequences()[0][0]
    _, _, _, jb, jos, jvs, jm = jt._rollout_and_gae(jts, jnp.asarray(0), jnp.asarray(obs0))
    _, _, pb, pos, pvs, pm = pt._rollout_and_gae(pts, 0, torch.as_tensor(obs0))
    for k in ("obs", "mu", "sigma", "value_n", "returns_n", "adv"):
        np.testing.assert_allclose(pb[k].numpy(), np.asarray(jb[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    for got, want in ((pos, jos), (pvs, jvs)):
        for f in got._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
    for k in ("episode_return_sum", "episode_length_sum", "episode_count", "reward_mean",
              "episode_reward_scale", "value_mean", "adv_std"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert set(pm) == set(jm)
    # the sampled actions differ (two RNG streams); their log-probs follow them
    assert not np.allclose(pb["action"].numpy(), np.asarray(jb["action"]))


# ------------------------------------------------------------------ update --

def _fixed_batch(jt, params, obs_stats, T):
    """A batch around the current policy: actions near mu, old log-probs,
    mu and sigma slightly off, so ratios cross the clip and KL is > 0."""
    rng = np.random.RandomState(5)
    obs = rng.standard_normal((T, OBS)).astype(np.float32)
    mu, ls, _ = jt._policy(params, obs_stats, jnp.asarray(obs))
    mu, ls = np.asarray(mu), np.asarray(ls)
    action = (mu + np.exp(ls) * rng.standard_normal(mu.shape)).astype(np.float32)
    old_mu = (mu + 0.05 * rng.standard_normal(mu.shape)).astype(np.float32)
    logp = (-0.5 * (action - old_mu) ** 2 / np.exp(2 * ls) - ls
            - 0.5 * np.log(2 * np.pi)).sum(-1).astype(np.float32)
    value_n = rng.standard_normal(T).astype(np.float32)
    return dict(obs=obs, action=action, logp=logp, mu=old_mu, sigma=ls.astype(np.float32),
                value_n=value_n, adv=rng.standard_normal(T).astype(np.float32),
                returns_n=(value_n + rng.standard_normal(T)).astype(np.float32))


def _flat(sd):
    return np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in sorted(sd)])


def _jax_update(jt, jts, batch, jstats, monkeypatch):
    """The JAX package's ``_update`` on ``batch``, and its loss and gradients
    at the starting parameters (the loss function captured from inside)."""
    captured = {}
    real = jax.value_and_grad

    def capture(fn, **kw):
        captured["loss_fn"] = fn
        return real(fn, **kw)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    monkeypatch.setattr(jax, "value_and_grad", capture)
    jparams, _, jlr, jaux = jt._update(jts, jbatch, jstats, jax.random.PRNGKey(1))
    monkeypatch.undo()
    (jtotal, jl), jgrads = jax.value_and_grad(captured["loss_fn"], has_aux=True)(
        jts.params, jbatch)
    return jparams, jlr, jaux, jtotal, jl, jgrads


def _assert_steps_match(got, want, before, grad0, lr, tol, what):
    """Parameter changes after Adam steps, port against JAX. Where the
    starting gradient is far above Adam's eps (|g| > 1e-5 = 1e3 eps) the
    step is a smooth function of the gradients and must agree to ``tol``
    lr. Elsewhere a gradient near zero may change sign between the
    packages, and its entry may differ by up to 2 lr per step taken (the
    returned largest deviation there, in lr)."""
    d_got, d_want = _flat(got) - _flat(before), _flat(want) - _flat(before)
    big = np.abs(grad0) > 1e-5
    assert big.mean() > 0.5, f"{what}: too few entries with a large gradient"
    err = np.abs(d_got - d_want)
    assert err[big].max() <= tol * lr, f"{what}: step deviates {err[big].max() / lr:.2e} lr"
    return err[~big].max(initial=0.0) / lr


# lr large enough that float32 rounding of the parameters (|p| <= 1.6, one
# ulp ~1.2e-7) stays far below the 1e-3 lr gate on the steps
LR = 1e-3


def test_update_losses_gradients_and_adam_step(monkeypatch):
    """One clipped Adam step (mini_epochs 1, minibatch T): losses, KL,
    gradients and the step itself. Adam's first step is lr g / (|g| +
    eps), so it shows the gradient's sign and the update's direction and
    size, not the clip (see test_clip_and_adam_matches_optax)."""
    T = B * H
    jt, jts, pt, pts = _trainers(grad_norm=0.5, learning_rate=LR)
    rng = np.random.RandomState(6)
    so = _stats(rng, (OBS,))
    jstats = JN.RunningStats(**{k: jnp.asarray(v) for k, v in so.items()})
    batch = _fixed_batch(jt, jts.params, jstats, T)
    jparams, jlr, jaux, jtotal, jl, jgrads = _jax_update(jt, jts, batch, jstats, monkeypatch)

    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    pstats = running_stats_from_numpy(so)
    net = pts.params
    total, aux = pt.loss(net, pstats, tbatch)
    grads = torch.autograd.grad(total, list(net.parameters()))
    names = [n for n, _ in net.named_parameters()]

    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl"):
        np.testing.assert_allclose(float(aux[k]), float(jl[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(aux["b_loss"]) > 0 and float(aux["kl"]) > 0
    gj = _flat(actor_critic_from_jax(_np_tree(jgrads)))
    gp = _flat({n: g.numpy() for n, g in zip(names, grads)})
    assert np.linalg.norm(gp - gj) <= 1e-4 * np.linalg.norm(gj)

    before = actor_critic_from_jax(_np_tree(jts.params))
    p_net, _, lr, paux = pt._update(pts, tbatch, pstats)
    got = {n: p.detach().numpy() for n, p in p_net.named_parameters()}
    want = actor_critic_from_jax(_np_tree(jparams))
    small_err = _assert_steps_match(got, want, before, gj, LR, 1e-3, "one step")
    assert small_err <= 2.0
    # a descent step: every large-gradient entry moved against its gradient
    big = np.abs(gj) > 1e-5
    assert np.all((_flat(got) - _flat(before))[big] * gj[big] < 0)
    np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    for k in ("a_loss", "c_loss", "kl"):
        np.testing.assert_allclose(float(paux[k]), float(jaux[k][-1]), rtol=1e-5, err_msg=k)


def test_update_three_adam_steps_match(monkeypatch):
    """Three clipped Adam steps on the whole batch (mini_epochs 3, minibatch
    T: the permutation only reorders the rows of a mean). From the second
    step on, the moment estimates, the bias corrections and the clip
    coefficient of each step (the gradient norm is above grad_norm and
    changes between steps) set the step. A gradient component near zero
    that changes sign in the first step (one of ~15k here) moves its
    parameter by up to 2 lr and, through it, the later steps' gradients:
    the changes must agree to 5e-3 lr where the starting gradient is large
    (measured ~7e-4 lr; a missing clip or a wrong bias correction moves
    them by ~1 lr), and the last step's losses, taken at parameters that
    already differ so, to 1e-4 relative (measured ~2e-5)."""
    T = B * H
    jt, jts, pt, pts = _trainers(grad_norm=0.5, learning_rate=LR, mini_epochs=3)
    rng = np.random.RandomState(7)
    so = _stats(rng, (OBS,))
    jstats = JN.RunningStats(**{k: jnp.asarray(v) for k, v in so.items()})
    batch = _fixed_batch(jt, jts.params, jstats, T)
    jparams, jlr, jaux, _, _, jgrads = _jax_update(jt, jts, batch, jstats, monkeypatch)
    gj = _flat(actor_critic_from_jax(_np_tree(jgrads)))
    assert np.linalg.norm(gj) > 0.5    # the clip acts

    before = actor_critic_from_jax(_np_tree(jts.params))
    p_net, opt_state, lr, paux = pt._update(
        pts, {k: torch.as_tensor(v) for k, v in batch.items()}, running_stats_from_numpy(so))
    assert opt_state.count == 3
    got = {n: p.detach().numpy() for n, p in p_net.named_parameters()}
    want = actor_critic_from_jax(_np_tree(jparams))
    assert _assert_steps_match(got, want, before, gj, LR, 5e-3, "three steps") <= 6.0
    for k in ("a_loss", "c_loss", "kl"):
        np.testing.assert_allclose(float(paux[k]), float(jaux[k][-1]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("max_norm", [None, 1.0])
def test_clip_and_adam_matches_optax(max_norm):
    """The optimizer alone against the JAX package's optax chain, over four
    steps of fixed gradients with global norms 5, 0.3, 2 and 0.5: with
    max_norm 1 the clip scales steps 1 and 3 only, so its coefficient
    changes between steps and shows in the moments. The same float32
    formula (optax's Adam and clip written out, its float32 bias
    corrections too), so after every step each parameter agrees to two
    float32 ulps of itself (2.4e-7 at the largest, |p| = 1.6, or 2.4e-4 lr)
    plus 4e-6 lr: the moments are the same expressions rounded in another
    order (torch's fused add-multiply), which moves the steps by a few
    float32 ulps (~1e-7 lr each). A missing clip or a wrong bias
    correction moves the parameters by ~0.1 lr or more."""
    cfg = dict(learning_rate=LR, grad_norm=max_norm or 1.0, truncate_grads=max_norm is not None)
    jt, jts, pt, pts = _trainers(**cfg)
    params = jts.params
    jopt = jts.opt_state
    net, state = pts.params, pts.opt_state
    names = [n for n, _ in net.named_parameters()]
    before = actor_critic_from_jax(_np_tree(params))
    rng = np.random.RandomState(8)
    lr = torch.tensor(LR)
    for norm in (5.0, 0.3, 2.0, 0.5):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), _np_tree(params))
        scale = norm / np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                                   for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * scale).astype(np.float32), g)
        updates, jopt = jt.optimizer.update(jax.tree.map(jnp.asarray, g), jopt, params)
        params = optax.apply_updates(params, updates)
        gt = actor_critic_from_jax(g)
        state = clip_and_adam(list(net.parameters()), [gt[n] for n in names], state, lr,
                              max_norm)
        got = {n: p.detach().numpy() for n, p in net.named_parameters()}
        want = actor_critic_from_jax(_np_tree(params))
        w = _flat(want)
        ulp = np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
        excess = np.abs(_flat(got) - w) - (2 * ulp + 4e-6 * LR)
        assert excess.max() <= 0, f"step at norm {norm}: {excess.max():.2e} beyond the bound"


@pytest.mark.parametrize("schedule,epoch,shift", [
    ("linear", 1000, 0.0), ("adaptive", 0, 0.0), ("adaptive", 0, 2.0)])
def test_lr_schedules_match(schedule, epoch, shift):
    """linear: lr x (1 - epoch / max_epochs); adaptive: x 1.5 on a tiny KL
    (old policy = current), / 1.5 on a large one (old mu shifted)."""
    T = B * H
    jt, jts, pt, pts = _trainers(lr_schedule=schedule, max_epochs=2000)
    jts = jts._replace(epoch=jnp.asarray(epoch, jnp.int32))
    pts = pts._replace(epoch=epoch)
    jstats = JN.init_stats((OBS,))
    batch = _fixed_batch(jt, jts.params, jstats, T)
    mu, ls, _ = jt._policy(jts.params, jstats, jnp.asarray(batch["obs"]))
    batch["mu"] = np.asarray(mu) + shift
    _, _, jlr, _ = jt._update(jts, {k: jnp.asarray(v) for k, v in batch.items()}, jstats,
                              jax.random.PRNGKey(1))
    _, _, lr, _ = pt._update(pts, {k: torch.as_tensor(v) for k, v in batch.items()},
                             N.init_stats((OBS,)))
    np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    lr0 = PPOConfig().learning_rate
    expect = {("linear", 0.0): lr0 * 0.5, ("adaptive", 0.0): lr0 * 1.5,
              ("adaptive", 2.0): lr0 / 1.5}[(schedule, shift)]
    np.testing.assert_allclose(float(lr), expect, rtol=1e-6)
