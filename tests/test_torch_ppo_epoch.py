"""The port's PPO against the JAX package's over whole updates and epochs.

``tests/test_torch_ppo.py`` holds the pieces to the JAX package over at
most three optimizer steps. Here the port is held over what one epoch of
the flagship's train config does: five mini-epochs of several minibatches
each, the normalizers over successive epochs, and two whole
``train_epoch``s on a small env. Networks are built at units (64, 32) and
run in float32 on both sides; the JAX parameters (flax, from a PRNG key)
are carried into the port with ``interop.actor_critic_from_jax``. Batches
come from numpy seeds. The random draws are injected into both packages:
minibatch permutations through ``jax.random.permutation`` (a table looked up
by the key the JAX package passes) and the port's
``ppo.minibatch_permutation``; action noise through ``jax.random.normal``
and the port's ``ppo.action_noise``.

Tolerances, and why:
  * ``_update`` over 5 mini-epochs x 4 minibatches (20 clipped Adam steps
    at lr 1e-3). Where the starting gradient is above 1e-5 (1e3 x Adam's
    eps) every parameter's total change agrees to 2e-2 lr (measured
    4e-3 lr): each step agrees to ~1e-4 lr as in the three-step test, and
    20 steps compound it through the gradients. Elsewhere a gradient near
    zero may change sign between the packages: up to 2 lr per step, 40 lr
    in all. The Adam moments agree to 1e-3 of each moment's largest
    entry (the moments are running averages of the same gradients;
    measured up to 1.7e-4); the per-mini-epoch means of the losses and the KL to
    1e-3 relative (measured up to 9e-5). A wrong permutation, a missing
    bias correction or clip, or an lr step out of place moves these by
    orders of magnitude more.
  * normalizers over three epochs' batches (float32 Chan merges on both
    sides): mean and var to 1e-6 relative plus 1e-6 of the lane's scale
    (a lane of 1e3 outliers has var ~1e3), count exactly; the normalized
    batch to 1e-4 absolute plus 8 float32 ulps of the lane's mean over the
    lane's std. The batch mean is a float32 sum of 4096 rows, rounded in
    another order by XLA and torch (a few ulps), and the normalizer divides
    it by the std: a lane at 1e2 with a std of 1e-2 moves by ~8e-4 per ulp,
    a constant lane (var ~5e-8, so sqrt(var + 1e-5) ~ 3e-3) by ~1e-5.
  * two whole epochs on the flagship at 8 envs, horizon 8: the JAX side
    steps its XLA env, the port its plain fused substep (the Pallas
    formulation). Over 16 steps the ball is in free flight (no contact in
    this window), so the states differ by float32 rounding of two
    formulations of the same dynamics, which grows over the steps (obs
    7.6e-6 apart in the first epoch, 2.8e-4 in the second): obs to 1e-3
    absolute; actions, mu, sigma, log-probs, value_n, returns_n and
    advantages to 5e-4 (measured up to 7.7e-5); the epoch's metrics to
    1e-3 relative plus 1e-4 absolute (measured ~5e-6 relative); the
    normalizers to 1e-4 relative plus 1e-5. The parameters after each
    epoch, leaf by leaf (log_sigma and the heads' biases too): the median
    entry to 2e-2 lr (measured up to 4.8e-4 lr, mu.bias in the second
    epoch) and every entry to 2 lr per Adam step, as above (measured 2.3 lr
    in all).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.rl import normalizer as JN
from isaacgym_tpu.rl.networks import ActorCritic as JActorCritic
from isaacgym_tpu.rl.ppo import PPOConfig as JPPOConfig, PPOTrainer as JPPOTrainer

from isaacgym_tpu_torch.interop import (actor_critic_from_jax, env_state_from_numpy,
                                        running_stats_from_numpy)
from isaacgym_tpu_torch.rl import normalizer as N
from isaacgym_tpu_torch.rl import ppo as P
from isaacgym_tpu_torch.utils.config import compose

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
OBS, ACT, UNITS = 80, 7, (64, 32)
LR = 1e-3


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_params(seed=0, units=UNITS, dtype="float32", mu_bias=True):
    net = JActorCritic(num_actions=ACT, units=units, compute_dtype=DTYPES[dtype][0])
    params = _np_tree(net.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS))))
    if mu_bias:
        params["params"]["mu"]["bias"] = np.linspace(-1.6, 1.6, ACT).astype(np.float32)
    return net, jax.tree.map(jnp.asarray, params)


def _trainers(jenv, penv, dtype="float32", mu_bias=True, **cfg_kw):
    cfg_kw = dict(dict(units=UNITS), **cfg_kw)
    jt = JPPOTrainer(jenv, JPPOConfig(**cfg_kw), seed=0)
    jt.net, params = _jax_params(units=cfg_kw["units"], dtype=dtype, mu_bias=mu_bias)
    pt = P.PPOTrainer(penv, P.PPOConfig(**cfg_kw), seed=0, compute_dtype=DTYPES[dtype][1])
    jts = jt.init_state()._replace(params=params, opt_state=jt.optimizer.init(params))
    pts = pt.init_state()
    pts.params.load_state_dict(actor_critic_from_jax(_np_tree(params)))
    return jt, jts, pt, pts


def _flat(sd):
    return np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in sorted(sd)])


def _adam_moments(jopt):
    adam = jopt.inner_state[1][0]
    return (actor_critic_from_jax(_np_tree(adam.mu)), actor_critic_from_jax(_np_tree(adam.nu)))


def _patch_jax_draws(monkeypatch, keys, values, fn_name):
    """Make ``jax.random.<fn_name>(k, ...)`` return ``values[i]`` where ``k``
    equals ``keys[i]`` (NaN where no key matches), traceable inside scans."""
    keys, values = jnp.asarray(keys), jnp.asarray(values)

    def draw(k, *args, **kw):
        match = jnp.all(keys == jnp.asarray(k)[None], axis=-1)
        out = values[jnp.argmax(match)]
        return jnp.where(match.any(), out, jnp.full_like(out, jnp.nan)) \
            if jnp.issubdtype(out.dtype, jnp.floating) else \
            jnp.where(match.any(), out, -1)

    monkeypatch.setattr(jax.random, fn_name, draw)


def _patch_port_draws(monkeypatch, perms=None, noises=None):
    if perms is not None:
        it = iter(perms)
        monkeypatch.setattr(P, "minibatch_permutation",
                            lambda T, g, d: torch.as_tensor(next(it), device=d))
    if noises is not None:
        it_n = iter(noises)
        monkeypatch.setattr(P, "action_noise",
                            lambda shape, g, d: torch.as_tensor(next(it_n), device=d))


def _assert_params_close(got, want, before, grad0, steps, what):
    """Total parameter change after ``steps`` Adam steps: 2e-2 lr where the
    starting gradient is far above Adam's eps, 2 lr per step elsewhere."""
    d_got, d_want = _flat(got) - _flat(before), _flat(want) - _flat(before)
    big = np.abs(grad0) > 1e-5
    assert big.mean() > 0.5, f"{what}: too few entries with a large gradient"
    err = np.abs(d_got - d_want) / LR
    assert err[big].max() <= 2e-2, f"{what}: change deviates {err[big].max():.2e} lr"
    assert err[~big].max(initial=0.0) <= 2.0 * steps, what
    # the parameters moved: many lr per entry over the update
    assert np.median(np.abs(d_want[big])) > 2 * LR


# ------------------------------------------------------------ the update --

class _NoEnv:
    num_envs, num_obs, num_actions = 16, OBS, ACT
    device = torch.device("cpu")


def _fixed_batch(jt, params, obs_stats, T):
    rng = np.random.RandomState(5)
    obs = (rng.standard_normal((T, OBS)) * 2 + 0.5).astype(np.float32)
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


def test_update_over_five_mini_epochs_of_four_minibatches(monkeypatch):
    """The whole ``_update`` of one epoch: mini_epochs 5 over T = 128 rows in
    minibatches of 32, the same permutations in both packages, 20 clipped
    Adam steps. Parameters, Adam moments and step count, the lr and every
    mini-epoch's mean loss and KL."""
    T, MB, EPOCHS = 128, 32, 5
    jt, jts, pt, pts = _trainers(_NoEnv(), _NoEnv(), minibatch_size=MB, mini_epochs=EPOCHS,
                                 grad_norm=0.5, learning_rate=LR)
    rng = np.random.RandomState(6)
    so = dict(mean=(rng.standard_normal(OBS) * 0.5).astype(np.float32),
              var=rng.uniform(0.5, 2.0, OBS).astype(np.float32), count=np.float32(100.0))
    jstats = JN.RunningStats(**{k: jnp.asarray(v) for k, v in so.items()})
    batch = _fixed_batch(jt, jts.params, jstats, T)
    perms = np.stack([rng.permutation(T) for _ in range(EPOCHS)]).astype(np.int32)
    key = jax.random.PRNGKey(1)

    # the gradient at the start, for the step comparison's mask
    captured = {}
    real_vg = jax.value_and_grad
    monkeypatch.setattr(jax, "value_and_grad",
                        lambda fn, **kw: captured.setdefault("fn", fn) and real_vg(fn, **kw))
    _patch_jax_draws(monkeypatch, jax.random.split(key, EPOCHS), perms, "permutation")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, jopt, jlr, jaux = jt._update(jts, jbatch, jstats, key)
    monkeypatch.undo()
    (_, _), jgrads = jax.value_and_grad(captured["fn"], has_aux=True)(jts.params, jbatch)
    grad0 = _flat(actor_critic_from_jax(_np_tree(jgrads)))
    assert np.isfinite(np.asarray(jaux["kl"])).all()

    kls = []
    loss = pt.loss
    monkeypatch.setattr(pt, "loss", lambda *a: (lambda r: (kls.append(r[1]), r)[1])(loss(*a)))
    _patch_port_draws(monkeypatch, perms=perms)
    before = actor_critic_from_jax(_np_tree(jts.params))
    net, opt, lr, aux = pt._update(pts, {k: torch.as_tensor(v) for k, v in batch.items()},
                                   running_stats_from_numpy(so))
    assert opt.count == EPOCHS * (T // MB) == int(jopt.inner_state[1][0].count)
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    _assert_params_close(got, actor_critic_from_jax(_np_tree(jparams)), before, grad0,
                         EPOCHS * T // MB, "20 steps")
    names = [n for n, _ in net.named_parameters()]
    for mine, theirs in zip((opt.mu, opt.nu), _adam_moments(jopt)):
        for n, m in zip(names, mine):
            w = np.asarray(theirs[n])
            np.testing.assert_allclose(m.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                       err_msg=n)
    np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    per_epoch = {k: np.asarray([[float(a[k]) for a in kls[e * 4:(e + 1) * 4]]
                                for e in range(EPOCHS)]).mean(1)
                 for k in ("a_loss", "c_loss", "kl", "entropy", "b_loss")}
    for k, v in per_epoch.items():
        np.testing.assert_allclose(v, np.asarray(jaux[k]), rtol=1e-3, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(aux[k]), float(np.asarray(jaux[k])[-1]), rtol=1e-3,
                                   atol=1e-7, err_msg=k)
    # the policy moved away from the batch's: KL grows over the update
    assert per_epoch["kl"][-1] > per_epoch["kl"][0] > 0


# ------------------------------------------------------------ normalizers --

def test_normalizers_over_three_epochs():
    """obs_stats and value_stats merged with three epochs' batches in turn:
    ordinary lanes, a lane constant across every batch, a lane with 1e3
    outliers in a few rows and a lane far from zero."""
    rng = np.random.RandomState(9)
    T, L = 4096, 6
    js, ps = JN.init_stats((L,)), N.init_stats((L,))
    jv, pv = JN.init_stats(()), N.init_stats(())
    for epoch in range(3):
        b = (rng.standard_normal((T, L)) * [1.0, 0.1, 0.0, 1.0, 0.01, 5.0]
             + [0.0, 1.0, 0.3, 0.0, 1e2, -2.0]).astype(np.float32)
        b[rng.choice(T, 3, replace=False), 3] = 1e3 * (epoch + 1)
        ret = (rng.standard_normal(T) * 30 - 50 * epoch).astype(np.float32)
        ret[epoch] = -1e3
        js, jv = JN.update_stats(js, jnp.asarray(b)), JN.update_stats(jv, jnp.asarray(ret))
        ps, pv = N.update_stats(ps, torch.as_tensor(b)), N.update_stats(pv, torch.as_tensor(ret))
        for got, want in ((ps, js), (pv, jv)):
            for f in ("mean", "var"):
                w = np.asarray(getattr(want, f))
                np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6,
                                           atol=1e-6 * max(1.0, float(np.abs(w).max())),
                                           err_msg=f"epoch {epoch} {f}")
            assert float(got.count) == float(want.count)
        # a float32 ulp of the lane's mean, divided by its std
        ulp = (np.spacing(np.abs(np.asarray(js.mean)).astype(np.float32))
               / np.sqrt(np.asarray(js.var) + 1e-5))
        err = np.abs(N.normalize(ps, torch.as_tensor(b)).numpy()
                     - np.asarray(JN.normalize(js, jnp.asarray(b))))
        assert (err <= 1e-4 + 8 * ulp).all(), f"epoch {epoch}: {(err / (1e-4 + ulp)).max()}"
        np.testing.assert_allclose(
            N.normalize(pv, torch.as_tensor(ret), clip=float("inf")).numpy(),
            np.asarray(JN.normalize(jv, jnp.asarray(ret), clip=jnp.inf)), atol=1e-4)
    # the constant lane: its var only decays (the prior's 1 x 1e-4 count)
    assert float(ps.var[2]) < 1e-7 and abs(float(ps.mean[2]) - 0.3) < 1e-6
    assert float(ps.var[3]) > 100.0


# --------------------------------------------------------- two train_epochs --

NE, H, MB_E = 8, 8, 16


@pytest.fixture(scope="module")
def envs():
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=NE)
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=NE, device="cpu")
    state, obs = je.reset()
    return je, pe, state, obs


def _jax_rollout_keys(rng, epochs, horizon, mini_epochs):
    """The keys the JAX trainer's ``_train_epoch`` hands ``jax.random.normal``
    (one per rollout step) and ``jax.random.permutation`` (one per
    mini-epoch), epoch by epoch."""
    noise_keys, perm_keys = [], []
    for _ in range(epochs):
        for _ in range(horizon):
            rng, k = jax.random.split(rng)
            noise_keys.append(np.asarray(k))
        rng, k = jax.random.split(rng)
        perm_keys.extend(np.asarray(jax.random.split(k, mini_epochs)))
    return np.stack(noise_keys), np.stack(perm_keys)


def _paired_epochs(monkeypatch, jt, jts, pt, pts, jstate, jobs, epochs, seed=11):
    """Run the JAX package's epoch (its ``_train_epoch``: the two jitted
    halves composed) and the port's ``train_epoch`` side by side from one env
    state, with the same action noise and permutations. Yields, per epoch,
    the JAX (batch, obs stats, value stats, params, metrics, obs) and the
    port's (state, metrics, batch, obs)."""
    cfg = pt.cfg
    B, A, T = pt.env.num_envs, pt.env.num_actions, pt.env.num_envs * cfg.horizon_length
    rng = np.random.RandomState(seed)
    noises = rng.standard_normal((epochs * cfg.horizon_length, B, A)).astype(np.float32)
    perms = np.stack([rng.permutation(T) for _ in range(epochs * cfg.mini_epochs)]
                     ).astype(np.int32)
    noise_keys, perm_keys = _jax_rollout_keys(jts.rng, epochs, cfg.horizon_length,
                                              cfg.mini_epochs)
    _patch_jax_draws(monkeypatch, noise_keys, noises, "normal")
    _patch_jax_draws(monkeypatch, perm_keys, perms, "permutation")
    roll, upd = jax.jit(jt._rollout_and_gae), jax.jit(jt._update)
    s_np = _np_tree(jstate)
    pstate = env_state_from_numpy(dict(sim=dict(s_np.sim._asdict()), progress=s_np.progress,
                                       flags=dict(s_np.flags), pre_ball_root=s_np.pre_ball_root,
                                       ep_return=s_np.ep_return))
    pobs = torch.as_tensor(np.array(jobs))
    batches = []
    real = pt._update
    monkeypatch.setattr(pt, "_update", lambda ts, b, s: (batches.append(b), real(ts, b, s))[1])
    _patch_port_draws(monkeypatch, perms=perms, noises=noises)
    for _ in range(epochs):
        jstate, jobs, jrng, jb, jos, jvs, jm = roll(jts, jstate, jobs)
        jrng, k = jax.random.split(jrng)
        jparams, jopt, jlr, jaux = upd(jts, jb, jos, k)
        jm = {**jm, **{k_: v[-1] for k_, v in jaux.items()}, "last_lr": jlr}
        before = jts.params
        jts = jts._replace(params=jparams, opt_state=jopt, obs_stats=jos, value_stats=jvs,
                           rng=jrng, epoch=jts.epoch + 1, last_lr=jlr)
        pts, pstate, pobs, pm = pt.train_epoch(pts, pstate, pobs)
        yield dict(batch=jb, obs_stats=jos, value_stats=jvs, params=jparams, before=before,
                   metrics=jm, obs=jobs), dict(ts=pts, metrics=pm, batch=batches[-1], obs=pobs)


def test_two_train_epochs_match(envs, monkeypatch):
    """Two whole epochs of the flagship (8 envs, horizon 8, minibatch 16, 5
    mini-epochs) from one env state and one set of weights, with the same
    action noise and permutations: each epoch's batch, metrics, normalizers
    and parameters."""
    je, pe, jstate, jobs = envs
    jt, jts, pt, pts = _trainers(je, pe, horizon_length=H, minibatch_size=MB_E, mini_epochs=5,
                                 learning_rate=LR)
    for epoch, (j, p) in enumerate(_paired_epochs(monkeypatch, jt, jts, pt, pts, jstate, jobs,
                                                  epochs=2)):
        jb, pb, jm, pm = j["batch"], p["batch"], j["metrics"], p["metrics"]
        for k, tol in (("obs", 1e-3), ("action", 5e-4), ("logp", 5e-4), ("mu", 5e-4),
                       ("sigma", 5e-4), ("value_n", 5e-4), ("returns_n", 5e-4),
                       ("adv", 5e-4)):
            np.testing.assert_allclose(pb[k].numpy(), np.asarray(jb[k]), rtol=0, atol=tol,
                                       err_msg=f"epoch {epoch} {k}")
        assert set(pm) == set(jm)
        for k in pm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-3, atol=1e-4,
                                       err_msg=f"epoch {epoch} {k}")
        for got, want in ((p["ts"].obs_stats, j["obs_stats"]),
                          (p["ts"].value_stats, j["value_stats"])):
            for f in got._fields:
                np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                           rtol=1e-4, atol=1e-5, err_msg=f"epoch {epoch} {f}")
        got = {n: q.detach().numpy() for n, q in p["ts"].params.named_parameters()}
        want = actor_critic_from_jax(_np_tree(j["params"]))
        for n in got:   # each leaf, the heads' biases and log_sigma among them
            d = np.abs(got[n].astype(np.float64) - np.asarray(want[n], np.float64)) / LR
            assert d.max() <= 2.0 * 5 * (NE * H // MB_E), f"epoch {epoch} {n}: {d.max():.2e} lr"
            assert np.median(d) <= 2e-2, f"epoch {epoch} {n}: median {np.median(d):.2e} lr"
        # the update moved the weights (those of obs lanes that are still zero
        # in the first steps, such as the history frames, get no gradient)
        before = _flat(actor_critic_from_jax(_np_tree(j["before"])))
        assert (np.abs(_flat(got) - before) > LR).mean() > 0.2
    np.testing.assert_allclose(p["obs"].numpy(), np.asarray(j["obs"]), atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("ne,epochs", [(256, 4), (4096, 1)])
def test_full_width_kl_is_the_jax_packages(monkeypatch, ne, epochs):
    """The flagship's train config at full width ([2048, 1536, 1024, 1024,
    512, 512], bf16 trunks, lr 2e-5, 5 mini-epochs) with minibatch = envs
    (32 minibatches per mini-epoch, as the flagship's 4096 envs with
    minibatch 4096 have), both packages from one env state and one JAX
    initialisation with the same noise and permutations: the KL the
    launcher logs is of the same size in both, tens to hundreds from this
    initialisation (PERF.md §6). The trajectories part within an epoch
    (bf16 rounding, then a contact flip), so the two KLs are held to each
    other only within a factor of 10. Slow: full-width updates on the CPU,
    about 4 minutes at 256 envs x 4 epochs and 8 at 4096 envs x 1. Prints
    the per-epoch KLs as a JSON line.
    """
    import json
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=ne)
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=ne, device="cpu")
    jstate, jobs = je.reset()
    cfg = P.PPOConfig.from_train_cfg(
        compose(TASK, [f"train.params.config.minibatch_size={ne}"])["train"])
    kw = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    jt, jts, pt, pts = _trainers(je, pe, dtype="bfloat16", mu_bias=False, **kw)
    kls = []
    for j, p in _paired_epochs(monkeypatch, jt, jts, pt, pts, jstate, jobs, epochs=epochs):
        kls.append((float(j["metrics"]["kl"]), float(p["metrics"]["kl"])))
    print(json.dumps({"num_envs": ne, "kl_jax_port_per_epoch": kls}))
    for kj, kp in kls:
        assert kj > 10.0 and kp > 10.0
        assert 0.1 < kp / kj < 10.0
