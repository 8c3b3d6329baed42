"""The JAX half of the paired KL run: the JAX launcher's own seed-42 draws,
its initial weights and env state, and its per-epoch KL, for the port to
replay (``python -m isaacgym_tpu_torch.parity.kl_pair DIR``).

    python tools/torch_kl_pair_export.py [--out build/kl_pair] [--epochs 12]
        [--ball-scale 1.000001]

Runs on the CPU. It trains ``HumanoidPingpongTiltNoEarlyStopG1`` as
``train.py`` does with ``task.randomize=false`` (the task, the trainer and
the env built from one composed config and one seed), epoch by epoch through
the two jitted halves of ``PPOTrainer._train_epoch`` (``_rollout_and_gae``,
then ``_update`` with the next key), and patches no draw. The draws are
read by replaying the key chains the run consumes:

* the trainer's: each rollout step splits ``ts.rng`` once and draws
  ``jax.random.normal(k, (B, A))``; the epoch then splits once more and
  ``_update`` splits that key into one ``jax.random.permutation`` key per
  mini-epoch;
* each env's: env i starts from ``split(PRNGKey(seed), B)[i]``, and its
  k-th ball launch is ``sample_ball_velocity`` of the k-th key's
  ``k_use`` (``split(key) -> (k_use, k_next)``, the next key being
  ``k_next``), launch 0 being the initial reset's.

Writes to ``--out``:

* ``meta.json``: task, seed, width, epochs, the config's horizon, mini-epochs
  and minibatch size, the overrides, and the checks below;
* ``weights.npz``: the initial flax parameters under ``/``-joined names
  (``actor_mlp/Dense_0/kernel`` ..., ``log_sigma``), the ``--init-from``
  layout of ``tools/torch_kl_diagnose.py``;
* ``state.npz``: the initial env state (``sim.<field>``, ``progress``,
  ``flags.<name>``, ``pre_ball_root``, ``ep_return``) and ``obs``;
* ``noise.npy`` (epochs * horizon, B, A) float32, ``perms.npy`` (epochs *
  mini_epochs, B * horizon) int32 and ``launches.npy`` (B, L, 3) float32;
* ``jax_metrics.json``: one record per epoch, rewritten as each epoch ends:
  the KL the launcher logs (the last mini-epoch's mean), the first
  minibatch's KL (before any optimizer step of the epoch, from the new
  observation normalizer), ``reward_mean``, ``a_loss``, ``c_loss`` and the
  other metrics.

Checks kept in ``meta.json``: launch 0 equals the initial state's ball
velocity; epoch 0's actions equal ``mu + exp(sigma) * noise``; and, unless
``launcher_check=False`` (the tests' small runs), the launcher's single-jit
``train_epoch`` run on a copy of the initial state gives epoch 0's KL
(``launcher_epoch0``). ``--ball-scale`` multiplies the initial ball
velocities (and with them the initial observation) by a factor: the
control run, which starts a last ulp away with the same draws. Cost on a
CPU: a few minutes per epoch at 4096 envs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASK = "HumanoidPingpongTiltNoEarlyStopG1"


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", os.environ.get(
        "ISAACGYM_TPU_CACHE", os.path.join(ROOT, "build", "jax_cache")))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return jax


def build(num_envs: int = 4096, seed: int = 42, overrides=(), compute_dtype=None):
    """The launcher's objects (``train.py``): (cfg, env, trainer, ts,
    env_state, obs). ``compute_dtype`` replaces the networks' (bf16) for a
    check at float32."""
    _jax()
    from isaacgym_tpu.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu.tasks import task_registry
    from isaacgym_tpu.utils.config import compose, preprocess_train_config
    cfg = compose(TASK, ["task.randomize=false", f"num_envs={num_envs}", f"seed={seed}"]
                  + list(overrides))
    preprocess_train_config(cfg)
    seed = int(cfg.get("seed", 42))
    env = task_registry()[TASK](cfg["task"], seed=seed)
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg.get("train", {})), seed=seed)
    if compute_dtype is not None:
        trainer.net = trainer.net.clone(compute_dtype=compute_dtype)
    ts = trainer.init_state()
    env_state, obs = env.reset()
    return cfg, env, trainer, ts, env_state, obs


def trainer_draws(trainer, rng, epochs: int):
    """(noise (epochs * H, B, A) float32, perms (epochs * M, B * H) int32):
    the trainer's action noise and minibatch permutations, epoch by epoch,
    from its key ``rng`` (``ts.rng``)."""
    jax = _jax()
    cfg, env = trainer.cfg, trainer.env
    B, A, H, M = env.num_envs, env.num_actions, cfg.horizon_length, cfg.mini_epochs
    normal = jax.jit(lambda k: jax.random.normal(k, (B, A)))
    perm = jax.jit(lambda k: jax.random.permutation(k, B * H))
    noise, perms = [], []
    for _ in range(epochs):
        for _ in range(H):
            rng, k = jax.random.split(rng)
            noise.append(np.asarray(normal(k)))
        rng, k = jax.random.split(rng)
        perms.extend(np.asarray(perm(kk)) for kk in jax.random.split(k, M))
    return np.stack(noise).astype(np.float32), np.stack(perms).astype(np.int32)


def ball_launches(env, seed: int, count: int):
    """(B, count, 3) float32: each env's first ``count`` ball launches."""
    jax = _jax()
    keys = jax.random.split(jax.random.PRNGKey(seed), env.num_envs)

    def chain(key):
        out = []
        for _ in range(count):
            k_use, key = jax.random.split(key)
            out.append(env.sample_ball_velocity(k_use))
        return jax.numpy.stack(out)

    return np.asarray(jax.jit(jax.vmap(chain))(keys), np.float32)


def launches_needed(env, steps: int) -> int:
    """Launches an env without early stop uses in ``steps`` steps: the
    initial one and one per episode end (every ``episodeLength - 1`` steps),
    plus one spare."""
    return 2 + steps // (env.max_episode_length - 1)


def flat_params(params) -> dict:
    """flax parameters -> ``{"actor_mlp/Dense_0/kernel": array, ...}``."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(params.get("params", params), ())
    return out


def state_arrays(env_state, obs) -> dict:
    """The env state (no PRNG keys, no DR) and obs as flat numpy arrays."""
    out = {f"sim.{f}": np.asarray(getattr(env_state.sim, f)) for f in env_state.sim._fields}
    out.update({f"flags.{k}": np.asarray(v) for k, v in env_state.flags.items()})
    out.update(progress=np.asarray(env_state.progress),
               pre_ball_root=np.asarray(env_state.pre_ball_root),
               ep_return=np.asarray(env_state.ep_return), obs=np.asarray(obs))
    return out


def scale_ball(env, env_state, factor: float):
    """The env state with the ball's velocity scaled by ``factor``, and its
    observation."""
    jax = _jax()
    ba = env.ball_actor
    root = env_state.sim.root.at[:, ba, 7:10].multiply(np.float32(factor))
    sim = env_state.sim._replace(root=root)
    state = env_state._replace(sim=sim, pre_ball_root=root[:, ba, :])
    obs = jax.vmap(env.observe_single)(sim, env._rb_fn(sim), state.flags)
    return state, obs


def first_minibatch_kl(trainer, params, obs_stats, batch, perm):
    """The first minibatch's KL before the epoch's first optimizer step."""
    from isaacgym_tpu.rl.ppo import gaussian_kl
    T = batch["logp"].shape[0]
    idx = np.asarray(perm)[: min(trainer.cfg.minibatch_size, T)]
    mu, log_sig, _ = trainer._policy(params, obs_stats, batch["obs"][idx])
    return float(gaussian_kl(mu, log_sig, batch["mu"][idx], batch["sigma"][idx]))


def epochs_run(trainer, ts, env_state, obs, epochs: int, perms=None):
    """Yield (epoch, metrics, batch, ts, env_state, obs) for each epoch of the
    launcher's computation, the two jitted halves composed as
    ``_train_epoch`` composes them. With ``perms`` (the replayed
    permutations) each record also carries the first minibatch's KL."""
    jax = _jax()
    roll, upd = jax.jit(trainer._rollout_and_gae), jax.jit(trainer._update)
    M = trainer.cfg.mini_epochs
    for it in range(epochs):
        env_state, obs, rng, batch, obs_stats, value_stats, metrics = roll(ts, env_state, obs)
        rng, k = jax.random.split(rng)
        params, opt_state, last_lr, aux = upd(ts, batch, obs_stats, k)
        metrics = {**metrics, **{k_: v[-1] for k_, v in aux.items()}, "last_lr": last_lr}
        metrics = {k_: float(v) for k_, v in metrics.items()}
        if perms is not None:
            metrics["kl_first_minibatch"] = first_minibatch_kl(
                trainer, ts.params, obs_stats, batch, perms[it * M])
        ts = ts._replace(params=params, opt_state=opt_state, obs_stats=obs_stats,
                         value_stats=value_stats, rng=rng, epoch=ts.epoch + 1,
                         last_lr=last_lr)
        yield it, metrics, batch, ts, env_state, obs


def _write_json(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def export(out: str, epochs: int = 12, num_envs: int = 4096, seed: int = 42, overrides=(),
           ball_scale: float = 1.0, launcher_check: bool = True, log=print,
           compute_dtype=None, on_epoch=None) -> dict:
    """Write the export (above). ``on_epoch(epoch, metrics, batch, ts)``, if
    given, sees each epoch's batch and train state."""
    jax = _jax()
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    cfg, env, trainer, ts, env_state, obs = build(num_envs, seed, overrides, compute_dtype)
    seed = int(cfg.get("seed", seed))
    pc = trainer.cfg
    noise, perms = trainer_draws(trainer, ts.rng, epochs)
    launches = ball_launches(env, seed, launches_needed(env, epochs * pc.horizon_length))
    ba = env.ball_actor
    launch0_err = float(np.abs(launches[:, 0] - np.asarray(env_state.sim.root[:, ba, 7:10])).max())
    if ball_scale != 1.0:
        env_state, obs = scale_ball(env, env_state, ball_scale)
    np.save(os.path.join(out, "noise.npy"), noise)
    np.save(os.path.join(out, "perms.npy"), perms)
    np.save(os.path.join(out, "launches.npy"), launches)
    np.savez(os.path.join(out, "weights.npz"), **flat_params(ts.params))
    np.savez(os.path.join(out, "state.npz"), **state_arrays(env_state, obs))
    meta = dict(task=TASK, seed=seed, num_envs=env.num_envs, num_actions=env.num_actions,
                num_obs=env.num_obs, epochs=epochs, horizon_length=pc.horizon_length,
                mini_epochs=pc.mini_epochs, minibatch_size=pc.minibatch_size,
                episode_length=env.max_episode_length, overrides=list(overrides),
                ball_scale=ball_scale, launch0_vs_state_max_abs=launch0_err,
                draws_seconds=time.time() - t0)
    _write_json(os.path.join(out, "meta.json"), meta)
    log(f"draws written to {out} in {time.time() - t0:.1f} s", flush=True)

    if launcher_check:
        copy = lambda t: jax.tree.map(lambda x: jax.numpy.array(x, copy=True), t)
        _, _, _, m = trainer.train_epoch(copy(ts), copy(env_state), obs)
        meta["launcher_epoch0"] = {k: float(v) for k, v in m.items()}
        _write_json(os.path.join(out, "meta.json"), meta)
        log(f"launcher epoch 0: kl {meta['launcher_epoch0']['kl']:.6g}", flush=True)

    records = []
    for it, metrics, batch, ts_it, *_ in epochs_run(trainer, ts, env_state, obs, epochs, perms):
        if on_epoch is not None:
            on_epoch(it, metrics, batch, ts_it)
        if it == 0:
            H, B = pc.horizon_length, env.num_envs
            want = (np.asarray(batch["mu"], np.float32)
                    + np.exp(np.asarray(batch["sigma"], np.float32))
                    * noise[:H].reshape(H * B, -1))
            meta["action_vs_noise_max_abs"] = float(
                np.abs(np.asarray(batch["action"]) - want).max())
            _write_json(os.path.join(out, "meta.json"), meta)
        records.append(dict(epoch=it, seconds=time.time() - t0, **metrics))
        _write_json(os.path.join(out, "jax_metrics.json"), records)
        log(f"jax epoch {it:3d} kl {metrics['kl']:.6g} kl_first_mb "
            f"{metrics['kl_first_minibatch']:.6g} reward_mean {metrics['reward_mean']:.6g}",
            flush=True)
    return dict(meta=meta, records=records)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "kl_pair"))
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--ball-scale", type=float, default=1.0)
    a = ap.parse_args(argv)
    export(a.out, a.epochs, ball_scale=a.ball_scale)


if __name__ == "__main__":
    main()
