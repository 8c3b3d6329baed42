"""The JAX half of the port's parity tool: JAX env steps at the gates' widths,
written for ``python -m isaacgym_tpu_torch.parity.env_step DIR``.

    python tools/torch_parity_export.py [--out build/parity] [--tasks ...]
        [--fixture-dir DIR] [--kernel-reference] [--dr]

Runs on the CPU, where the JAX env step is its XLA path. For each task it
rolls the JAX env ``STEPS`` steps under uniform random actions in [-1, 1]
from ``PRNGKey(SEED)`` and keeps the state and action of every
``STRIDE``-th step, as ``tools/parity_tpu.py``'s ``run_task`` does with its
defaults (160 steps, stride 10: 16 states); in the last kept state half the envs (the even ones) are moved
to their episode's last step, so that the step resets them. It then steps
each kept state once with its action and writes, per task,
``<out>/<name>.npz`` (compressed):

* ``meta_json``: the task, its registry name, width, states, steps, stride,
  seed, the terrain seed (or none), obs and action sizes and the ball's
  actor;
* inputs: ``in.sim.<field>``, ``in.progress``, ``in.flags.<name>``,
  ``in.pre_ball_root``, ``in.ep_return``, ``in.rng`` (the JAX per-env keys)
  and ``action``, each with a leading state axis;
* outputs: ``out.sim.<field>`` (the reset envs' new ball roots among them),
  ``out.progress``, ``out.flags.<name>``, ``out.pre_ball_root``,
  ``out.ep_return``, ``out.obs``, ``out.reward``, ``out.done`` and
  ``out.info.<time_outs|episode_done|episode_length>``.

With ``--kernel-reference`` the kept states (still from the XLA rollout)
are stepped through the JAX package's own fused Pallas kernel instead, in
interpret mode (``Simulator._maybe_build_pallas(force=True)``; widths a
multiple of 128), into ``<out>/<name>_kernel.npz``: the path the JAX
package runs on its TPU, which the port's kernels follow. It costs an
interpret-mode trace per task; C8's and C10's kernels take far longer.

With ``--dr`` the envs train-step with domain randomization
(``task.randomize: true``; the flagship, C8 and C10 only) into
``<out>/<name>_dr.npz``. After the reset every env's ``DRParams`` are drawn
again at ``DR_GLOBAL_STEP`` (the schedules' end, so every term is at full
strength) and the rollout starts there; the last kept state also has every
env's ``randomize_buf`` at ``frequency - 1``, so the envs it resets draw new
parameters. The RNG streams of the two packages differ, so every draw of
each step is written beside its inputs and outputs for the port to replay:
``in.dr.<field>``, ``in.randomize_buf``, ``in.global_step`` (and the same
under ``out.``), ``draw.action_noise`` and ``draw.obs_noise``, the noise
the JAX step added to the actions and the observations
(``env/vec_task.py:206-208,266-267``), and ``draw.dr.<field>``, the fresh
``DRParams`` the JAX step drew for every env (``:263-264``) before it kept
them on the envs it re-randomized (:func:`dr_fresh`): the port replays that
draw, so that ``out.dr`` checks which envs took it.

With ``--fixture-dir`` it also writes each task's first 64 envs of states
3, 7, 11 and 15 (the last with its resets) in the same form; those files
are the port's committed fixture (``isaacgym_tpu_torch/parity/data/``).

Tasks (name: registry task, width): the widths of ``DEFAULT_SIZES`` in
``tools/parity_tpu.py`` for the flagship (1024), C6 (1024), C8 (512), C10
(256) and C11 (256); C5, C9 and the terrain flagship (``rough_terrain_cfg``, seed 0,
obs 305) at 1024. Cost on a CPU: about a minute per task for the small
ones, several for C10 and the terrain flagship.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.parity_tpu import DEFAULT_SIZES  # noqa: E402

FLAGSHIP = "HumanoidPingpongTiltNoEarlyStopG1"
TASKS = {  # name -> (registry task, width, terrain seed or None)
    "flagship": (FLAGSHIP, DEFAULT_SIZES[FLAGSHIP], None),
    "c5": ("HumanoidPingpongG1", 1024, None),
    "c6": ("HumanoidPingpongTiltG1", DEFAULT_SIZES["HumanoidPingpongTiltG1"], None),
    "c8": ("Humanoid12PingpongTiltG1", DEFAULT_SIZES["Humanoid12PingpongTiltG1"], None),
    "c9": ("HumanoidPingpongAlignmentG1", 1024, None),
    "c10": ("HumanoidPingpongTiltNESSparse27DOFG1",
            DEFAULT_SIZES["HumanoidPingpongTiltNESSparse27DOFG1"], None),
    "terrain": (FLAGSHIP, 1024, 0),
    "c11": ("HumanoidPingpong5ActorG1", DEFAULT_SIZES["HumanoidPingpong5ActorG1"], None),
}
STEPS, STRIDE, SEED = 160, 10, 0   # tools/parity_tpu.py's defaults
DR_TASKS = ("flagship", "c8", "c10")
DR_GLOBAL_STEP = 3000   # the DR schedules' ``schedule_steps``: every term at full strength
FIXTURE_ENVS = 64
FIXTURE_STATES = (3, 7, 11, 15)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", os.environ.get(
        "ISAACGYM_TPU_CACHE", os.path.join(ROOT, "build", "jax_cache")))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return jax


def make_jax_env(task: str, num_envs: int, terrain_seed, tmp: str, dr: bool = False):
    """The JAX env; with a terrain seed, on the port's seeded rough field
    (``rough_terrain_cfg``), handed to the JAX package as an ``.npy``; with
    ``dr``, under domain randomization."""
    _jax()
    import isaacgym_tpu
    if dr:
        from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
        jcfg = jax_load_task_config(task)
        jcfg["task"]["randomize"] = True
        return isaacgym_tpu.make(seed=0, task=task, num_envs=num_envs, cfg=jcfg)
    if terrain_seed is None:
        return isaacgym_tpu.make(seed=0, task=task, num_envs=num_envs)
    from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
    from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
    from isaacgym_tpu_torch.utils.config import load_task_config
    plane = dict(rough_terrain_cfg(load_task_config(task), seed=terrain_seed)["env"]["plane"])
    npy = os.path.join(tmp, "height_map.npy")
    np.save(npy, plane["terrain"])
    plane["terrain"] = npy
    jcfg = jax_load_task_config(task)
    jcfg["env"]["plane"] = plane
    jcfg["env"]["heightmap"] = {"enabled": True}
    return isaacgym_tpu.make(seed=0, task=task, num_envs=num_envs, cfg=jcfg)


def _state_arrays(prefix: str, s) -> dict:
    out = {f"{prefix}.sim.{f}": np.asarray(getattr(s.sim, f)) for f in s.sim._fields}
    out.update({f"{prefix}.flags.{k}": np.asarray(v) for k, v in s.flags.items()})
    out.update({f"{prefix}.progress": np.asarray(s.progress),
                f"{prefix}.pre_ball_root": np.asarray(s.pre_ball_root),
                f"{prefix}.ep_return": np.asarray(s.ep_return)})
    if s.dr is not None:
        out.update({f"{prefix}.dr.{f}": np.asarray(getattr(s.dr, f)) for f in s.dr._fields})
        out.update({f"{prefix}.randomize_buf": np.asarray(s.randomize_buf),
                    f"{prefix}.global_step": np.asarray(s.global_step)})
    return out


def full_strength_dr(env, state):
    """``state`` with every env's DRParams drawn again at ``DR_GLOBAL_STEP``
    from its own key, and the global step there."""
    jax = _jax()
    step = jax.numpy.asarray(DR_GLOBAL_STEP, jax.numpy.int32)
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 7))(state.rng)
    dr = jax.vmap(lambda k: env.randomizer.sample(k, step))(keys)
    return state._replace(dr=dr, global_step=step)


def dr_draws(env, s) -> dict:
    """The noise the JAX step adds to the actions and the observations of
    state ``s`` (its keys, ``env/vec_task.py:206-208,266-267``)."""
    jax = _jax()
    jnp = jax.numpy
    B = env.num_envs
    ka = jax.random.fold_in(jax.random.PRNGKey(env.seed + 101), s.global_step)
    ko = jax.random.fold_in(jax.random.PRNGKey(env.seed + 202), s.global_step + 1)
    return {"draw.action_noise": np.asarray(env.randomizer.action_noise(
                ka, jnp.zeros((B, env.num_actions), jnp.float32))),
            "draw.obs_noise": np.asarray(env.randomizer.observation_noise(
                ko, jnp.zeros((B, env.num_obs), jnp.float32)))}


def dr_fresh(env, s, s2, done) -> dict:
    """The fresh ``DRParams`` the JAX step from ``s`` to ``s2`` drew for every
    env (``env/vec_task.py:261-268``): on the envs it re-randomized the
    parameters it kept (``s2.dr``), on the others the draw it discarded,
    drawn again here from ``s2``'s keys at ``s2``'s global step (within the
    last place of the step's own, which a separate trace may round
    differently)."""
    jax = _jax()
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 13))(s2.rng)
    dr = jax.vmap(lambda k: env.randomizer.sample(k, s2.global_step))(keys)
    redrawn = np.asarray(done).astype(bool) & (
        np.asarray(s.randomize_buf) + 1 >= env.randomizer.frequency)
    out = {}
    for f in dr._fields:
        kept, fresh = np.asarray(getattr(s2.dr, f)), np.asarray(getattr(dr, f))
        mask = redrawn.reshape((-1,) + (1,) * (kept.ndim - 1))
        out[f"draw.dr.{f}"] = np.where(mask, kept, fresh)
    return out


def rollout_samples(env, steps: int, stride: int, seed: int):
    """[(state, action)] of every ``stride``-th step of a random-action
    rollout (``tools/parity_tpu.py:116-136``), the last state's even envs
    moved to their episode's last step; numpy."""
    jax = _jax()
    B, A = env.num_envs, env.num_actions

    @jax.jit
    def roll(state, key):
        def body(carry, _):
            s, k = carry
            k, ka = jax.random.split(k)
            a = jax.random.uniform(ka, (B, A), minval=-1.0, maxval=1.0)
            s2, *_ = env.step_fn(s, a)
            return (s2, k), (s, a)
        _, (saved, acts) = jax.lax.scan(body, (state, key), None, length=steps)
        idx = jax.numpy.arange(0, steps, stride)
        return jax.tree.map(lambda x: x[idx], saved), acts[idx]

    state, _ = env.reset()
    if env.randomize:
        state = full_strength_dr(env, state)
    saved, acts = roll(state, jax.random.PRNGKey(seed))
    saved, acts = jax.tree.map(np.asarray, saved), np.asarray(acts)
    n = acts.shape[0]
    out = []
    for i in range(n):
        s = jax.tree.map(lambda x: x[i], saved)
        if i == n - 1:
            s = s._replace(progress=np.where(np.arange(B) % 2 == 0, env.max_episode_length - 2,
                                             s.progress).astype(np.int32))
            if env.randomize:
                s = s._replace(randomize_buf=np.full(B, env.randomizer.frequency - 1, np.int32))
        out.append((s, acts[i]))
    return out


def kernel_env(task: str, num_envs: int, terrain_seed, tmp: str):
    """The JAX env stepping through the JAX package's fused Pallas kernel
    (interpret mode on the CPU), which its XLA step stands in for on the CPU."""
    env = make_jax_env(task, num_envs, terrain_seed, tmp)
    env.sim._maybe_build_pallas(force=True)
    return env


def step_outputs(env, samples) -> dict:
    """Each sample stepped once: inputs and outputs stacked on a state axis."""
    jax = _jax()
    step = jax.jit(env.step_fn)
    rows = []
    for s, a in samples:
        s2, obs, rew, done, info = step(jax.tree.map(jax.numpy.asarray, s), jax.numpy.asarray(a))
        row = {**_state_arrays("in", s), "in.rng": np.asarray(s.rng), "action": a,
               **(dict(dr_draws(env, s), **dr_fresh(env, s, s2, done)) if env.randomize
                  else {}),
               **_state_arrays("out", s2), "out.obs": np.asarray(obs),
               "out.reward": np.asarray(rew), "out.done": np.asarray(done)}
        row.update({f"out.info.{k}": np.asarray(info[k])
                    for k in ("time_outs", "episode_done", "episode_length")})
        rows.append(row)
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _cast(arrays: dict) -> dict:
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v) for k, v in arrays.items()}


def write(path: str, meta: dict, arrays: dict):
    np.savez_compressed(path, meta_json=np.asarray(json.dumps(meta)), **_cast(arrays))


def export_task(name: str, out: str, fixture_dir: str = "", kernel: bool = False,
                log=print, dr: bool = False, width: int = 0) -> dict:
    """One task's file (and fixture); ``width`` overrides the gates' width."""
    task, default_width, terrain_seed = TASKS[name]
    width = width or default_width
    if dr and (kernel or name not in DR_TASKS):
        raise ValueError(f"--dr takes the tasks {DR_TASKS} and no --kernel-reference")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        env = make_jax_env(task, width, terrain_seed, tmp, dr=dr)
        if dr:
            name = f"{name}_dr"
        samples = rollout_samples(env, STEPS, STRIDE, SEED)
        if kernel:
            env = kernel_env(task, width, terrain_seed, tmp)
            name, fixture_dir = f"{name}_kernel", ""
        arrays = step_outputs(env, samples)
    meta = dict(name=name, task=task, num_envs=width, states=len(samples), steps=STEPS,
                stride=STRIDE, seed=SEED, terrain_seed=terrain_seed, num_obs=env.num_obs,
                num_actions=env.num_actions, ball_actor=env.ball_actor,
                episode_length=env.max_episode_length,
                reference="kernel" if kernel else "xla", dr=dr,
                dr_global_step=DR_GLOBAL_STEP if dr else None, seconds=time.time() - t0)
    os.makedirs(out, exist_ok=True)
    write(os.path.join(out, f"{name}.npz"), meta, arrays)
    if fixture_dir:
        os.makedirs(fixture_dir, exist_ok=True)
        idx = [i for i in FIXTURE_STATES if i < len(samples)]
        fx = {k: v[idx][:, :FIXTURE_ENVS] if v.ndim > 1 else v[idx] for k, v in arrays.items()}
        write(os.path.join(fixture_dir, f"{name}.npz"),
              dict(meta, num_envs=min(width, FIXTURE_ENVS), states=len(idx),
                   fixture_of_states=idx), fx)
    log(json.dumps({"task": name, "num_envs": width, "states": len(samples),
                    "resets": int(arrays["out.done"].sum()),
                    "seconds": round(time.time() - t0, 1)}), flush=True)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "parity"))
    ap.add_argument("--tasks", nargs="*", default=list(TASKS), choices=list(TASKS))
    ap.add_argument("--fixture-dir", default="")
    ap.add_argument("--kernel-reference", action="store_true",
                    help="step the kept states through the JAX package's fused kernel "
                         "instead, into <task>_kernel.npz")
    ap.add_argument("--dr", action="store_true",
                    help="step under domain randomization with every draw written, into "
                         f"<task>_dr.npz (tasks {', '.join(DR_TASKS)})")
    a = ap.parse_args(argv)
    tasks = a.tasks if not a.dr or a.tasks != list(TASKS) else list(DR_TASKS)
    for name in tasks:
        export_task(name, a.out, a.fixture_dir, a.kernel_reference, dr=a.dr)


if __name__ == "__main__":
    main()
