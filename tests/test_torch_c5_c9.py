"""C5 (HumanoidPingpongG1), C9 (HumanoidPingpongAlignmentG1) and the
HumanoidPingpongTiltGaussFTG1 alias in the port, against the JAX package.

* Their resolved configs equal the YAML loader's.
* C5's and C9's env step against the JAX package's at 64 envs x 8 states
  (a JAX rollout under numpy-seeded uniform actions, the last state with
  half the envs at the episode boundary), the JAX side's launches injected
  where an env resets, flip-aware within C6's row of the parity gates
  (``tools/parity_tpu.py:60-62``; neither task has a row of its own, and
  both are C6's 7-DOF scene at another dt, launch or restitution): see
  ``tests/test_torch_c8.py``. On the CPU the JAX side runs its XLA path and
  the port its plain K2, which follows the JAX package's fused kernel. At
  C5's substep (0.0083 s, twice the flagship's) that kernel and the XLA
  step part on some paddle strikes (5 of C5's 512 env-steps here, 1 %):
  so C5 is held to the JAX env step through the kernel (interpret mode,
  128 envs), and every env where it parts from the XLA step is shown to be
  one where the JAX kernel parts from it too.
* The alias is the flagship's class with its own config: its step equals
  the flagship's.
* C5's planar launch: vz = 0 and (vx, vy) = s (cos a, sin a), s = -U(6.5,
  7.5), a = U(-5, 5) degrees, as ``isaacgym_tpu/tasks/base.py:65-76``
  draws it; C5 resets early on a miss; C9's one-shot ``reward_calculated``
  latches on the overshoot penalty and pays it once.
* Each task's launcher trains 2 epochs on the CPU with tiny nets.
Each env-step check traces one XLA env step (about a minute), C5's kernel
check one interpret-mode env step (about a minute more).
"""

import json
import math

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.utils.config import compose as jax_compose
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.interop import env_state_from_numpy
from isaacgym_tpu_torch.tasks import pingpong_common as PC
from isaacgym_tpu_torch.utils.config import load_task_config, load_train_config
from tests.test_torch_c8 import (B, C5, C9, _jax_env_state_numpy, check_step_parity,
                                 make_pair)

ALIAS, FLAGSHIP = "HumanoidPingpongTiltGaussFTG1", "HumanoidPingpongTiltNoEarlyStopG1"


@pytest.mark.parametrize("task", (C5, C9, ALIAS))
def test_resolved_configs_equal_the_yaml_loader(task):
    assert load_task_config(task) == jax_load_task_config(task)
    assert load_train_config(task) == jax_compose(task)["train"]


@pytest.fixture(scope="module")
def c5_pair():
    return make_pair(C5)


@pytest.fixture(scope="module")
def c9_pair():
    return make_pair(C9)


@pytest.fixture(scope="module")
def c5_kernel_pair(c5_pair):
    """C5's samples with the JAX step's outputs through the JAX package's own
    fused kernel (Pallas K2 in interpret mode, ``_maybe_build_pallas(force=
    True)``), the envs tiled twice to the kernel's 128-env lane width."""
    task, je, pe, samples = c5_pair
    jk = isaacgym_tpu.make(seed=0, task=C5, num_envs=2 * B)
    jk.sim._maybe_build_pallas(force=True)
    step = jax.jit(jk.step_fn)
    out = []
    for s_np, a, _ in samples:
        s2 = jax.tree.map(lambda x: jnp.asarray(np.concatenate([x, x])), s_np)
        o = step(s2, jnp.asarray(np.concatenate([a, a])))
        out.append((s_np, a, jax.tree.map(lambda x: np.asarray(x)[:B], o)))
    return task, je, pe, out


def _flipped(out, want, ba):
    """Per env: done differs, or a root lands more than 0.1 apart."""
    (s, _, _, d, _), (sw, _, _, dw, _) = out, want
    root_d = np.abs(np.asarray(s.sim.root) - np.asarray(sw.sim.root)).reshape(B, -1).max(1)
    return (np.asarray(d).astype(bool) != np.asarray(dw).astype(bool)) | (root_d > 0.1)


def test_c5_env_step_matches_the_jax_kernel_within_the_parity_gates(c5_kernel_pair,
                                                                    monkeypatch):
    """The port's K2 follows the JAX package's fused kernel: against that
    kernel's env step C5 holds C6's gates."""
    check_step_parity(c5_kernel_pair, monkeypatch, 80)


def test_c5_departs_from_the_xla_step_only_where_the_jax_kernel_does(
        c5_pair, c5_kernel_pair, monkeypatch):
    """Against the JAX package's XLA step C5 flips more envs than C6's 0.5 %
    (5 of 512 here, paddle strikes whose outgoing velocity differs by up to
    10 m/s): the JAX package's own kernel departs from its XLA step in the
    same envs, and the port matches the kernel there. So every env where
    the port and the XLA step part is one where the kernel and the XLA step
    part, and elsewhere C6's gates hold."""
    task, je, pe, samples = c5_pair
    ba = pe.ball_actor
    n_port = n_both = 0
    for (s_np, a, xla), (_, _, kern) in zip(samples, c5_kernel_pair[3]):
        sp = env_state_from_numpy(_jax_env_state_numpy(s_np))
        launch = torch.tensor(np.asarray(xla[0].sim.root[:, ba, 7:10]))
        monkeypatch.setattr(pe, "sample_ball_velocity", lambda n: launch[:n].clone())
        port = pe.step(sp, torch.as_tensor(a))
        port = jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, port)
        port_vs_xla = _flipped(port, xla, ba)
        kern_vs_xla = _flipped(kern, xla, ba)
        n_port += int(port_vs_xla.sum())
        n_both += int((port_vs_xla & kern_vs_xla).sum())
    assert n_port > 0 and n_both == n_port, (n_port, n_both)


def test_c9_env_step_matches_within_the_parity_gates(c9_pair, monkeypatch):
    check_step_parity(c9_pair, monkeypatch, 80)


def test_c5_and_c9_take_k2_with_their_own_constants():
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.sim.simulator import route_for
    for task, dt in ((C5, 0.0166), (C9, 0.0083)):
        env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=2, device="cpu")
        assert env.sim.route == "k2" and route_for(env.scene, "cuda") == "k2"
        assert float(env.sim.fused_substep.consts[F.C_DT]) == pytest.approx(dt / 2)
    assert jax_load_task_config(C9)["env"]["scene"]["tableRestitution"] == 1.5


def test_alias_steps_as_the_flagship():
    envs = [isaacgym_tpu_torch.make(seed=3, task=t, num_envs=8, device="cpu")
            for t in (ALIAS, FLAGSHIP)]
    assert type(envs[0]) is type(envs[1])
    outs = []
    for env in envs:
        state, obs = env.reset()
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            state, obs, rew, done, _ = env.step(state, torch.rand((8, 7), generator=gen) * 2 - 1)
        outs.append((state.sim.root, obs, rew))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_c5_planar_launch():
    env = isaacgym_tpu_torch.make(seed=4, task=C5, num_envs=256, device="cpu")
    state, _ = env.reset()
    v = state.sim.root[:, env.ball_actor, 7:10].double()
    assert (v[:, 2] == 0).all()
    speed = torch.linalg.norm(v[:, :2], dim=-1)
    assert speed.min() >= 6.5 - 1e-5 and speed.max() <= 7.5 + 1e-5
    # v = s (cos a, sin a) with s < 0: the angle of -v is a, in [-5, 5] degrees
    a = torch.rad2deg(torch.atan2(-v[:, 1], -v[:, 0]))
    assert a.abs().max() <= 5.0 + 1e-4 and a.abs().max() > 4.0
    # the sampler's own formula on the same uniform draws
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = PC.sample_ball_velocity_planar(64, (6.5, 7.5), (-5.0, 5.0), g1, "cpu")
    u = torch.rand((2, 64), generator=g2)
    s = -(6.5 + 1.0 * u[0])
    ang = torch.deg2rad(-5.0 + 10.0 * u[1])
    want = torch.stack([s * torch.cos(ang), s * torch.sin(ang), torch.zeros(64)], dim=-1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _stepped(task, b, edit):
    env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=b, device="cpu")
    state, _ = env.reset()
    state = state._replace(sim=edit(env, state.sim))
    return env, state


def test_c5_resets_early_on_a_miss():
    def behind_the_paddle(env, sim):
        root = sim.root.clone()
        root[0, env.ball_actor, 0:3] = torch.tensor([-0.5, -0.3, 1.3])
        return sim._replace(root=root)
    env, state = _stepped(C5, 2, behind_the_paddle)
    state2, _, rew, done, info = env.step(state, torch.zeros(2, 7))
    assert done.tolist() == [True, False]
    assert state2.progress.tolist() == [0, 1]
    assert float(rew[0]) < env.penalty / 2 < float(rew[1])
    # the reset restored the DOFs and launched a new ball from the start
    assert torch.equal(state2.sim.dof_pos[0], torch.zeros(7))
    assert float(state2.sim.root[0, env.ball_actor, 0]) == pytest.approx(3.1)


def test_c9_one_shot_flag_latches():
    def past_the_table(env, sim):
        root = sim.root.clone()
        root[:, env.ball_actor, 0:3] = torch.tensor([3.3, 0.0, 1.4])
        root[:, env.ball_actor, 7:10] = torch.tensor([3.0, 0.0, 0.0])
        return sim._replace(root=root)
    env, state = _stepped(C9, 2, past_the_table)
    state = state._replace(flags={"reward_calculated": torch.tensor([False, True])})
    state, _, rew1, done, _ = env.step(state, torch.zeros(2, 7))
    assert not done.any() and state.flags["reward_calculated"].all()
    # the penalty once, in the env whose flag was down
    assert float(rew1[0] - rew1[1]) == pytest.approx(env.not_hit_table_penalty, rel=1e-3)
    state, _, rew2, _, _ = env.step(state, torch.zeros(2, 7))
    assert state.flags["reward_calculated"].all()
    assert abs(float(rew2[0] - rew2[1])) < 1.0


@pytest.mark.parametrize("task", (C5, C9, ALIAS))
def test_launcher_trains_on_the_cpu(task, tmp_path):
    from isaacgym_tpu_torch.train import main
    ts = main([f"task={task}", "num_envs=8", "max_iterations=2", "device=cpu",
               "experiment=tiny", "train.params.network.mlp.units=[32,32]",
               "train.params.config.horizon_length=4",
               "train.params.config.minibatch_size=16"], run_root=str(tmp_path))
    assert ts.epoch == 2
    assert (tmp_path / "tiny" / "ckpt_final.pt").exists()
    last = json.loads((tmp_path / "tiny" / "metrics.jsonl").read_text().splitlines()[-1])
    assert all(math.isfinite(v) for v in last.values() if isinstance(v, float))
