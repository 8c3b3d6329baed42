"""The baked-root guard (``Simulator.step``), the JAX package's
``test_runtime_root_write_guard_falls_back_to_xla``
(``tests/test_pallas_dynamics.py:199-240``) repeated on the port.

K2 and K3 fold the fixed bases, and K2, K3 and K4 the static actors, at the
scene's initial poses. A root written at run time through the tensor API
(``set_actor_root_state_tensor_indexed``) must send the whole batch to the
non-kernel step, which reads every pose from the state:

* with the roots untouched, the guarded step equals the kernel route
  bit for bit (on the CPU the kernels' plain versions);
* with the humanoid base moved 5 cm, or the table raised 4 cm, in every env
  (flagship, K2), the guarded step equals ``step_nonkernel`` bit for bit,
  differs from the unguarded kernel step, and matches the JAX package's
  guarded step (its XLA path) within ``tests/test_torch_nonkernel.py``'s
  flagship gates;
* the same on C10 (K4, which folds only the table) with the table lowered
  under a humanoid standing on it.

The port's K1 folds nothing (the base pose is a per-env input, unlike the
JAX package's K1), so the terrain flagship's route has no guard: with the
base moved its step stays on K1 and matches the JAX package's guarded step
(which falls back to its XLA path) within the same gates.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import SimState as JSimState
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_build_scene
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
import isaacgym_tpu_torch
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim import tensor_api as T
from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_nonkernel import GATE, _compare

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B = 32


def _moved(state, actor, axis, delta):
    root = state.root[:, [actor]].clone()
    root[:, 0, axis] += delta
    return T.set_actor_root_state_tensor_indexed(state, root, env_ids=torch.arange(B),
                                                 actor_ids=[actor])


def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def _differs(a, b):
    return any(not torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


@pytest.fixture(scope="module")
def flagship():
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu")
    cfg = jax_load_task_config(TASK)
    js = JSimulator(jax_compile_scene(jax_build_scene(cfg["env"], cfg["sim"])))
    return env, jax.jit(js._step_vmapped)


def test_untouched_roots_take_the_kernel_route_exactly(flagship):
    env, _ = flagship
    sim = env.sim
    assert sim.route == "k2" and set(sim._baked_actors.tolist()) == {0, 1}
    state, tgt, eff = scripted.k2_state(
        sim, scripted.k2_inputs(env, "paddle_ball", B, np.random.RandomState(0)))
    assert not sim.baked_roots_moved(state)
    assert _equal(sim.step(state, tgt, eff), sim.step_kernel(state, tgt, eff))


@pytest.mark.parametrize("actor,axis,delta,kind", ((0, 0, 0.05, "paddle_ball"),
                                                   (1, 2, 0.04, "ball_rest")),
                         ids=("humanoid_base", "table"))
def test_a_moved_root_takes_the_nonkernel_step(flagship, actor, axis, delta, kind):
    env, xla = flagship
    sim = env.sim
    state, tgt, eff = scripted.k2_state(
        sim, scripted.k2_inputs(env, kind, B, np.random.RandomState(1)))
    moved = _moved(state, actor, axis, delta)
    assert sim.baked_roots_moved(moved)
    guarded = sim.step(moved, tgt, eff)
    assert _equal(guarded, sim.step_nonkernel(moved, tgt, eff))
    assert _differs(guarded, sim.step_kernel(moved, tgt, eff))
    want = xla(JSimState(**{f: jnp.asarray(getattr(moved, f).numpy())
                            for f in JSimState._fields}),
               jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    for f in JSimState._fields:
        d = float(np.abs(getattr(guarded, f).numpy() - np.asarray(getattr(want, f))).max())
        assert d <= GATE[f], (f, d)


def test_c10_table_write_takes_the_nonkernel_step():
    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B, device="cpu",
                                  cfg=scripted.raised_table_cfg(load_task_config(C10)))
    sim = env.sim
    assert sim.route == "k4" and sim._baked_actors.tolist() == [1]
    state, tgt, eff = scripted.k4_state(
        sim, scripted.k4_inputs(env, "table", B, np.random.RandomState(2)))
    assert _equal(sim.step(state, tgt, eff), sim.step_kernel(state, tgt, eff))
    moved = _moved(state, 1, 2, -0.04)
    guarded = sim.step(moved, tgt, eff)
    assert _equal(guarded, sim.step_nonkernel(moved, tgt, eff))
    assert _differs(guarded, sim.step_kernel(moved, tgt, eff))


def test_terrain_flagship_base_write_stays_on_k1_and_matches_the_jax_step(tmp_path):
    pcfg = rough_terrain_cfg(load_task_config(TASK), seed=0, size_m=(2.0, 2.0))
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=pcfg)
    sim = env.sim
    assert sim.route == "k1" and sim._baked_actors.size == 0
    npy = tmp_path / "height_map.npy"
    np.save(npy, pcfg["env"]["plane"]["terrain"])
    jcfg = jax_load_task_config(TASK)
    jcfg["env"]["plane"] = dict(pcfg["env"]["plane"], terrain=str(npy))
    xla = jax.jit(JSimulator(jax_compile_scene(jax_build_scene(jcfg["env"], jcfg["sim"])))
                  ._step_vmapped)
    state, tgt, eff = scripted.terrain_ball_state(sim, B, np.random.RandomState(3))
    moved = _moved(state, 0, 0, 0.05)
    assert not sim.baked_roots_moved(moved)
    got = sim.step(moved, tgt, eff)
    assert _equal(got, sim.step_kernel(moved, tgt, eff))
    assert _differs(got, sim.step(state, tgt, eff))
    want = xla(JSimState(**{f: jnp.asarray(getattr(moved, f).numpy())
                            for f in JSimState._fields}),
               jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    _compare(got, want, GATE)
