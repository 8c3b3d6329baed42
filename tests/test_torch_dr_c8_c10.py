"""Domain randomization on C8 (two humanoids, the K3 route) and C10 (the
floating-base humanoid, the K4 route): ``Simulator.step`` with ``dr`` takes
the non-kernel step there, as the JAX package's ``step_dr`` takes
``_step_dr_vmapped`` for every scene but the flagship's (only ``_fused_dr``
serves a kernel, ``isaacgym_tpu/sim/simulator.py:594-624``).

The port's step under DR is held against the JAX package's ``step_dr`` on
the CPU (its XLA path) from the same states and a numpy-seeded DR channel
with every term off the identity (kp and kd scales, limit shifts, mass,
gravity, friction and restitution): C8 at 64 envs on paddle strikes by
either humanoid and the ball resting on the table, C10 at 8 envs standing,
striking and falling. Gates and the flip limit are
``tests/test_torch_nonkernel.py``'s (``GATE``, ``GATE_C10``,
``MAX_FLIPS``). Then ``make`` with ``task.randomize=true`` builds and steps
C8 and C10 on the CPU with finite outputs, and K3 and K4 (their plain
versions on the CPU) are never called.
"""

import copy

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.env.randomize import DRParams as JDRParams
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import SimState as JSimState
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_build_scene
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
import isaacgym_tpu_torch
from isaacgym_tpu_torch.env.randomize import DRParams
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_nonkernel import GATE, GATE_C10, _compare, _jax_sim

C8 = "Humanoid12PingpongTiltG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B8, B10 = 64, 8


def _dr(nd, b, seed):
    """A DR channel with every term off the identity, numpy-seeded."""
    rng = np.random.RandomState(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (b,) + s).astype(np.float32)
    return dict(gravity_offset=np.stack([u(-0.3, 0.3), u(-0.3, 0.3), u(-0.5, 0.5)], 1),
                mass_scale=u(0.7, 1.3), friction_scale=u(0.5, 1.5),
                restitution_scale=u(0.7, 1.3), kp_scale=u(0.6, 1.4, nd),
                kd_scale=u(0.6, 1.4, nd), lower_shift=u(-0.1, 0.1, nd),
                upper_shift=u(-0.1, 0.1, nd))


def _randomized(task):
    cfg = copy.deepcopy(load_task_config(task))
    cfg["task"]["randomize"] = True
    return cfg


@pytest.fixture(scope="module")
def c8():
    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B8, device="cpu")
    cfg = jax_load_task_config(C8)
    js = JSimulator(jax_compile_scene(jax_build_scene(cfg["env"], cfg["sim"], humanoids=2)))
    return env, jax.jit(js.step_dr)


@pytest.fixture(scope="module")
def c10():
    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10, device="cpu")
    js = _jax_sim(jax_load_task_config(C10), floating=True)
    return env, jax.jit(js.step_dr)


def _check(env, step_dr, state, tgt, eff, seed, gate):
    """``Simulator.step`` with a DR channel against the JAX ``step_dr``; the
    route's kernel (its plain version here) must not run."""
    d = _dr(env.scene.num_dofs, tgt.shape[0], seed)
    js = JSimState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in JSimState._fields})
    want = step_dr(js, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()),
                   JDRParams(**{k: jnp.asarray(v) for k, v in d.items()}))
    sim = env.sim
    name = "fused_substep_multi" if sim.route == "k3" else "fused_substep_floating"
    kernel = getattr(sim, name)
    try:
        setattr(sim, name, None)   # a kernel call would raise
        got = sim.step(state, tgt, eff, DRParams(**{k: torch.as_tensor(v) for k, v in d.items()}))
    finally:
        setattr(sim, name, kernel)
    _compare(got, want, gate)
    return got


C8_SETS = ("paddle_ball1", "paddle_ball2", "ball_rest")


@pytest.mark.parametrize("kind", C8_SETS)
def test_c8_step_under_dr_matches_the_jax_step_dr(c8, kind):
    env, step_dr = c8
    assert env.sim.route == "k3"
    i = C8_SETS.index(kind)
    state, tgt = scripted.strike_state(env.sim, kind, B8, np.random.RandomState(20 + i))
    got = _check(env, step_dr, state, tgt, torch.zeros_like(tgt), 50 + i, GATE)
    if kind != "ball_rest":   # the set really strikes
        assert float((got.net_contact_force.abs().sum((1, 2)) > 0).float().mean()) > 0.5


@pytest.mark.parametrize("kind", ("stand", "strike", "fall"))
def test_c10_step_under_dr_matches_the_jax_step_dr(c10, kind):
    env, step_dr = c10
    assert env.sim.route == "k4"
    ins = scripted.k4_inputs(env, kind, B10, np.random.RandomState(31))
    state, tgt, eff = scripted.k4_state(env.sim, ins)
    _check(env, step_dr, state, tgt, eff, 60, GATE_C10)


def test_dr_changes_the_step(c10):
    """The channel acts: the same C10 state stepped with and without it
    lands apart."""
    env, _ = c10
    ins = scripted.k4_inputs(env, "fall", B10, np.random.RandomState(32))
    state, tgt, eff = scripted.k4_state(env.sim, ins)
    d = DRParams(**{k: torch.as_tensor(v) for k, v in _dr(27, B10, 61).items()})
    a = env.sim.step(state, tgt, eff, d)
    b = env.sim.step(state, tgt, eff)
    assert float((a.root - b.root).abs().max()) > 1e-3


@pytest.mark.parametrize("task,b,act", ((C8, 16, 14), (C10, 8, 27)))
def test_make_with_randomize_steps_without_the_kernel(task, b, act):
    env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=b, device="cpu",
                                  cfg=_randomized(task))
    assert env.randomize and env.sim.route in ("k3", "k4")
    name = "fused_substep_multi" if env.sim.route == "k3" else "fused_substep_floating"
    setattr(env.sim, name, None)   # a kernel call would raise
    state, obs = env.reset()
    assert state.dr is not None
    # past the 3000-step ramp: every scheduled DR term at full strength
    state = state._replace(global_step=torch.full_like(state.global_step, 3000),
                           dr=env.randomizer.sample(env.generator, 3000, b))
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        state, obs, rew, done, _ = env.step(state, torch.rand((b, act), generator=gen) * 2 - 1)
    assert all(bool(torch.isfinite(t).all()) for t in state.sim)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
    assert float(state.dr.mass_scale.std()) > 0.0
