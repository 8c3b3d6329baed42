"""The port's non-kernel step (``Simulator.step_nonkernel``: ``ops/dynamics``,
``ops/contacts``, ``ops/linalg`` and the batched contact phase) against the
JAX package's ``_step_vmapped`` and ``_step_dr_vmapped`` (its XLA path) on
the CPU, from the same states.

Flagship states (64 envs each, ``sim/scripted.py``): the paddle in front of
an incoming ball (ball vs articulated geoms, joint-space impulses), the ball
resting on the table (statics), reset launches, and the paddle pressed into
the raised table (art-vs-static with exact support and the resting band);
with and without a numpy-seeded DR channel (the kp and kd scales, limit
shifts, mass, gravity, friction and restitution all off the identity). C10
states (8 envs): standing on the feet's resting contacts, a strike and a
fall (the floating base, its quaternion integration and velocity clamps,
the ground contacts). The flagship on the seeded rough heightfield (64
envs): the ball falling onto the terrain over the whole 8 m x 6 m field and
20 cm past its edges (the bilinear height, the one-cell normal, the clamp
to the field), through the non-kernel step and through the K1 route (K1's
plain version, then the same contact phase).

Both sides run the same formulas in float32; they differ only in the order
of summation inside einsums and solves. Measured largest deviations over
the flagship's sets, with DR and without: root 1.05e-3 (a paddle strike's
ball under DR), dof_pos 4.2e-7, dof_vel 1.7e-4, dof_force 2.7e-5, contact
force 1.3e-3 N, contact moment 9.2e-5 N m; over C10's: root 1.7e-4, dof_pos
5.4e-7, dof_vel 1.0e-4, dof_force 2.3e-4, contact force 5.6e-3 N, contact
moment 2.3e-4 N m; on terrain (both routes): root 7.2e-4, dof_vel 3.1e-5,
contact force 1.5e-5 N. Gates sit 10-40 times above the readings. An env whose
root lands more than 0.1 apart (a contact acting on one side only) is a
flip: counted, at most one per set, its fields left out (0 measured).
"""

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
from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B = 64
B10 = 8
GATE = dict(root=1e-2, dof_pos=1e-5, dof_vel=2e-3, dof_force=1e-3,
            net_contact_force=0.05, net_contact_torque=2e-3)
GATE_C10 = dict(root=5e-3, dof_pos=1e-5, dof_vel=3e-3, dof_force=5e-3,
                net_contact_force=0.1, net_contact_torque=5e-3)
MAX_FLIPS = 1


def _jax_sim(cfg, floating=False):
    spec = jax_build_scene(cfg["env"], cfg["sim"], floating_base=floating) if floating \
        else jax_build_scene(cfg["env"], cfg["sim"])
    return JSimulator(jax_compile_scene(spec))


@pytest.fixture(scope="module")
def flagship():
    out = {}
    for raised in (False, True):
        pcfg, jcfg = load_task_config(TASK), jax_load_task_config(TASK)
        if raised:
            pcfg, jcfg = scripted.raised_table_cfg(pcfg), scripted.raised_table_cfg(jcfg)
        env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=pcfg)
        js = _jax_sim(jcfg)
        out[raised] = (env, jax.jit(js._step_vmapped), jax.jit(js._step_dr_vmapped))
    return out


def _dr(nd, seed):
    rng = np.random.RandomState(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (B,) + s).astype(np.float32)
    return dict(gravity_offset=np.stack([u(-0.3, 0.3), u(-0.3, 0.3), u(-0.5, 0.5)], 1),
                mass_scale=u(0.7, 1.3), friction_scale=u(0.5, 1.5),
                restitution_scale=u(0.7, 1.3), kp_scale=u(0.6, 1.4, nd),
                kd_scale=u(0.6, 1.4, nd), lower_shift=u(-0.1, 0.1, nd),
                upper_shift=u(-0.1, 0.1, nd))


def _compare(port, jax_out, gate):
    """Largest deviation per field over the envs that are not flips;
    asserts the gates and the flip limit."""
    j = {f: np.asarray(getattr(jax_out, f)) for f in JSimState._fields}
    p = {f: getattr(port, f).numpy() for f in JSimState._fields}
    n = p["root"].shape[0]
    clean = np.abs(p["root"] - j["root"]).reshape(n, -1).max(1) <= 0.1
    assert int((~clean).sum()) <= MAX_FLIPS
    dev = {f: float(np.abs(p[f] - j[f])[clean].max()) for f in j}
    for f, d in dev.items():
        assert np.isfinite(p[f]).all(), f
        assert d <= gate[f], (f, d, gate[f])
    return dev


SETS = (("paddle_ball", False), ("ball_rest", False), ("reset", False), ("paddle_table", True))


@pytest.mark.parametrize("with_dr", (False, True), ids=("plain", "dr"))
@pytest.mark.parametrize("kind,raised", SETS, ids=[k for k, _ in SETS])
def test_flagship_nonkernel_step_matches_the_jax_xla_step(flagship, kind, raised, with_dr):
    env, xla, xla_dr = flagship[raised]
    i = [k for k, _ in SETS].index(kind)
    ins = scripted.k2_inputs(env, kind, B, np.random.RandomState(100 + i))
    state, tgt, eff = scripted.k2_state(env.sim, ins)
    js = JSimState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in JSimState._fields})
    if with_dr:
        d = _dr(env.scene.num_dofs, 7 + i)
        want = xla_dr(js, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()),
                      JDRParams(**{k: jnp.asarray(v) for k, v in d.items()}))
        got = env.sim.step_nonkernel(state, tgt, eff,
                                     DRParams(**{k: torch.as_tensor(v) for k, v in d.items()}))
    else:
        want = xla(js, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
        got = env.sim.step_nonkernel(state, tgt, eff)
    _compare(got, want, GATE)
    if kind in ("paddle_ball", "paddle_table"):   # the set really makes contacts
        assert float((got.net_contact_force.abs().sum((1, 2)) > 0).float().mean()) > 0.5


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    pcfg = rough_terrain_cfg(load_task_config(TASK), seed=0)
    npy = tmp_path_factory.mktemp("terrain") / "height_map.npy"
    np.save(npy, pcfg["env"]["plane"]["terrain"])
    jcfg = jax_load_task_config(TASK)
    jcfg["env"]["plane"] = dict(pcfg["env"]["plane"], terrain=str(npy))
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=pcfg)
    return env, jax.jit(_jax_sim(jcfg)._step_vmapped)


@pytest.mark.parametrize("route", ("nonkernel", "k1"))
def test_terrain_step_matches_the_jax_xla_step(terrain, route):
    env, xla = terrain
    assert env.sim.route == "k1"
    state, tgt, eff = scripted.terrain_ball_state(env.sim, B, np.random.RandomState(40))
    js = JSimState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in JSimState._fields})
    want = xla(js, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    step = env.sim.step_nonkernel if route == "nonkernel" else env.sim.step_kernel
    got = step(state, tgt, eff)
    _compare(got, want, GATE)
    ball = env.scene.free_bodies[0].body_start
    assert float((got.net_contact_force[:, ball].abs().sum(-1) > 0).float().mean()) > 0.5


@pytest.fixture(scope="module")
def c10():
    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10, device="cpu")
    js = _jax_sim(jax_load_task_config(C10), floating=True)
    return env, jax.jit(js._step_vmapped)


@pytest.mark.parametrize("kind", ("stand", "strike", "fall"))
def test_c10_nonkernel_step_matches_the_jax_xla_step(c10, kind):
    env, xla = c10
    ins = scripted.k4_inputs(env, kind, B10, np.random.RandomState(30))
    state, tgt, eff = scripted.k4_state(env.sim, ins)
    js = JSimState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in JSimState._fields})
    want = xla(js, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    got = env.sim.step_nonkernel(state, tgt, eff)
    _compare(got, want, GATE_C10)


def test_routes():
    """The scenes' routes: the flagship K2, C8 K3, C10 K4, the flagship on
    terrain or without its ball K1, a ball alone the non-kernel path, and a
    scene with link-vs-link contacts the non-kernel path on both devices."""
    from isaacgym_tpu_torch.sim.scene import ActorSpec, SceneSpec, compile_scene
    from isaacgym_tpu_torch.sim.simulator import Simulator, route_for
    from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene, load_tree
    cfg = load_task_config(TASK)
    route = lambda spec: Simulator(compile_scene(spec), device="cpu").route
    assert route(build_pingpong_scene(cfg["env"], cfg["sim"])) == "k2"
    terr = rough_terrain_cfg(cfg, seed=0, size_m=(1.0, 1.0))
    assert route(build_pingpong_scene(terr["env"], terr["sim"])) == "k1"
    spec = build_pingpong_scene(cfg["env"], cfg["sim"])
    spec.actors = spec.actors[:2]            # no ball
    assert route(spec) == "k1"
    ball = SceneSpec(actors=[ActorSpec("ball", load_tree("small_ball.urdf"), fixed_base=False)])
    assert route(ball) == "nonkernel"
    c8 = load_task_config("Humanoid12PingpongTiltG1")
    assert route(build_pingpong_scene(c8["env"], c8["sim"], humanoids=2)) == "k3"
    c10 = load_task_config(C10)
    assert route(build_pingpong_scene(c10["env"], c10["sim"], floating_base=True)) == "k4"
    spec = build_pingpong_scene(cfg["env"], cfg["sim"])
    spec.link_collision = True
    assert route(spec) == "nonkernel"
    assert route_for(compile_scene(spec), "cuda") == "nonkernel"
