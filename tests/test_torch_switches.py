"""The physics switches (``sim/switches.py``, module 16): the JAX package's
seven ``ISAACGYM_TPU_*`` variables as the port's explicit options.

* ``PhysicsSwitches.from_env`` reads each variable as the JAX package does,
  by the JAX package's own readers under the same ``monkeypatch.setenv``.
* One case per switch against the JAX package run under its variable, from
  the same numpy-seeded states and targets, one step:
  - ``kappa`` (``BALL_KAPPA=0``), ``ccd`` (``CCD=0``) and ``pallas``
    (``PALLAS=0``) on the flagship's paddle strikes (32 envs), the port on
    its non-kernel step against the JAX XLA step (the JAX package's path on
    the CPU), at ``tests/test_torch_nonkernel.py``'s gates;
  - ``art_static`` (``ART_STATIC=0``) on the pendulum over a block of
    ``tests/test_art_static.py`` (16 envs near the block's top), K1's route
    against the XLA step, at the same gates;
  - ``torque`` (``TORQUE=1``) and ``reach_prune`` (``REACH_PRUNE=0``) on the
    flagship with its table raised (paddle strikes and the paddle pressed
    into the table, 128 envs): the port's plain K2 built with both against
    the JAX package's Pallas K2 built under both variables (interpret mode,
    the file's one trace), at ``tests/test_torch_force_torque.py``'s gates
    (moment rows 1e-5 and 1e-7), no flip;
  - ``native`` (``NATIVE=0``): ``load_asset(native=False)`` never calls the
    native parser and gives the JAX ``load_asset``'s tree under the
    variable, equal to the native tree.
* Each switch changes what it should: ``kappa=0`` the ball's spin after a
  paddle strike; ``art_static=False`` lets the pendulum's tip settle inside
  the block (``tests/test_art_static.py:95``); ``ccd=False`` changes the
  paddle strikes that only the sweep catches and shifts the C7 bounces
  within ``tests/test_ccd.py:85``'s bound (16 envs, 60 zero-action steps, the
  first differing after step 40) on the non-kernel step, and leaves the kernel route's step bit for bit
  (the kernels sweep whatever it says, as the JAX kernels do);
  ``pallas=False`` sends every task to "nonkernel" on the card and builds no
  kernel; ``torque=True`` builds the ``-tau`` kernels and writes non-zero
  moments on a scene with no sensor; ``reach_prune=False`` packs more pairs,
  steps the same bits and keeps every K2 and K3 task on its kernel (the
  unpruned counts, 4 to 20, are under ``MAX_PAIRS = 32``).
* The g++ host bodies of K2, K3 (C8) and K4 (C10) on packs built under
  ``art_static=False``, a forced ``kappa`` and unpruned pairs, against the
  plain versions at the warp tests' gates, no flip.
"""

import os
import types

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
from isaacgym_tpu import native as jax_native
from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.sim import simulator as JS
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_build_scene
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
import isaacgym_tpu_torch
from isaacgym_tpu_torch import native
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.ops import fused_substep_multi as M
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import (DRIVE_POS, ActorSpec, PlaneParams, SceneSpec,
                                          compile_scene)
from isaacgym_tpu_torch.sim.simulator import (Simulator, fused_geom_lists, route_for,
                                              topology_route)
from isaacgym_tpu_torch.sim.switches import VARIABLES, PhysicsSwitches
from isaacgym_tpu_torch.tasks import task_registry
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_art_static import BLOCK, PENDULUM, _pendulum_over_block
from tests.test_torch_assets import assert_trees_equal
from tests.test_torch_force_torque import _assert_close as assert_tau_close
from tests.test_torch_fused_substep import TOL, compare
from tests.test_torch_fused_substep_floating import TOL as TOL_K4, compare as compare_k4
from tests.test_torch_fused_substep_multi import TOL as TOL_K3, compare as compare_k3
from tests.test_torch_fused_warp import plain_k2, run_k2
from tests.test_torch_nonkernel import GATE, _compare
from tests.test_torch_multi_warp import plain as plain_k3, run_host as run_k3
from tests.test_torch_floating_warp import run_host as run_k4

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C8, C10 = "Humanoid12PingpongTiltG1", "HumanoidPingpongTiltNESSparse27DOFG1"
B = 32
SWITCHES = ("kappa", "art_static", "ccd", "pallas", "torque", "reach_prune", "native")
FAR = dict(kind=U.GEOM_BOX, pos=np.asarray([50.0, 0.0, 0.0], np.float32),
           quat=np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
           size=np.asarray([0.1, 0.1, 0.1], np.float32), e=0.5, mu=0.5)


def _flagship_states(env, kind="paddle_ball", n=B, seed=3):
    ins = scripted.k2_inputs(env, kind, n, np.random.RandomState(seed))
    return ins, scripted.k2_state(env.sim, ins)


def _jax_state(state):
    return JS.SimState(**{f: jnp.asarray(getattr(state, f).numpy())
                          for f in JS.SimState._fields})


def _jax_xla_step(sim, state, tgt, eff):
    """The JAX package's XLA step, traced now (under the variables set)."""
    return jax.jit(sim._step_vmapped)(_jax_state(state), jnp.asarray(tgt.numpy()),
                                      jnp.asarray(eff.numpy()))


def _port_sim(switches, cfg=None):
    cfg = cfg or load_task_config(TASK)
    return isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=cfg,
                                   switches=switches).sim


# -- the variables' parse --------------------------------------------------

PARSE = [("kappa", "0"), ("kappa", "2.5"), ("art_static", "0"), ("art_static", "false"),
         ("ccd", "0"), ("ccd", "no"), ("pallas", "0"), ("pallas", "2"), ("torque", "1"),
         ("torque", "true"), ("reach_prune", "0"), ("reach_prune", "off"), ("native", "0")]


@pytest.mark.parametrize("field,value", PARSE)
def test_from_env_reads_the_variable_as_the_jax_package(monkeypatch, field, value):
    for var in VARIABLES.values():
        monkeypatch.delenv(var, raising=False)
    assert PhysicsSwitches.from_env() == PhysicsSwitches()
    monkeypatch.setenv(VARIABLES[field], value)
    sw = PhysicsSwitches.from_env()
    ball = types.SimpleNamespace(mass=0.0027, radius=0.02, inertia=7.2e-7)
    assert sw.ball_kappa(ball) == JS._ball_kappa(ball)
    assert sw.art_static == JS._art_static_enabled()
    assert sw.ccd_dt(0.0042) == JS._ccd_dt(0.0042)
    base_geom = dict(kind=U.GEOM_SPHERE, link=-1, off_pos=np.zeros(3), radius_bound=0.02)
    assert sw.reach_prune == PDK._static_pair_unreachable(
        types.SimpleNamespace(tree=None), np.zeros(3), base_geom, FAR)
    assert sw.pallas == (value != "0" if field == "pallas" else True)
    assert sw.torque == (value == "1" if field == "torque" else False)
    if field == "native":
        assert not sw.native and not jax_native.available()
    changed = {f for f in SWITCHES if getattr(sw, f) != getattr(PhysicsSwitches(), f)}
    assert changed <= {field}


# -- one case per switch against the JAX package under its variable --------

@pytest.fixture(scope="module")
def flagship():
    """The port env (default switches) whose states every flagship case
    steps, and a maker of the JAX simulator of the same scene: a fresh one
    for each case, so that no case reuses a step another traced under its
    own variable."""
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu",
                                  switches=PhysicsSwitches())
    jcfg = jax_load_task_config(TASK)
    return env, lambda: JS.Simulator(jax_compile_scene(jax_build_scene(jcfg["env"],
                                                                       jcfg["sim"])))


def _pendulum_scene():
    pend = K.compile_tree(U.parse_urdf(PENDULUM, from_string=True))
    block = K.compile_tree(U.parse_urdf(BLOCK, from_string=True))
    return compile_scene(SceneSpec(
        actors=[ActorSpec("pend", pend, pos=(0.0, 0.0, 1.2), fixed_base=True,
                          restitution=0.0, friction=0.5, drive_mode=DRIVE_POS,
                          stiffness=np.zeros(1), damping=np.full(1, 0.8)),
                ActorSpec("block", block, pos=(0.0, 0.0, 0.15), fixed_base=True,
                          restitution=0.0, friction=0.5)],
        plane=PlaneParams(), dt=1 / 120, substeps=2))


def _pendulum_states(sim, n=16):
    rng = np.random.RandomState(5)
    state = sim.initial_state(n)
    q = torch.as_tensor(rng.uniform(0.40, 0.62, (n, 1)).astype(np.float32))
    qd = torch.as_tensor(rng.uniform(-3.0, -0.5, (n, 1)).astype(np.float32))
    return state._replace(dof_pos=q, dof_vel=qd), torch.zeros(n, 1), torch.zeros(n, 1)


@pytest.fixture(scope="module")
def pallas_tau_unpruned():
    """The JAX package's Pallas K2 on the raised-table flagship, built under
    ``ISAACGYM_TPU_TORQUE=1`` and ``ISAACGYM_TPU_REACH_PRUNE=0``, its outputs
    on 128 rows (paddle strikes, the paddle in the table); the port's env
    under ``torque=True, reach_prune=False``; the JAX build's pair count."""
    cfg = scripted.raised_table_cfg(load_task_config(TASK))
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=128, device="cpu", cfg=cfg,
                                 switches=PhysicsSwitches(torque=True, reach_prune=False))
    sets = [scripted.k2_inputs(pe, kind, 64, np.random.RandomState(9 + i))
            for i, kind in enumerate(("paddle_ball", "paddle_table"))]
    ins = [np.concatenate(x) for x in zip(*sets)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYM_TPU_TORQUE", "1")
        mp.setenv("ISAACGYM_TPU_REACH_PRUNE", "0")
        je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=128,
                               cfg=scripted.raised_table_cfg(jax_load_task_config(TASK)))
        je.sim._maybe_build_pallas(force=True)
        out = je.sim._fused(*[jnp.asarray(x) for x in ins])
    return pe, ins, {f: np.asarray(getattr(out, f)) for f in out._fields}


def _np_out(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def _case_kappa(flagship, monkeypatch, request):
    env, js = flagship
    _, (state, tgt, eff) = _flagship_states(env)
    monkeypatch.setenv("ISAACGYM_TPU_BALL_KAPPA", "0")
    want = _jax_xla_step(js(), state, tgt, eff)
    port = _port_sim(PhysicsSwitches(kappa=0.0, pallas=False))
    got = port.step(state, tgt, eff)
    _compare(got, want, GATE)
    # the spin after the strikes is what kappa changes
    ba = env.ball_actor
    spun = _port_sim(PhysicsSwitches(pallas=False)).step(state, tgt, eff)
    assert float((spun.root[:, ba, 10:13] - got.root[:, ba, 10:13]).abs().max()) > 1.0


def _case_ccd(flagship, monkeypatch, request):
    env, js = flagship
    _, (state, tgt, eff) = _flagship_states(env)
    monkeypatch.setenv("ISAACGYM_TPU_CCD", "0")
    want = _jax_xla_step(js(), state, tgt, eff)
    got = _port_sim(PhysicsSwitches(ccd=False, pallas=False)).step(state, tgt, eff)
    _compare(got, want, GATE)
    swept = _port_sim(PhysicsSwitches(pallas=False)).step(state, tgt, eff)
    assert float((swept.root - got.root).abs().max()) > 1.0   # strikes the sweep catches


def _case_pallas(flagship, monkeypatch, request):
    env, js = flagship
    _, (state, tgt, eff) = _flagship_states(env)
    monkeypatch.setenv("ISAACGYM_TPU_PALLAS", "0")
    want = _jax_xla_step(js(), state, tgt, eff)
    sim = _port_sim(PhysicsSwitches.from_env())
    assert sim.route == "nonkernel" and sim.kernel_launches() == {}
    _compare(sim.step(state, tgt, eff), want, GATE)


def _case_art_static(flagship, monkeypatch, request):
    port = Simulator(_pendulum_scene(), device="cpu", switches=PhysicsSwitches(art_static=False))
    assert port.route == "k1"
    state, tgt, eff = _pendulum_states(port)
    monkeypatch.setenv("ISAACGYM_TPU_ART_STATIC", "0")
    want = _jax_xla_step(_pendulum_over_block(), state, tgt, eff)
    got = port.step(state, tgt, eff)
    _compare(got, want, GATE)
    monkeypatch.delenv("ISAACGYM_TPU_ART_STATIC")
    on = Simulator(_pendulum_scene(), device="cpu").step(state, tgt, eff)
    _compare(on, _jax_xla_step(_pendulum_over_block(), state, tgt, eff), GATE)
    assert float((on.dof_vel - got.dof_vel).abs().max()) > 0.5   # the block stops the tip


def _case_torque(flagship, monkeypatch, request):
    pe, ins, want = request.getfixturevalue("pallas_tau_unpruned")
    k = pe.sim.fused_substep
    assert k.with_torque and pe.sim.fused_substep_dr.with_torque
    got = _np_out(k(*[torch.as_tensor(x) for x in ins]))
    assert_tau_close(got, want, "torque", (k.ng, 1))
    assert np.abs(got["impulses"][:, k.ng + 1:]).max() > 1e-3


def _case_reach_prune(flagship, monkeypatch, request):
    pe, ins, want = request.getfixturevalue("pallas_tau_unpruned")
    consts = pe.sim.constants
    pruned = Simulator(pe.scene, device="cpu", switches=PhysicsSwitches(torque=True))
    assert int(consts[F.C_NPAIR]) > int(pruned.constants[F.C_NPAIR])
    st, n_true, art, _ = fused_geom_lists(pe.scene)
    assert int(consts[F.C_NPAIR]) == len(art) * n_true
    k = pe.sim.fused_substep
    got = _np_out(k(*[torch.as_tensor(x) for x in ins]))
    assert_tau_close(got, want, "reach_prune", (k.ng, 1))
    same = _np_out(pruned.fused_substep(*[torch.as_tensor(x) for x in ins]))
    for f in got:
        np.testing.assert_array_equal(got[f], same[f], err_msg=f)


def _case_native(flagship, monkeypatch, request):
    path = os.path.join(ASSET_DIR, "g1_29dof_pingpong.urdf")
    tree_native = K.load_asset(path)
    monkeypatch.setattr(native, "parse_urdf_native", lambda p: pytest.fail("native parser"))
    got = K.load_asset(path, native=False)
    monkeypatch.setenv("ISAACGYM_TPU_NATIVE", "0")
    assert_trees_equal(got, JK.load_asset(path))
    assert_trees_equal(got, tree_native)
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device="cpu",
                                  switches=PhysicsSwitches.from_env())
    assert not env.switches.native


@pytest.mark.parametrize("switch", SWITCHES)
def test_switch_matches_the_jax_package_under_its_variable(flagship, monkeypatch, request,
                                                          switch):
    globals()[f"_case_{switch}"](flagship, monkeypatch, request)


# -- what each switch changes -----------------------------------------------

def test_art_static_off_lets_the_tip_settle_inside_the_block():
    tips = {}
    for on in (True, False):
        sim = Simulator(_pendulum_scene(), device="cpu",
                        switches=PhysicsSwitches(art_static=on))
        state = sim.initial_state(1)
        state = state._replace(dof_pos=torch.full((1, 1), np.pi / 2))
        z = torch.zeros(1, 1)
        for _ in range(600):
            state = sim.step(state, z, z)
        tip = sim.scene.body_names.index("pend/tip")
        tips[on] = float(sim.rigid_body_states(state)[0, tip, 2])
    assert 0.32 < tips[True] < 0.45 and tips[False] < 0.27, tips


def _ball_track(switches, steps=60, n=16):
    env = isaacgym_tpu_torch.make(seed=11, task=TASK, num_envs=n, device="cpu",
                                  episodeLength=80, switches=switches)
    state, _ = env.reset()
    out = []
    for _ in range(steps):
        state, *_ = env.step(state, torch.zeros(n, 7))
        out.append(state.sim.root[:, env.ball_actor, 0:3].clone())
    return torch.stack(out).numpy(), env.sim.route


def test_ccd_off_moves_the_bounce_on_the_nonkernel_step_only():
    swept, r1 = _ball_track(PhysicsSwitches(pallas=False))
    pen_only, r2 = _ball_track(PhysicsSwitches(pallas=False, ccd=False))
    assert r1 == r2 == "nonkernel"
    np.testing.assert_allclose(swept[:5], pen_only[:5], atol=1e-5)
    assert 0.0 < float(np.abs(swept - pen_only).max()) < 0.12
    kernel, r3 = _ball_track(PhysicsSwitches())
    kernel_ccd_off, r4 = _ball_track(PhysicsSwitches(ccd=False))
    assert r3 == r4 == "k2"
    np.testing.assert_array_equal(kernel, kernel_ccd_off)


@pytest.mark.parametrize("task", sorted(task_registry()))
def test_pallas_off_and_reach_prune_off_on_every_task(task):
    env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=2, device="cpu")
    scene = env.scene
    off = PhysicsSwitches(pallas=False)
    assert route_for(scene, "cuda", off) == route_for(scene, "cpu", off) == "nonkernel"
    unpruned = PhysicsSwitches(reach_prune=False)
    route = route_for(scene, "cuda")
    assert route_for(scene, "cuda", unpruned) == route == topology_route(scene)
    if route in ("k2", "k3"):
        sim = Simulator(scene, device="cpu", switches=unpruned)
        st, n_true, art, _ = fused_geom_lists(scene)
        assert int(sim.constants[F.C_NPAIR]) == len(art) * n_true <= F.MAX_PAIRS
        assert int(sim.constants[F.C_NPAIR]) >= int(env.sim.constants[F.C_NPAIR])


def test_torque_builds_the_tau_kernels_and_writes_moments_without_a_sensor(flagship):
    env, _ = flagship
    _, (state, tgt, eff) = _flagship_states(env)
    plain = _port_sim(PhysicsSwitches())
    tau = _port_sim(PhysicsSwitches(torque=True))
    assert not plain.with_torque and tau.with_torque and tau.route == "k2"
    assert env.scene.force_sensor_bodies.size == 0
    assert float(plain.step(state, tgt, eff).net_contact_torque.abs().max()) == 0.0
    assert float(tau.step(state, tgt, eff).net_contact_torque.abs().max()) > 1e-3
    for task, attr in ((C8, "fused_substep_multi"), (C10, "fused_substep_floating")):
        sim = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=2, device="cpu",
                                      switches=PhysicsSwitches(torque=True)).sim
        assert getattr(sim, attr).with_torque


# -- the kernel bodies on packs built under the switches --------------------

KERNEL_CASES = [("k2", "art_static"), ("k2", "kappa"), ("k2", "reach_prune"),
                ("k3", "art_static"), ("k3", "kappa"), ("k3", "reach_prune"),
                ("k4", "art_static"), ("k4", "kappa")]
SWITCH_OF = {"art_static": PhysicsSwitches(art_static=False),
             "kappa": PhysicsSwitches(kappa=0.5), "reach_prune": PhysicsSwitches(reach_prune=False)}


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    F.check_library_layout(lib, 7)
    M.check_library_layout(lib, 7, 2)
    FF.check_library_layout(lib, 27)
    return lib


@pytest.mark.parametrize("kernel,switch", KERNEL_CASES)
def test_kernel_body_matches_the_plain_version_under_the_switch(host, kernel, switch):
    sw = SWITCH_OF[switch]
    rng = np.random.RandomState(17)
    if kernel == "k2":
        cfg = scripted.raised_table_cfg(load_task_config(TASK))
        env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=8, device="cpu", cfg=cfg,
                                      switches=sw)
        k, c = env.sim.fused_substep, env.sim.constants
        for kind in ("paddle_ball", "paddle_table"):
            ins = [torch.as_tensor(a) for a in scripted.k2_inputs(env, kind, 8, rng)]
            got = run_k2(host, k.consts, k.ng, ins, None, "k2")[0]
            dev, flips = compare(_np_out(got), _np_out(plain_k2(k.consts, ins, None, "k2")))
            assert flips == 0.0 and all(dev[f] <= t for f, t in TOL.items()), (kind, dev)
        npair, kappa_slot = F.C_NPAIR, F.C_KAPPA
    elif kernel == "k3":
        env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=8, device="cpu", switches=sw)
        k, c = env.sim.fused_substep_multi, env.sim.constants
        for kind in scripted.C8_KINDS:
            ins = scripted.k3_inputs(env, kind, 8, rng)
            got, want = _np_out(run_k3(host, k, ins)[0]), _np_out(plain_k3(k, ins))
            dev, flips = compare_k3(got, want)
            assert flips == 0.0 and all(dev[f] <= t for f, t in TOL_K3.items()), (kind, dev)
        npair, kappa_slot = F.C_NPAIR, M.multi_layout(7, 2)["ball"] + F.C_KAPPA
    else:
        env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=8, device="cpu", switches=sw)
        k, c = env.sim.fused_substep_floating, env.sim.constants
        for kind in ("stand", "strike", "fall"):
            ins = scripted.k4_inputs(env, kind, 8, rng)
            got = _np_out(run_k4(host, c, ins)[0])
            want = _np_out(k(*[torch.as_tensor(a) for a in ins]))
            dev, flips = compare_k4(got, want)
            assert flips == 0.0 and all(dev[f] <= t for f, t in TOL_K4.items()), (kind, dev)
        npair, kappa_slot = F.C_NPAIR, F.C_KAPPA
        assert c[FF.C_ART_STATIC] == float(sw.art_static)
    default = {"k2": TASK, "k3": C8, "k4": C10}[kernel]
    base = isaacgym_tpu_torch.make(seed=0, task=default, num_envs=2, device="cpu",
                                   switches=PhysicsSwitches(),
                                   cfg=scripted.raised_table_cfg(load_task_config(TASK))
                                   if kernel == "k2" else None).sim.constants
    if switch == "art_static":
        assert c[npair] == 0 < base[npair]
    elif switch == "reach_prune":
        assert c[npair] > base[npair]
    else:
        assert c[kappa_slot] == 0.5 != base[kappa_slot]


def test_probe_ball_reports_the_switches_in_force(monkeypatch):
    """``ISAACGYM_TPU_PALLAS=0 ISAACGYM_TPU_BALL_KAPPA=0.5 ISAACGYM_TPU_CCD=0
    python -m isaacgym_tpu_torch.probe_ball`` reports them as
    ``tools/probe_ball.py:88-90`` does and runs the non-kernel step."""
    from isaacgym_tpu_torch import probe_ball
    for var, val in (("ISAACGYM_TPU_PALLAS", "0"), ("ISAACGYM_TPU_BALL_KAPPA", "0.5"),
                     ("ISAACGYM_TPU_CCD", "0")):
        monkeypatch.setenv(var, val)
    out = probe_ball.main(["--envs", "4", "--steps", "5", "--device", "cpu"])
    assert (out["pallas"], out["kappa_override"], out["ccd"]) == ("0", 0.5, "0")
    assert out["route"] == "nonkernel" and out["kernel_launches"] == {}
