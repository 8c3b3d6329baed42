"""K4-tau (the torque-lane build of K4, for a floating-base scene with a force
sensor) and the C10 sensor path.

The port's plain K4-tau is held against the JAX package's
``build_fused_substep_floating`` built with ``with_torque=True`` (Pallas,
interpret mode on the CPU, called directly with the scene's geom lists) on
the 4-DOF floating biped of ``tests/test_torch_fused_substep_floating.py``,
B = 128 per set, one substep from the same inputs. Two builds, one per drive
mode: the PD scene carries that file's pd, ground, clamp and strike sets
and ball_plane (the ball skidding on the ground with spin: the plane's
moment on the ball); the scene with the static block under effort drive
carries effort (random efforts, the feet on the block), block (that file's
set: art-vs-static) and ball_block (the ball skidding on the block: a
static's moment on the ball).

Tolerances: that file's (1e-4 on q, the base pose and the ball's position
and velocity; 1e-3 on qd, tau, the base's velocities, the ball's spin and
the force rows; no flips), and the moment rows on their own at
``tests/test_torch_force_torque.py``'s gates, 1e-5 on the geom bodies' and
1e-7 on the ball's. Measured over the eight sets: geom moments up to 1.05
(the feet on the block) deviate by at most 1.8e-6, ball moments up to
1.4e-4 by 1.1e-10, qd by 3.6e-5, the force rows by 2.3e-5. The g++ host
body (``csrc/fused_substep_host.cpp``) is held to the plain version at ND 4
and 27 at the same tolerances, flip rate at most 0.2 %.

The Pallas K4 at 27 DOFs takes about an hour of XLA compile in interpret
mode, so on C10 (a paddle sensor, 8 envs) the port's floating substep
(the plain K4-tau and its writeback) is held against the JAX package's XLA
substep (``_substep``, which always records moments) on stand, strike,
fall and table, over envs whose bodies in contact agree: forces to 1e-2 N
and moments to 1e-3 N m, as the flagship's sensor step is held
(``tests/test_torch_force_torque.py``); and the sensor read through
``acquire_force_sensor_tensor`` against the JAX package's on the same
substep. Measured: forces 1.4e-4 N and moments 4.1e-6 N m apart at most
(moments up to 3.6 N m at the raised table's feet), no env whose bodies in
contact differ.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.sim import asset_api as JA
from isaacgym_tpu.sim import tensor_api as JT
from isaacgym_tpu.sim.scene import ActorSpec as JActorSpec
from isaacgym_tpu.sim.scene import PlaneParams as JPlaneParams
from isaacgym_tpu.sim.scene import SceneSpec as JSceneSpec
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_pingpong_scene
from isaacgym_tpu_torch.interop import sim_state_from_numpy
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim import tensor_api as T
from isaacgym_tpu_torch.sim.scene import (DRIVE_EFFORT, DRIVE_POS, ActorSpec, PlaneParams,
                                          SceneSpec, compile_scene)
from isaacgym_tpu_torch.sim.simulator import Simulator, floating_geom_lists, fused_ball_cfg
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_fused_substep_floating import _c10_state, _toy_spec, toy_inputs

B = 128
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
C10_B = 8
TOL = dict(q_new=1e-4, base_pos=1e-4, base_quat=1e-4, ball_pos=1e-4, ball_vel=1e-4,
           qd_new=1e-3, tau=1e-3, base_linvel=1e-3, base_angvel=1e-3, ball_omega=1e-3,
           impulses=1e-3, geom_moments=1e-5, ball_moments=1e-7)
SENSOR_TOL = dict(net_contact_force=1e-2, net_contact_torque=1e-3)
#: scene -> (drive mode, its sets)
SCENES = {"toy": (DRIVE_POS, ("pd", "ground", "clamp", "strike", "ball_plane")),
          "block": (DRIVE_EFFORT, ("effort", "block", "ball_block"))}
KINDS = [k for _, ks in SCENES.values() for k in ks]


def _pallas_k4tau(js):
    """The JAX package's K4-tau for the JAX simulator ``js``'s scene, with the
    arguments ``Simulator._build_fused_floating`` gives K4."""
    scene, plane = js.scene, js.scene.spec.plane
    slot = scene.articulations[0]
    static_list, art_list, _ = floating_geom_lists(scene)
    return PDK.build_fused_substep_floating(
        slot.model, slot.stiffness, slot.damping, np.asarray(js.gravity), js.dt / js.substeps,
        fused_ball_cfg(scene), static_list, art_list,
        plane_cfg=dict(e=plane.restitution, mu=plane.dynamic_friction,
                       max_depen=js.max_depenetration),
        bounce_threshold=js.bounce_threshold, drive_mode=slot.drive_mode,
        exact_support=scene.spec.exact_link_support,
        max_angular_velocity=slot.max_angular_velocity,
        max_linear_velocity=slot.max_linear_velocity, with_torque=True)


def _inputs(ps, kind, rng):
    """K4's inputs for ``kind``: the K4 file's sets, the feet on the block for
    effort, and the ball skidding with spin on the ground or the block."""
    if kind in ("ball_plane", "ball_block"):
        ins = list(toy_inputs(ps, "pd", rng))
        if kind == "ball_block":   # the biped stands clear of the block
            ins[4] = ins[4] + np.asarray([3.0, 0.0, -0.88], np.float32)
        top = 0.5 if kind == "ball_block" else 0.0
        xy = rng.uniform(-0.5, 0.5, (B, 2)) if kind == "ball_block" else \
            rng.uniform(1.0, 2.0, (B, 2))
        ins[8] = np.concatenate([xy, top + 0.02 + rng.uniform(-0.003, 0.001, (B, 1))], 1)
        ins[9] = np.concatenate([rng.uniform(-3.0, 3.0, (B, 2)),
                                 rng.uniform(-2.0, 0.0, (B, 1))], 1)
        ins[10] = rng.uniform(-30.0, 30.0, (B, 3))
        return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in ins)
    ins = list(toy_inputs(ps, kind, rng))
    if kind == "effort":   # on the block, as the block set
        ins[4][:, 2] = 0.5 + 0.72 - rng.uniform(0.0, 0.02, B)
    return tuple(ins)


@pytest.fixture(scope="module")
def cases():
    """kind -> (port simulator with K4-tau, inputs, JAX Pallas K4-tau outputs);
    one interpret-mode build per drive mode, one call over all its sets."""
    out = {}
    for scene, (drive, kinds) in SCENES.items():
        js = JSimulator(jax_compile_scene(_toy_spec(JU, JK, JActorSpec, JPlaneParams, JSceneSpec,
                                                    scene, drive)))
        ps = Simulator(compile_scene(_toy_spec(U, K, ActorSpec, PlaneParams, SceneSpec, scene,
                                               drive)), device="cpu")
        ps.fused_substep_floating = FF.FusedSubstepFloating(ps.constants, with_torque=True)
        ins = [_inputs(ps, kind, np.random.RandomState(70 + i)) for i, kind in enumerate(kinds)]
        cat = [np.concatenate(parts) for parts in zip(*ins)]
        oj = _pallas_k4tau(js)(*[jnp.asarray(x) for x in cat])
        for i, kind in enumerate(kinds):
            want = {f: np.asarray(getattr(oj, f))[i * B:(i + 1) * B] for f in oj._fields}
            out[kind] = (ps, ins[i], want)
    return out


def _np_out(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def _split(out, ng):
    """A K4-tau output with its impulses split into the ng + 1 force rows,
    the ng geom moment rows and the ball's moment row."""
    imp = out["impulses"]
    return {**out, "impulses": imp[:, :ng + 1], "geom_moments": imp[:, ng + 1:2 * ng + 1],
            "ball_moments": imp[:, 2 * ng + 1:]}


def _assert_close(a, b, what, ng, max_flip_rate=0.0):
    """At most ``max_flip_rate`` of the envs flipped (force rows active in one
    and not the other), every output of the others within TOL, the moment
    rows on their own."""
    a, b = _split(a, ng), _split(b, ng)
    active = lambda imp: np.abs(imp).sum(-1) > 0
    flip = np.any(active(a["impulses"]) != active(b["impulses"]), axis=1)
    assert flip.mean() <= max_flip_rate, f"{what}: {int(flip.sum())} flipped envs"
    for f, tol in TOL.items():
        d = float(np.abs(a[f] - b[f]).reshape(len(flip), -1)[~flip].max())
        assert d <= tol, f"{what}: {f} deviates {d:.3e} > {tol}"


@pytest.mark.parametrize("kind", KINDS)
def test_plain_k4tau_matches_the_pallas_kernel_on_the_biped(cases, kind):
    ps, ins, want = cases[kind]
    k = ps.fused_substep_floating
    got = k(*[torch.as_tensor(x) for x in ins])
    assert got.impulses.shape == (B, 2 * k.ng + 2, 3)
    _assert_close(_np_out(got), want, kind, k.ng)


def test_the_sets_reach_every_kind_of_moment_row(cases):
    """Ball-vs-geom (the strike's paddle sphere), art-vs-static (the feet on
    the block), and the ball's moments from the plane and from a static."""
    tq = lambda kind: np.linalg.norm(cases[kind][2]["impulses"], axis=-1)   # (B, 2ng+2)
    ng = cases["pd"][0].fused_substep_floating.ng
    paddle = ng - 1                      # the paddle sphere ends the geom list
    strike = tq("strike")
    assert ((strike[:, ng + 1 + paddle] > 1e-7) & (strike[:, paddle] > 0)).mean() > 0.3
    assert (strike[:, 2 * ng + 1] > 1e-9).mean() > 0.3
    for kind in ("block", "effort"):     # feet (geoms 1, 2) on the block
        assert (tq(kind)[:, ng + 2:ng + 4] > 1e-7).any(1).mean() > 0.3, kind
    for kind in ("ball_plane", "ball_block"):
        rows = tq(kind)
        assert (rows[:, 2 * ng + 1] > 1e-9).mean() > 0.5, kind
        assert not (rows[:, :ng] > 0).any(), kind    # the ball touches no geom
    # the ground contacts stay unrecorded: the ground set's moments are zero
    assert not tq("ground")[:, ng + 1:].any()


def test_k4tau_without_the_lanes_is_k4(cases):
    """The torque lanes change nothing else: every other output of the plain
    K4-tau, and of its host body, equals K4's on the same inputs, bit for
    bit."""
    ps, ins, _ = cases["strike"]
    t = [torch.as_tensor(x) for x in ins]
    ng = ps.fused_substep_floating.ng
    a = FF.floating_substep_plain(ps.constants, *t, with_torque=True)
    b = FF.floating_substep_plain(ps.constants, *t)
    for f in b._fields:
        x = getattr(a, f)[:, :ng + 1] if f == "impulses" else getattr(a, f)
        assert torch.equal(x, getattr(b, f)), f


def _host_run(host, consts, ins, with_torque):
    nd = ins[0].shape[1]
    x = FF.pack_inputs(*[torch.as_tensor(a) for a in ins])
    c = torch.as_tensor(consts)
    y = torch.zeros((FF.n_out(nd, int(consts[FF.C_NART]), with_torque), x.shape[1]))
    run, count = ((host.igt_fused_substep_floating_tau_host,
                   host.igt_fused_substep_floating_tau_count_ops) if with_torque else
                  (host.igt_fused_substep_floating_host,
                   host.igt_fused_substep_floating_count_ops))
    assert run(c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], nd) == 0
    ops = count(c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], nd)
    return FF.unpack_outputs(y, nd), ops


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    for nd in (4, 27):
        FF.check_library_layout(lib, nd)
    return lib


@pytest.mark.parametrize("kind", KINDS)
def test_host_k4tau_matches_the_plain_version_on_the_biped(cases, host, kind):
    ps, ins, _ = cases[kind]
    k = ps.fused_substep_floating
    got, ops = _host_run(host, k.consts, ins, True)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x) for x in ins],
                                     with_torque=True)
    _assert_close(_np_out(got), _np_out(want), f"host {kind}", k.ng, 0.002)
    plain, ops0 = _host_run(host, k.consts, ins, False)
    assert ops >= ops0 > 1000 * B
    for f in plain._fields:   # the host body's K4 outputs are K4-tau's first ones
        x = getattr(got, f)[:, :k.ng + 1] if f == "impulses" else getattr(got, f)
        assert torch.equal(x, getattr(plain, f)), f


@pytest.mark.parametrize("how", ["zeroed", "negated"])
@pytest.mark.parametrize("field", ["geom_moments", "ball_moments"])
def test_moment_gates_reject_wrong_moments(cases, field, how):
    """The plain K4-tau with its geom or its ball moment rows zeroed or
    negated fails its gate against the Pallas K4-tau on a set the sound
    version passes."""
    for kind in ("strike", "ball_block"):
        ps, ins, want = cases[kind]
        ng = ps.fused_substep_floating.ng
        out = _np_out(ps.fused_substep_floating(*[torch.as_tensor(x) for x in ins]))
        rows = slice(ng + 1, 2 * ng + 1) if field == "geom_moments" else slice(2 * ng + 1, None)
        bad = dict(out, impulses=out["impulses"].copy())
        bad["impulses"][:, rows] *= 0.0 if how == "zeroed" else -1.0
        _assert_close(out, want, "sound", ng)
        if kind == "strike" or field == "ball_moments":
            with pytest.raises(AssertionError, match=field):
                _assert_close(bad, want, f"{kind} {how}", ng)


# ------------------------------------------------------------------ C10 --

def _jax_c10_sensor_sim(cfg):
    """The JAX package's C10 scene with a sensor on the paddle, on a fresh
    copy of its cached asset."""
    spec = jax_pingpong_scene(cfg["env"], cfg["sim"], floating_base=True)
    tree = dataclasses.replace(spec.actors[0].tree)
    spec.actors[0].tree = tree
    JA.create_asset_force_sensor(tree, JA.find_asset_rigid_body_index(tree, "pingpong_paddle"))
    return JSimulator(jax_compile_scene(spec))


@pytest.fixture(scope="module")
def c10_cases():
    """kind -> (port sensor simulator, inputs, numpy SimState dict, JAX sensor
    simulator, the JAX XLA substep's output state)."""
    out = {}
    for raised in (False, True):
        cfg = load_task_config(C10)
        if raised:
            cfg = scripted.raised_table_cfg(cfg)
        ps = Simulator(scripted.paddle_sensor_scene(cfg, floating_base=True), device="cpu")
        js = _jax_c10_sensor_sim(cfg)
        dt_s = js.dt / js.substeps
        sub = jax.jit(jax.vmap(lambda s, t, e: js._substep(s, t, e, dt_s)))
        env = types.SimpleNamespace(scene=ps.scene, cfg=cfg)
        for i, kind in enumerate(("table",) if raised else ("stand", "strike", "fall")):
            ins = scripted.k4_inputs(env, kind, C10_B, np.random.RandomState(80 + i))
            d = _c10_state(env, ins)
            sj = sub(js.initial_state(C10_B)._replace(**{k: jnp.asarray(v) for k, v in d.items()}),
                     jnp.asarray(ins[2]), jnp.asarray(ins[3]))
            out[kind] = (ps, ins, d, js, sj)
    return out


C10_KINDS = ("stand", "strike", "fall", "table")


@pytest.mark.parametrize("kind", C10_KINDS)
def test_c10_sensor_substep_matches_the_xla_substep(c10_cases, kind):
    """The port's floating substep on the sensor scene (the plain K4-tau and
    the writeback of its moment rows) against the JAX package's XLA substep:
    the force and the moment at every body, and the sensor tensor, over the
    envs whose bodies in contact agree."""
    ps, ins, d, js, sj = c10_cases[kind]
    assert ps.route == "k4" and ps.with_torque and ps.fused_substep_floating.with_torque
    dt_s = ps.dt / ps.substeps
    got = ps._substep_fused_floating(sim_state_from_numpy(d), torch.as_tensor(ins[2]),
                                     torch.as_tensor(ins[3]), dt_s)
    want = {f: np.asarray(getattr(sj, f)) for f in sj._fields}
    contact = lambda ncf: np.abs(ncf).sum(-1) > 0
    same = np.all(contact(got.net_contact_force.numpy()) == contact(want["net_contact_force"]),
                  axis=1)
    assert same.mean() >= 0.75, kind   # the C10 parity row's flip budget
    for f, tol in SENSOR_TOL.items():
        dev = np.abs(getattr(got, f).numpy() - want[f])[same].max()
        assert dev <= tol, f"{kind}: {f} deviates {dev:.3e} > {tol}"
    w = T.acquire_force_sensor_tensor(ps, got).numpy()
    wj = np.asarray(JT.acquire_force_sensor_tensor(js, sj))
    assert w.shape == wj.shape == (C10_B, 1, 6)
    np.testing.assert_allclose(w[same, :, :3], wj[same, :, :3], rtol=0,
                               atol=SENSOR_TOL["net_contact_force"])
    np.testing.assert_allclose(w[same, :, 3:], wj[same, :, 3:], rtol=0,
                               atol=SENSOR_TOL["net_contact_torque"])
    if kind == "strike":   # the strikes reach the paddle sensor's moment lanes
        assert (np.linalg.norm(w[same, 0, 3:], axis=-1) > 1e-2).mean() > 0.3
    if kind == "table":    # art-vs-static moments at the feet
        feet = ps.art_bodies[[1, 3]]
        assert np.abs(got.net_contact_torque.numpy()[:, feet]).sum((1, 2)).max() > 1e-2


@pytest.mark.parametrize("kind", C10_KINDS)
def test_host_k4tau_matches_the_plain_version_on_c10(c10_cases, host, kind):
    ps, ins, _, _, _ = c10_cases[kind]
    k = ps.fused_substep_floating
    got, ops = _host_run(host, k.consts, ins, True)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x) for x in ins],
                                     with_torque=True)
    _assert_close(_np_out(got), _np_out(want), f"host {kind}", k.ng, 0.002)
    assert ops > 10000 * C10_B


def test_c10_sensor_step_writes_the_moments(c10_cases):
    """Over one ``Simulator.step`` (two substeps) ``net_contact_torque``
    gathers each substep's moment rows / dt at the geom bodies and the ball,
    and the sensor reads [net_contact_force, net_contact_torque] at the
    paddle's row."""
    ps, ins, _, _, _ = c10_cases["strike"]
    state, tgt, eff = scripted.k4_state(ps, ins)
    out = ps.step(state, tgt, eff)
    k, ng, dt = ps.fused_substep_floating, len(ps.art_bodies), ps.dt
    s = state._replace(net_contact_force=torch.zeros_like(state.net_contact_force),
                       net_contact_torque=torch.zeros_like(state.net_contact_torque))
    nct = torch.zeros_like(state.net_contact_torque)
    ball = ps.ball.body_start
    for _ in range(ps.substeps):
        h, b = s.root[:, 0], s.root[:, ps.ball.actor_index]
        o = k(s.dof_pos, s.dof_vel, tgt, eff, h[:, 0:3].contiguous(), h[:, 3:7].contiguous(),
              h[:, 7:10].contiguous(), h[:, 10:13].contiguous(), b[:, 0:3].contiguous(),
              b[:, 7:10].contiguous(), b[:, 10:13].contiguous())
        for gi, body in enumerate(ps.art_bodies):
            nct[:, body] += o.impulses[:, ng + 1 + gi] / dt
        nct[:, ball] += o.impulses[:, 2 * ng + 1] / dt
        s = ps._substep_fused_floating(s, tgt, eff, dt / ps.substeps)
    torch.testing.assert_close(out.net_contact_torque, nct, rtol=1e-6, atol=1e-7)
    w = T.acquire_force_sensor_tensor(ps, out)
    rows = ps.scene.force_sensor_bodies
    assert torch.equal(w[..., :3], out.net_contact_force[:, rows])
    assert torch.equal(w[..., 3:], out.net_contact_torque[:, rows])
    assert bool((w[..., 3:].norm(dim=-1) > 0).any())
