"""Force sensors and the torque lanes: K2-tau and K3-tau (the fused substeps'
``with_torque`` builds) and the simulator's moment writeback.

The port's plain K2-tau is held against the JAX package's Pallas K2-tau
(interpret mode on the CPU, built by ``Simulator._maybe_build_pallas(force=
True)`` for a scene with a sensor on the paddle) on the flagship scene with
its table raised 0.49 m (``scripted.raised_table_cfg``, so that the
paddle_table set reaches the art-vs-static contacts and their moments), one
batch of B = 128 from three sets: paddle_ball (off-centre strikes of the
paddle face), paddle_table and ball_rest. The plain K3-tau is held against
the Pallas K3-tau on the JAX tests' two-arm, two-ball scene with a sensor on
the paddle (``tests/test_pallas_dynamics.py:_toy_multi_scene``), B = 128
from its four sets, ball_ball among them: the JAX package's own tests never
reach K3-tau's ball-pair moments. One interpret-mode trace each. The g++
host bodies (``csrc/fused_substep_host.cpp``) of K2-tau, K2-dr-tau and
K3-tau are held against the plain versions, and the port's simulator step
(the moment writeback) against the JAX package's fused step on the same
sensor scene and strike states (``tests/test_force_torque.py:61,100``).

The JAX scenes are built on fresh copies of the JAX package's cached assets
(``dataclasses.replace``), so their sensors stay out of other tests' scenes.

Tolerances, over envs whose contact pattern (the force rows) agrees (no
flip), as for K2 and K3 (``tests/test_torch_fused_substep.py``): 1e-4 on q,
ball pos and vel; 1e-3 on qd, tau, omega and the force rows. The moment
rows are compared on their own, at gates set by their size: a ball's
moment about its centre is its radius (0.02 m) times a friction impulse,
at most ~1e-4 here (1.7e-6 on the resting ball, 8e-6 in the ball pair),
and is held to 1e-7 (measured up to 3.6e-10); a geom body's moment is at
most ~0.1 (art-vs-static) and ~6e-3 in a strike, held to 1e-5 (measured
up to 3.8e-7, at the raised table's contacts of 0.11). Moment rows
zeroed or negated fail both gates (``test_moment_gates_reject_wrong_moments``);
no flips. The host bodies are held to the plain versions at the
same tolerances, flip rate at most 0.2 % (the same arithmetic; PyTorch's CPU
``sin`` differs from glibc's by an ulp, which the Cholesky solve amplifies
in qd and the ball's spin). The simulator step against the JAX fused step,
over envs whose bodies in contact agree: forces to 1e-2 N and torques to
1e-3 N m (impulses ~1e-6 apart, times 1 / dt = 120).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from isaacgym_tpu.sim import asset_api as JA
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import Simulator as JaxSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_pingpong_scene
from isaacgym_tpu_torch.interop import copy_force_sensors, sim_state_from_numpy
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops import fused_substep_multi as M
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim import tensor_api as T
from isaacgym_tpu_torch.sim.scene import DRIVE_POS
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_pallas_dynamics import _toy_multi_scene

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 128
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3, geom_moments=1e-5, ball_moments=1e-7)
K2_SETS = (("paddle_ball", 48), ("paddle_table", 48), ("ball_rest", 32))


def _np_out(o):
    return {f: np.asarray(getattr(o, f)) for f in o._fields}


def _active(imp):
    return np.abs(imp).sum(-1) > 0


def _split(out, ng, nb):
    """The outputs with a torque build's impulses split into the force rows,
    the ng geom moment rows and the nb ball moment rows (the last rows)."""
    imp = out["impulses"]
    return {**out, "impulses": imp[:, :-(ng + nb)], "geom_moments": imp[:, -(ng + nb):-nb],
            "ball_moments": imp[:, -nb:]}


def _assert_close(a, b, what, moments, max_flip_rate=0.0):
    """At most ``max_flip_rate`` of the envs flipped (force rows active in one
    and not the other), and every output of the others within its
    tolerance, the moment rows (``moments`` = (ng, nb)) on their own."""
    a, b = _split(a, *moments), _split(b, *moments)
    flip = np.any(_active(a["impulses"]) != _active(b["impulses"]), axis=1)
    assert flip.mean() <= max_flip_rate, f"{what}: {int(flip.sum())} flipped envs"
    for f, tol in TOL.items():
        d = float(np.abs(a[f] - b[f]).reshape(len(flip), -1)[~flip].max())
        assert d <= tol, f"{what}: {f} deviates {d:.3e} > {tol}"


def _jax_sensor_scene(cfg, humanoids=1):
    """The JAX package's pingpong scene with a sensor on the paddle, on a
    fresh copy of its cached humanoid asset."""
    spec = jax_pingpong_scene(cfg["env"], cfg["sim"], humanoids=humanoids)
    tree = dataclasses.replace(spec.actors[0].tree)
    for a in spec.actors[:humanoids]:
        a.tree = tree
    JA.create_asset_force_sensor(tree, JA.find_asset_rigid_body_index(tree, "pingpong_paddle"))
    return jax_compile_scene(spec)


@pytest.fixture(scope="module")
def k2tau():
    """(port simulator, inputs, JAX Pallas K2-tau outputs, JAX simulator) on
    the raised-table flagship scene with a paddle sensor; the rows of each
    set in order."""
    cfg = scripted.raised_table_cfg(load_task_config(TASK))
    jsim = JaxSimulator(_jax_sensor_scene(cfg))
    jsim._maybe_build_pallas(force=True)
    psim = Simulator(scripted.paddle_sensor_scene(cfg), device="cpu")
    env = types.SimpleNamespace(scene=psim.scene, cfg=cfg)
    parts = [scripted.k2_inputs(env, kind, n, np.random.RandomState(30 + i))
             for i, (kind, n) in enumerate(K2_SETS)]
    ins = tuple(np.concatenate(p) for p in zip(*parts))
    want = _np_out(jsim._fused(*[jnp.asarray(x) for x in ins]))
    return psim, ins, want, jsim


@pytest.fixture(scope="module")
def k3tau():
    """(port toy env with paddle sensors, inputs, JAX Pallas K3-tau outputs)."""
    jscene = _toy_multi_scene(DRIVE_POS)
    arm = jscene.spec.actors[0].tree
    JA.create_asset_force_sensor(arm, arm.body_index("paddle"))
    jsim = JaxSimulator(jscene)
    jsim._maybe_build_pallas(force=True)
    te = scripted.ToyEnv(DRIVE_POS, paddle_sensor=True)
    rows = B // len(scripted.TOY_KINDS)
    parts = [scripted.k3_inputs(te, kind, rows, np.random.RandomState(40 + i))
             for i, kind in enumerate(scripted.TOY_KINDS)]
    ins = tuple(np.concatenate(p) for p in zip(*parts))
    want = _np_out(jsim._fused_multi(*[jnp.asarray(x) for x in ins]))
    return te, ins, want


def _k2_rows(out, kind):
    start = 0
    for k, n in K2_SETS:
        if k == kind:
            return {f: v[start:start + n] for f, v in out.items()}
        start += n
    raise KeyError(kind)


def _k3_rows(out, kind):
    rows = B // len(scripted.TOY_KINDS)
    i = scripted.TOY_KINDS.index(kind)
    return {f: v[i * rows:(i + 1) * rows] for f, v in out.items()}


# ------------------------------------------------------------------ K2-tau --

def test_sensor_scenes_build_the_torque_lanes_and_others_do_not(k2tau):
    psim, _, want, _ = k2tau
    ng = len(psim.art_bodies)
    assert psim.with_torque and psim.fused_substep.with_torque
    assert psim.fused_substep_dr.with_torque
    assert want["impulses"].shape == (B, 2 * ng + 2, 3)
    plain = Simulator(scripted.ToyEnv(DRIVE_POS).scene, device="cpu")
    assert not plain.with_torque and not plain.fused_substep_multi.with_torque
    cfg = load_task_config(TASK)
    from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
    from isaacgym_tpu_torch.sim.scene import compile_scene
    flag = Simulator(compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"])), device="cpu")
    assert not flag.with_torque and not flag.fused_substep.with_torque


@pytest.mark.parametrize("kind", [k for k, _ in K2_SETS])
def test_plain_k2tau_matches_pallas(k2tau, kind):
    psim, ins, want, _ = k2tau
    got = _np_out(psim.fused_substep(*[torch.as_tensor(x) for x in ins]))
    _assert_close(_k2_rows(got, kind), _k2_rows(want, kind), kind, (len(psim.art_bodies), 1))


def test_k2tau_sets_reach_every_moment_row(k2tau):
    """Off-centre strikes give the paddle body a moment; the table contacts
    of the paddle give its body one too; the resting ball's static contacts
    give the ball one."""
    psim, _, want, _ = k2tau
    ng = len(psim.art_bodies)
    tq = {k: np.linalg.norm(_k2_rows(want, k)["impulses"][:, ng + 1:], axis=-1)
          for k, _ in K2_SETS}
    assert (tq["paddle_ball"][:, ng - 1] > 1e-7).mean() > 0.5        # paddle body
    assert (tq["paddle_ball"][:, ng] > 1e-9).mean() > 0.5            # the ball
    assert (tq["paddle_table"][:, :ng] > 1e-7).any(1).mean() > 0.3   # art-vs-static
    assert (tq["ball_rest"][:, ng] > 0).mean() > 0.5


def test_k2tau_without_the_lanes_is_k2(k2tau):
    """The torque lanes change nothing else: every other output of K2-tau
    equals K2's on the same inputs, bit for bit."""
    psim, ins, _, _ = k2tau
    t = [torch.as_tensor(x) for x in ins]
    a = F.fused_substep_reference(psim.constants, *t, with_torque=True)
    b = F.fused_substep_reference(psim.constants, *t)
    ng = len(psim.art_bodies)
    for f in b._fields:
        x = getattr(a, f)[:, :ng + 1] if f == "impulses" else getattr(a, f)
        assert torch.equal(x, getattr(b, f)), f


# ------------------------------------------------------------------ K3-tau --

@pytest.mark.parametrize("kind", scripted.TOY_KINDS)
def test_plain_k3tau_matches_pallas(k3tau, kind):
    te, ins, want = k3tau
    got = _np_out(te.sim.fused_substep_multi(*[torch.as_tensor(x) for x in ins]))
    k = te.sim.fused_substep_multi
    _assert_close(_k3_rows(got, kind), _k3_rows(want, kind), kind, (k.ng, k.nb))


def test_k3tau_ball_ball_moments_act(k3tau):
    """The ball pair's moments: in the ball_ball set both balls' moment rows
    are non-zero where the pair's impulse acts, and the two balls' moments,
    -r (n x P) each, are equal (equal radii), as the Pallas kernel's are."""
    te, ins, want = k3tau
    ng = te.sim.fused_substep_multi.ng
    w = _k3_rows(want, "ball_ball")["impulses"]
    pair = _active(w[:, ng:ng + 2]).all(1) & ~_active(w[:, :ng]).any(1)
    assert pair.mean() > 0.5
    tq = w[pair, 2 * ng + 4:]                                         # the two balls' rows
    assert (np.linalg.norm(tq, axis=-1) > 1e-9).all()
    np.testing.assert_allclose(tq[:, 0], tq[:, 1], rtol=1e-5, atol=1e-12)
    got = _np_out(te.sim.fused_substep_multi(*[torch.as_tensor(x) for x in ins]))
    g = _k3_rows(got, "ball_ball")["impulses"][pair, 2 * ng + 4:]
    np.testing.assert_allclose(g, tq, rtol=0, atol=1e-6)


def test_k3tau_shape_and_paddle_moments(k3tau):
    te, _, want = k3tau
    ng, nb = te.sim.fused_substep_multi.ng, 2
    assert want["impulses"].shape == (B, 2 * ng + 3 * nb, 3)
    for kind in ("paddle_ball1", "paddle_ball2"):
        tq = np.linalg.norm(_k3_rows(want, kind)["impulses"][:, ng + 2 * nb:2 * ng + 2 * nb],
                            axis=-1)
        assert (tq > 1e-7).any(1).mean() > 0.5, kind


@pytest.mark.parametrize("how", ["zeroed", "negated"])
@pytest.mark.parametrize("field", ["geom_moments", "ball_moments"])
def test_moment_gates_reject_wrong_moments(k2tau, k3tau, field, how):
    """A plain K2-tau or K3-tau whose geom or ball moment rows were zeroed
    or negated fails its gate against the Pallas kernel, on the same batch
    the sound version passes."""
    psim, ins, want, _ = k2tau
    te, ins3, want3 = k3tau
    k3 = te.sim.fused_substep_multi
    for out, ref, (ng, nb) in (
            (_np_out(psim.fused_substep(*[torch.as_tensor(x) for x in ins])), want,
             (len(psim.art_bodies), 1)),
            (_np_out(k3(*[torch.as_tensor(x) for x in ins3])), want3, (k3.ng, k3.nb))):
        rows = slice(-(ng + nb), -nb) if field == "geom_moments" else slice(-nb, None)
        bad = dict(out, impulses=out["impulses"].copy())
        bad["impulses"][:, rows] *= 0.0 if how == "zeroed" else -1.0
        _assert_close(out, ref, "sound", (ng, nb))
        with pytest.raises(AssertionError, match=field):
            _assert_close(bad, ref, how, (ng, nb))


# ------------------------------------------------------------- host bodies --

@pytest.fixture(scope="module")
def host_lib():
    lib = _build.build_host_library()
    F.check_library_layout(lib, 7)
    for nd in (3, 7):
        M.check_library_layout(lib, nd, 2)
    return lib


def _host_k2(lib, sim, ins, chan=None):
    t = [torch.as_tensor(x) for x in ins]
    x = F.pack_inputs(*t, None if chan is None else torch.as_tensor(chan))
    ng = len(sim.art_bodies)
    y = torch.empty((F.n_out(7, ng, True), x.shape[1]))
    c = torch.as_tensor(sim.constants)
    assert lib.igt_fused_substep_tau_host(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                                          x.shape[1], 7, int(chan is not None)) == 0
    ops = lib.igt_fused_substep_tau_count_ops(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                                              x.shape[1], 7, int(chan is not None))
    return _np_out(F.unpack_outputs(y, 7, ng)), ops


def test_host_k2tau_matches_plain(k2tau, host_lib):
    psim, ins, _, _ = k2tau
    got, ops = _host_k2(host_lib, psim, ins)
    _assert_close(got, _np_out(psim.fused_substep(*[torch.as_tensor(x) for x in ins])),
                  "K2-tau host", (len(psim.art_bodies), 1), 0.002)
    # the lanes cost operations only in the torque build
    c, x = torch.as_tensor(psim.constants), F.pack_inputs(*[torch.as_tensor(a) for a in ins])
    y = torch.empty((F.n_out(7, len(psim.art_bodies)), B))
    base = host_lib.igt_fused_substep_count_ops(c.data_ptr(), x.data_ptr(), y.data_ptr(), B, 7)
    assert ops > base > 0


def test_host_k2_dr_tau_matches_plain(k2tau, host_lib):
    from tests.test_torch_fused_substep import full_strength_dr
    psim, ins, _, _ = k2tau
    spec = load_task_config(TASK)["task"]["randomization_params"]
    chan = full_strength_dr(spec, 7, np.random.RandomState(3))
    got, _ = _host_k2(host_lib, psim, ins, chan)
    want = psim.fused_substep_dr(*[torch.as_tensor(x) for x in ins], torch.as_tensor(chan))
    _assert_close(got, _np_out(want), "K2-dr-tau host", (len(psim.art_bodies), 1), 0.002)


def _host_k3(lib, env, ins):
    k = env.sim.fused_substep_multi
    x = M.pack_inputs(*[torch.as_tensor(a) for a in ins])
    y = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng, True), x.shape[1]))
    c = torch.as_tensor(env.sim.constants)
    assert lib.igt_fused_substep_multi_tau_host(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                                                x.shape[1], k.nd, k.K, k.nb) == 0
    return _np_out(M.unpack_outputs(y, k.nd_tot, k.nb, k.ng))


def test_host_k3tau_matches_plain_on_the_toy(k3tau, host_lib):
    te, ins, _ = k3tau
    k = te.sim.fused_substep_multi
    _assert_close(_host_k3(host_lib, te, ins),
                  _np_out(k(*[torch.as_tensor(x) for x in ins])), "K3-tau host", (k.ng, k.nb))


@pytest.mark.parametrize("kind", ["paddle_ball1", "paddle_ball2"])
def test_host_k3tau_matches_plain_on_c8(host_lib, kind):
    cfg = load_task_config("Humanoid12PingpongTiltG1")
    sim = Simulator(scripted.paddle_sensor_scene(cfg, humanoids=2), device="cpu")
    env = types.SimpleNamespace(scene=sim.scene, cfg=cfg, sim=sim)
    ins = scripted.k3_inputs(env, kind, B, np.random.RandomState(50))
    k = sim.fused_substep_multi
    _assert_close(_host_k3(host_lib, env, ins), _np_out(k(*[torch.as_tensor(x) for x in ins])),
                  f"K3-tau host {kind}", (k.ng, k.nb), 0.002)


# -------------------------------------------------- the simulator's writeback --

def test_step_writes_the_moments_and_the_sensor_reads_them(k2tau):
    """Over one step (two substeps) net_contact_torque gathers each substep's
    moment rows / dt at the geom bodies and the ball, and the sensor tensor
    is [net_contact_force, net_contact_torque] at the paddle's row."""
    psim, _, _, _ = k2tau
    state, tgt = scripted.strike_state(psim, "paddle_ball", 64, np.random.RandomState(60))
    eff = torch.zeros_like(tgt)
    out = psim.step(state, tgt, eff)
    # the same two substeps by hand
    s = state._replace(net_contact_force=torch.zeros_like(state.net_contact_force),
                       net_contact_torque=torch.zeros_like(state.net_contact_torque))
    ng, dt = len(psim.art_bodies), psim.dt
    nct = torch.zeros_like(state.net_contact_torque)
    ball = psim.ball.body_start
    for _ in range(psim.substeps):
        sl = slice(0, 7)
        o = psim.fused_substep(s.dof_pos[:, sl], s.dof_vel[:, sl], tgt, eff,
                               s.root[:, 2, 0:3], s.root[:, 2, 7:10], s.root[:, 2, 10:13])
        for gi, body in enumerate(psim.art_bodies):
            nct[:, body] += o.impulses[:, ng + 1 + gi] / dt
        nct[:, ball] += o.impulses[:, 2 * ng + 1] / dt
        s = psim._substep_fused(s, tgt, eff, dt / psim.substeps)
    torch.testing.assert_close(out.net_contact_torque, nct, rtol=1e-6, atol=1e-7)
    w = T.acquire_force_sensor_tensor(psim, out)
    rows = psim.scene.force_sensor_bodies
    assert w.shape == (64, len(rows), 6)
    assert torch.equal(w[..., :3], out.net_contact_force[:, rows])
    assert torch.equal(w[..., 3:], out.net_contact_torque[:, rows])
    hit = w[:, 0, :3].norm(dim=-1) > 1.0
    assert hit.sum() > 16 and bool((w[hit, 0, 3:].norm(dim=-1) > 1e-3).all())


def test_step_matches_the_jax_step(k2tau):
    """The port's simulator step on the sensor scene (plain K2-tau and the
    writeback into net_contact_force and net_contact_torque) against the JAX
    package's fused step (``_step_batched_pallas``: the Pallas K2-tau and its
    writeback, ``simulator.py:710-733``) on the same strike states: the
    force and torque at every body, over the envs whose contact pattern
    agrees (``tests/test_force_torque.py:61`` holds the JAX fused step to its
    XLA step so)."""
    psim, _, _, jsim = k2tau
    state, tgt = scripted.strike_state(psim, "paddle_ball", B, np.random.RandomState(70))
    eff = torch.zeros_like(tgt)
    got = psim.step(state, tgt, eff)
    jstate = jsim.initial_state(B)._replace(
        **{f: jnp.asarray(getattr(state, f).numpy()) for f in state._fields})
    want = jsim._step_batched_pallas(jstate, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    ncf_w, tq_w = np.asarray(want.net_contact_force), np.asarray(want.net_contact_torque)
    same = np.all((np.abs(got.net_contact_force.numpy()) > 0) == (np.abs(ncf_w) > 0), axis=(1, 2))
    assert same.mean() >= 0.99
    assert np.abs(tq_w[same]).max() > 1e-2            # the strikes' moments are there
    np.testing.assert_allclose(got.net_contact_force.numpy()[same], ncf_w[same], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got.net_contact_torque.numpy()[same], tq_w[same], rtol=0,
                               atol=1e-3)
    # a state carried across carries the torque field too
    back = sim_state_from_numpy({f: np.asarray(getattr(want, f)) for f in want._fields})
    assert torch.equal(back.net_contact_torque, torch.as_tensor(tq_w))


def test_sensor_registrations_carry_across():
    """A JAX asset's sensors register on the port's asset of the same model."""
    cfg = load_task_config(TASK)
    jtree = _jax_sensor_scene(cfg).spec.actors[0].tree
    from isaacgym_tpu_torch.tasks.pingpong_common import load_tree
    ptree = load_tree(cfg["env"]["asset"]["assetFileName"])
    assert copy_force_sensors(jtree, ptree) == 1
    from isaacgym_tpu_torch.sim import asset_api as A
    assert A.get_asset_force_sensor_count(ptree) == 1
    assert ptree._force_sensors == jtree._force_sensors
    with pytest.raises(ValueError, match="bodies differ"):
        copy_force_sensors(jtree, scripted.ToyEnv(DRIVE_POS).scene.spec.actors[0].tree)
