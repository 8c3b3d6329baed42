"""K4 (the fused substep of a floating-base humanoid with one ball): the
port's plain version against the JAX package's ``build_fused_substep_floating``
(Pallas, interpret mode on the CPU, built through
``Simulator._maybe_build_pallas(force=True)``) on a 4-DOF floating biped, and
against the JAX package's XLA substep (``Simulator._substep``) on the 27-DOF
C10 scene; the kernel's own per-env body (``csrc/fused_substep_floating.cuh``
compiled by g++ into a host loop) against the plain version on both.

The biped and the block are the JAX package's floating-kernel test scenes
(``tests/test_pallas_floating.py:34-113``, ``:312-334``), copied here. Its
sets, B = 128 each, one substep from the same inputs:

  pd       PD drive, the feet within 2 cm of the ground, random joint and
           base velocities
  effort   effort drive (a scene built with drive mode 1), random efforts
  ground   tilted and falling onto the ground
  clamp    in the air, the arm slammed toward a far target from near its
           velocity limit
  strike   the ball heading into the paddle sphere
  block    standing on the static block (art-vs-static), feet within 2 cm

Tolerances, over envs whose contact pattern (the impulse rows) agrees, as
K2's CPU tests hold K2: 1e-4 on q, the base pose and the ball's position
and velocity; 1e-3 on qd, tau, the base's velocities, the ball's spin and
the impulses (a Cholesky solve amplifies float32 rounding-order
differences); flip rate at most 0.2 %. A 20-step rollout of the port's
simulator against the JAX package's fused step on the biped is held at the
tolerances of ``test_floating_fused_matches_xla`` (``:121-160``).

The Pallas K4 at 27 DOFs takes about an hour of XLA compile in interpret
mode, so on C10 the plain version is held against the XLA substep instead,
at 8 envs on the sets ``chip_smoke.py`` uses on the card (stand, strike,
fall, table, and states after 30 env steps under random actions), flip-aware
on the net-contact-force rows: 1e-4 on DOF positions, 1e-3 on DOF
velocities, DOF forces and roots (base and ball), 1e-2 N on the net contact
forces (~300 N at the table), flip rate at most the C10 parity row's 25 %.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.sim.scene import ActorSpec as JActorSpec
from isaacgym_tpu.sim.scene import PlaneParams as JPlaneParams
from isaacgym_tpu.sim.scene import SceneSpec as JSceneSpec
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu_torch.interop import sim_state_from_numpy
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import fk_dof_frames
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import (DRIVE_EFFORT, DRIVE_POS, ActorSpec, PlaneParams,
                                          SceneSpec, compile_scene)
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.utils import rotations as rot
from isaacgym_tpu_torch.utils.config import load_task_config

B = 128
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
TOL = dict(q_new=1e-4, base_pos=1e-4, base_quat=1e-4, ball_pos=1e-4, ball_vel=1e-4,
           qd_new=1e-3, tau=1e-3, base_linvel=1e-3, base_angvel=1e-3, ball_omega=1e-3,
           impulses=1e-3)
MAX_FLIP_RATE = 0.002
C10_TOL = dict(dof_pos=1e-4, dof_vel=1e-3, dof_force=1e-3, root=1e-3, net_contact_force=1e-2)
C10_MAX_FLIP_RATE = 0.25

# 4-DOF floating biped: torso + two 1-DOF legs with sphere feet + a 2-DOF
# arm with a sphere "paddle". Feet rest on the ground at base z=0.72.
TOY_URDF = scripted.TOY_BIPED_URDF

BALL_URDF = """
<robot name="ball">
  <link name="ball">
    <inertial><origin xyz="0 0 0"/><mass value="0.0027"/>
      <inertia ixx="7.2e-7" iyy="7.2e-7" izz="7.2e-7" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/>
      <geometry><sphere radius="0.02"/></geometry></collision>
  </link>
</robot>
"""

BLOCK_URDF = """
<robot name="block">
  <link name="block">
    <inertial><mass value="10"/><inertia ixx="1" iyy="1" izz="1" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><box size="1.4 1.4 0.5"/></geometry></collision>
  </link>
</robot>
"""

SCENE_SETS = {"toy": ("pd", "ground", "clamp", "strike"), "effort": ("effort",),
              "block": ("block",)}


def _toy_spec(u, k, actor, plane, spec, scene: str, drive_mode: int):
    """The biped (on the block for ``block``) and the ball, in one package's
    classes (``u``, ``k``: its urdf and kinematics modules)."""
    parse = lambda text: u.parse_urdf(text, from_string=True)
    biped = k.compile_tree(parse(TOY_URDF), floating_base=True)
    kp = np.full(4, 40.0, np.float32)
    on_block = scene == "block"
    actors = [actor("biped", biped, pos=(0, 0, 1.6 if on_block else 0.72), fixed_base=False,
                    restitution=0.3 if on_block else 0.5, friction=0.6, stiffness=kp,
                    damping=kp / 20, drive_mode=drive_mode)]
    if on_block:
        actors.append(actor("block", k.compile_tree(parse(BLOCK_URDF)), pos=(0, 0, 0.25),
                            fixed_base=True, restitution=0.1, friction=0.8))
    actors.append(actor("ball", k.compile_tree(parse(BALL_URDF)), pos=(1.5, 0.05, 1.0),
                        fixed_base=False, restitution=1.3, friction=0.2))
    return spec(actors=actors, plane=plane(), dt=1 / 120, substeps=2)


def toy_sims(scene: str):
    """(JAX simulator with its Pallas K4, the port's simulator on the CPU)."""
    drive = DRIVE_EFFORT if scene == "effort" else DRIVE_POS
    js = JSimulator(jax_compile_scene(_toy_spec(JU, JK, JActorSpec, JPlaneParams, JSceneSpec,
                                                scene, drive)))
    js._maybe_build_pallas(force=True)
    ps = Simulator(compile_scene(_toy_spec(U, K, ActorSpec, PlaneParams, SceneSpec, scene,
                                           drive)), device="cpu")
    return js, ps


def toy_inputs(sim: Simulator, kind: str, rng: np.random.RandomState):
    """K4's eleven inputs for the biped set ``kind``."""
    nd = 4
    init = sim.scene.initial_root[0].astype(np.float64)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    q = rng.uniform(-0.3, 0.3, (B, nd))
    qd = rng.uniform(-1.0, 1.0, (B, nd))
    tgt = rng.uniform(-0.5, 0.5, (B, nd))
    eff = np.zeros((B, nd))
    bp = np.broadcast_to(init[0:3], (B, 3)).copy()
    bp[:, 2] -= rng.uniform(0.0, 0.02, B)
    bq = np.broadcast_to(init[3:7], (B, 4)).copy()
    blv, bav = rng.uniform(-0.5, 0.5, (B, 3)), rng.uniform(-0.5, 0.5, (B, 3))
    pos = np.broadcast_to([5.0, 5.0, 5.0], (B, 3)).copy()
    vel, omg = np.zeros((B, 3)), np.zeros((B, 3))
    if kind == "effort":
        tgt, eff = np.zeros((B, nd)), rng.uniform(-40.0, 40.0, (B, nd))
    elif kind == "ground":
        ang = rng.uniform(0.2, 1.2, B)
        yaw = rng.uniform(0.0, 2 * np.pi, B)
        bq = np.stack([np.cos(yaw) * np.sin(ang / 2), np.sin(yaw) * np.sin(ang / 2),
                       np.zeros(B), np.cos(ang / 2)], 1)
        bp[:, 2] = rng.uniform(0.2, 0.6, B)
        blv[:, 2] = rng.uniform(-3.0, -0.5, B)
    elif kind == "clamp":   # in the air: no contact acts after the clamp
        tgt = np.full((B, nd), 2.0)
        bp[:, 2] = 2.0
        qd[:, 2:] = rng.uniform(15.0, 20.0, (B, 2))
    elif kind == "strike":
        fp, fq = fk_dof_frames(sim.scene.articulations[0].model.tree,
                               torch.as_tensor(f(bp)), torch.as_tensor(f(bq)),
                               torch.as_tensor(f(q)))
        center = (fp[:, 3] + rot.quat_rotate(fq[:, 3], torch.tensor([[0.18, 0.0, 0.0]])
                                             .expand(B, 3))).numpy()
        nrm = rng.normal(size=(B, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        pos = center + nrm * (0.09 + 0.02 + rng.uniform(-0.004, 0.03, (B, 1)))
        vel = -nrm * rng.uniform(1.0, 8.0, (B, 1)) + rng.normal(0.0, 1.0, (B, 3))
        omg = rng.uniform(-20.0, 20.0, (B, 3))
    elif kind == "block":
        bp[:, 2] = 0.5 + 0.72 - rng.uniform(0.0, 0.02, B)
        blv[:, 2] = rng.uniform(-1.0, 0.0, B)
    return tuple(map(f, (q, qd, tgt, eff, bp, bq, blv, bav, pos, vel, omg)))


@pytest.fixture(scope="module")
def toy_cases():
    """kind -> (port simulator, inputs, JAX Pallas K4 outputs), numpy; one
    Pallas call per scene over all its sets."""
    out = {}
    for scene, kinds in SCENE_SETS.items():
        js, ps = toy_sims(scene)
        ins = [toy_inputs(ps, kind, np.random.RandomState(40 + i)) for i, kind in
               enumerate(kinds)]
        cat = [np.concatenate(parts) for parts in zip(*ins)]
        oj = js._fused_floating(*[jnp.asarray(x) for x in cat])
        for i, kind in enumerate(kinds):
            want = {f: np.asarray(getattr(oj, f))[i * B:(i + 1) * B] for f in oj._fields}
            out[kind] = (ps, ins[i], want)
    return out


def _np_out(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def compare(a, b):
    """Max deviation per output over no-flip envs, and the flip rate."""
    flags = lambda imp: np.abs(imp).sum(-1) > 0
    keep = ~np.any(flags(a["impulses"]) != flags(b["impulses"]), axis=1)
    dev = {f: float(np.abs(a[f] - b[f]).reshape(len(keep), -1)[keep].max()) for f in TOL}
    return dev, float(1.0 - keep.mean())


def _assert_close(a, b, what):
    dev, flip_rate = compare(a, b)
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{what}: {f} deviates {dev[f]:.3e} > {tol}"
    assert flip_rate <= MAX_FLIP_RATE, f"{what}: flip rate {flip_rate}"


KINDS = [k for ks in SCENE_SETS.values() for k in ks]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_the_pallas_kernel_on_the_biped(toy_cases, kind):
    ps, ins, want = toy_cases[kind]
    got = ps.fused_substep_floating(*[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), want, kind)


def test_the_biped_sets_reach_their_phases(toy_cases):
    """Each set exercises what it is named for, on both sides."""
    rows = lambda kind: np.abs(toy_cases[kind][2]["impulses"]).sum(-1) > 0   # (B, ng + 1)
    # the paddle sphere is the last articulated geom; the block pairs with
    # every geom; the ball misses everything in the sets without a strike
    assert rows("strike")[:, 3].mean() > 0.3
    assert rows("block")[:, :4].any(1).mean() > 0.5
    assert not rows("pd")[:, -1].any() and not rows("clamp")[:, -1].any()
    # ground support lifts the falling sets: the base's z velocity goes up
    ps, ins, want = toy_cases["ground"]
    assert (want["base_linvel"][:, 2] > ins[6][:, 2] + 1e-3).mean() > 0.3
    # the clamp binds: |qd| of the arm at its 20 rad/s limit
    qd = np.abs(toy_cases["clamp"][2]["qd_new"][:, 2:])
    assert np.isclose(qd, 20.0, atol=1e-4).any() and qd.max() <= 20.0 + 1e-4
    # effort drive applies the clamped efforts as the torques
    ps, ins, want = toy_cases["effort"]
    np.testing.assert_array_equal(want["tau"], np.clip(ins[3], -ps.slot.model.tree.effort,
                                                       ps.slot.model.tree.effort))


def _host_run(host, consts, ins):
    nd = ins[0].shape[1]
    x = FF.pack_inputs(*[torch.as_tensor(a) for a in ins])
    c = torch.as_tensor(consts)
    y = torch.zeros((FF.n_out(nd, int(consts[FF.C_NART])), x.shape[1]))
    assert host.igt_fused_substep_floating_host(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                                                x.shape[1], nd) == 0
    ops = host.igt_fused_substep_floating_count_ops(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                                                    x.shape[1], nd)
    return FF.unpack_outputs(y, nd), ops


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    FF.check_library_layout(lib, 4)
    FF.check_library_layout(lib, 27)
    return lib


@pytest.mark.parametrize("kind", KINDS)
def test_host_body_matches_the_plain_version_on_the_biped(toy_cases, host, kind):
    ps, ins, _ = toy_cases[kind]
    k = ps.fused_substep_floating
    got, ops = _host_run(host, k.consts, ins)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), _np_out(want), kind)
    assert ops > 1000 * B


def test_rollout_matches_the_jax_fused_step():
    """20 env steps (40 substeps) of free fall onto the ground, PD hold and
    the ball's approach: the port's simulator (the plain K4) against the JAX
    package's fused step, at ``test_floating_fused_matches_xla``'s
    tolerances."""
    js, ps = toy_sims("toy")
    rng = np.random.RandomState(0)
    nd = 4
    tgt = rng.uniform(-0.2, 0.2, (B, nd)).astype(np.float32)
    eff = np.zeros((B, nd), np.float32)
    ball = js.scene.free_bodies[0].actor_index
    sj = js.initial_state(B)
    sj = sj._replace(root=sj.root.at[:, ball, 7:10].set(jnp.asarray([-4.0, 0.0, 1.0])))
    sp = sim_state_from_numpy({f: np.asarray(getattr(sj, f)) for f in sj._fields})
    fused = jax.jit(js._step_batched_pallas)
    for _ in range(20):
        sj = fused(sj, jnp.asarray(tgt), jnp.asarray(eff))
        sp = ps.step(sp, torch.as_tensor(tgt), torch.as_tensor(eff))
    hum = ps.scene.articulations[0].actor_index
    a, b = sp.root.numpy(), np.asarray(sj.root)
    np.testing.assert_allclose(sp.dof_pos.numpy(), np.asarray(sj.dof_pos), atol=1e-2)
    np.testing.assert_allclose(a[:, hum, 0:3], b[:, hum, 0:3], atol=1e-2)
    np.testing.assert_allclose(a[:, hum, 3:7], b[:, hum, 3:7], atol=1e-2)
    np.testing.assert_allclose(a[:, hum, 7:13], b[:, hum, 7:13], atol=2e-1)
    np.testing.assert_allclose(a[:, ball, 0:3], b[:, ball, 0:3], atol=5e-2)
    assert np.isfinite(sp.net_contact_force.numpy()).all()
    # ground support on both sides: the biped has not free-fallen
    assert (a[:, hum, 2] > 0.72 - 0.15).all()


# ------------------------------------------------------------------ C10 --

C10_B = 8
C10_KINDS = scripted.K4_KINDS + ("rollout",)


def _c10_state(pe, ins):
    """A numpy ``SimState`` dict of the C10 scene from K4's eleven inputs."""
    q, qd, _, _, bp, bq, blv, bav, pos, vel, omg = ins
    scene = pe.scene
    ba = scene.free_bodies[0].actor_index
    root = np.repeat(scene.initial_root[None], len(q), 0)
    root[:, 0] = np.concatenate([bp, bq, blv, bav], 1)
    root[:, ba, 0:3], root[:, ba, 7:10], root[:, ba, 10:13] = pos, vel, omg
    z = np.zeros((len(q), scene.num_bodies, 3), np.float32)
    return dict(root=root.astype(np.float32), dof_pos=q, dof_vel=qd,
                dof_force=np.zeros_like(q), net_contact_force=z, net_contact_torque=z)


def c10_rollout_inputs(pe, steps, rng):
    """K4's inputs after ``steps`` env steps of ``pe`` from reset under
    uniform random actions (numpy-seeded)."""
    B_ = pe.num_envs
    state, _ = pe.reset()
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1, 1, (B_, 27)), dtype=torch.float32)
        state, *_ = pe.step(state, a)
    tgt, eff = pe.action_to_drive(torch.as_tensor(rng.uniform(-1, 1, (B_, 27)),
                                                  dtype=torch.float32))
    s = state.sim
    ba = pe.ball_actor
    return tuple(np.ascontiguousarray(t.numpy(), dtype=np.float32) for t in (
        s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 0, 0:3], s.root[:, 0, 3:7],
        s.root[:, 0, 7:10], s.root[:, 0, 10:13], s.root[:, ba, 0:3], s.root[:, ba, 7:10],
        s.root[:, ba, 10:13]))


@pytest.fixture(scope="module")
def c10_cases():
    """kind -> (port env, inputs, numpy SimState dict, JAX XLA substep
    output as numpy)."""
    out = {}
    for raised in (False, True):
        cfg = scripted.raised_table_cfg(load_task_config(C10)) if raised else \
            load_task_config(C10)
        je = isaacgym_tpu.make(seed=0, task=C10, num_envs=C10_B, cfg=cfg)
        pe = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=C10_B, device="cpu", cfg=cfg)
        dt_s = je.sim.dt / je.sim.substeps
        sub = jax.jit(jax.vmap(lambda s, t, e: je.sim._substep(s, t, e, dt_s)))
        kinds = ("table",) if raised else ("stand", "strike", "fall", "rollout")
        for i, kind in enumerate(kinds):
            rng = np.random.RandomState(60 + i + 10 * raised)
            ins = (c10_rollout_inputs(pe, 30, rng) if kind == "rollout"
                   else scripted.k4_inputs(pe, kind, C10_B, rng))
            d = _c10_state(pe, ins)
            sj = sub(je.sim.initial_state(C10_B)._replace(
                **{k_: jnp.asarray(v) for k_, v in d.items()}),
                jnp.asarray(ins[2]), jnp.asarray(ins[3]))
            out[kind] = (pe, ins, d, {f: np.asarray(getattr(sj, f)) for f in sj._fields})
    return out


@pytest.mark.parametrize("kind", C10_KINDS)
def test_plain_matches_the_xla_substep_on_c10(c10_cases, kind):
    pe, ins, d, want = c10_cases[kind]
    dt_s = pe.sim.dt / pe.sim.substeps
    got = pe.sim._substep_fused_floating(sim_state_from_numpy(d), torch.as_tensor(ins[2]),
                                         torch.as_tensor(ins[3]), dt_s)
    flags = lambda ncf: np.abs(ncf).sum(-1) > 0
    keep = ~np.any(flags(got.net_contact_force.numpy())
                   != flags(want["net_contact_force"]), axis=1)
    assert 1.0 - keep.mean() <= C10_MAX_FLIP_RATE, kind
    for f, tol in C10_TOL.items():
        dev = np.abs(getattr(got, f).numpy() - want[f]).reshape(C10_B, -1)[keep].max()
        assert dev <= tol, f"{kind}: {f} deviates {dev:.3e} > {tol}"


def test_the_c10_sets_reach_their_phases(c10_cases):
    """strike: the ball meets the paddle; table: the feet rest on the slab
    (art-vs-static rows); stand: the feet hold the humanoid up."""
    ncf = lambda kind: np.abs(c10_cases[kind][3]["net_contact_force"]).sum(-1) > 0
    pe = c10_cases["stand"][0]
    paddle = pe.scene.articulations[0].body_start + pe.PADDLE_BODY
    assert ncf("strike")[:, paddle].mean() > 0.3
    feet = pe.sim.art_bodies[[1, 3]]   # the two ankle-roll links' boxes
    assert ncf("table")[:, feet].any(1).mean() > 0.5
    # the feet at the activation margin slow the base's fall below gravity's
    pe_, ins, _, want = c10_cases["stand"]
    free_fall = ins[6][:, 2] - 9.81 * pe_.sim.dt / pe_.sim.substeps
    assert (want["root"][:, 0, 9] > free_fall + 1e-3).mean() >= 0.5


@pytest.mark.parametrize("kind", scripted.K4_KINDS)
def test_host_body_matches_the_plain_version_on_c10(c10_cases, host, kind):
    pe, ins, _, _ = c10_cases[kind]
    k = pe.sim.fused_substep_floating
    got, ops = _host_run(host, k.consts, ins)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), _np_out(want), kind)
    assert ops > 10000 * C10_B


def test_plain_version_runs_in_float64(c10_cases):
    """The plain version keeps the inputs' type: float64 in, float64 out,
    within float32 rounding of the float32 run."""
    pe, ins, _, _ = c10_cases["strike"]
    k = pe.sim.fused_substep_floating
    o32 = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x) for x in ins])
    o64 = FF.floating_substep_plain(k.consts, *[torch.as_tensor(x).double() for x in ins])
    assert all(getattr(o64, f).dtype == torch.float64 for f in o64._fields)
    _assert_close(_np_out(o32), {f: v.float().numpy() for f, v in o64._asdict().items()},
                  "f32 vs f64")


def test_wrapper_refuses_what_the_kernel_does_not_take(c10_cases):
    pe = c10_cases["stand"][0]
    k = pe.sim.fused_substep_floating
    good = [torch.zeros(4, w) for w in FF.input_widths(27)]
    with pytest.raises(ValueError, match="float32"):
        k(*[g.double() for g in good])
    with pytest.raises(ValueError, match="11 inputs"):
        k(*good[:10])
    with pytest.raises(ValueError, match="no kernel for device"):
        k(*[g.to("meta") for g in good])
    with pytest.raises(ValueError, match=r"\(130, B\)"):
        k.launch(torch.zeros(130, 4))   # a CPU buffer never reaches the kernel
    assert k.launches == 0 and FF.n_in(27) == 130
