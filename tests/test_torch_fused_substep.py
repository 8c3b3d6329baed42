"""K2 and K2-dr (the fused substep, without and with domain randomization):
the port's plain version against the JAX package's ``build_fused_substep``
(Pallas, interpret mode on the CPU, built through
``Simulator._maybe_build_pallas(force=True)``, ``with_dr`` False and True),
and the kernel's own per-env body (``csrc/fused_substep.cuh`` compiled by g++
into a host loop) against the plain version. B = 128, one substep, from the
state sets that ``chip_smoke.py`` uses on the card:

  reset         reset states with launched balls
  rollout       states after 60 env steps under uniform actions
  paddle_ball   the paddle in front of an incoming ball
  paddle_table  the paddle pressed into the table slab (raised-table scene)
  ball_rest     the ball resting on the table

Tolerances, over envs whose contact pattern agrees (no flip): 1e-4 on q,
ball pos and ball vel; 1e-3 on qd, tau and impulses (qd and the impulses go
through a 7x7 Cholesky solve of a mass matrix whose entries span ~4 orders of
magnitude, which amplifies float32 rounding-order differences); flip rate at
most 0.2 %. The arithmetic is the same formula in the same order, so the
deviations measured are ~1e-5 and no flips.

K2-dr is fed a randomization channel at full strength (every scheduled term
of the flagship spec past its 3000-step ramp), drawn with numpy from the
spec's ranges: at strength 0 the channel is the identity and K2-dr would be
held against K2's arithmetic only. K2-dr is compared with the Pallas
``with_dr`` kernel, and its host body with the plain version, on all five
sets; paddle_table is the set whose paddle-table contacts go through the
mass-scaled reactions. With an identity channel K2-dr reproduces K2 to 1e-6: the only
difference is that it forms the combined restitution and friction of the
randomized geoms in float32 at run time.
"""


import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 128
KINDS = ("reset", "rollout", "paddle_ball", "paddle_table", "ball_rest")
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3)
MAX_FLIP_RATE = 0.002


def _rollout_inputs(env, rng, steps=60):
    state, _ = env.reset()
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1, 1, (B, 7)).astype(np.float32))
        state, *_ = env.step(state, a)
    a = torch.as_tensor(rng.uniform(-1, 1, (B, 7)).astype(np.float32))
    tgt, eff = env.action_to_drive(a)
    s = state.sim
    return tuple(np.ascontiguousarray(t.numpy(), dtype=np.float32) for t in (
        s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 2, 0:3], s.root[:, 2, 7:10],
        s.root[:, 2, 10:13]))


def full_strength_dr(spec, nd, rng):
    """(B, 4 nd + 6) channel at full strength, drawn from the spec's ranges
    in the JAX package's order (kp, kd, lower, upper, mass, gravity offset,
    friction, restitution); gravity noise on z only."""
    hum = next(iter(spec["actor_params"].values()))
    dp, rs = hum["dof_properties"], hum["rigid_shape_properties"]
    u = lambda r, *shape: rng.uniform(r[0], r[1], (B,) + shape)
    grav = np.zeros((B, 3))
    grav[:, 2] = rng.standard_normal(B) * spec["sim_params"]["gravity"]["range"][1]
    chan = np.concatenate([
        u(dp["stiffness"]["range"], nd), u(dp["damping"]["range"], nd),
        rng.standard_normal((B, nd)) * dp["lower"]["range"][1],
        rng.standard_normal((B, nd)) * dp["upper"]["range"][1],
        u(hum["rigid_body_properties"]["mass"]["range"], 1), grav,
        u(rs["friction"]["range"], 1), u(rs["restitution"]["range"], 1)], axis=1)
    return chan.astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    """kind -> (port env, inputs, JAX Pallas K2 outputs, DR channel, JAX
    Pallas K2-dr outputs), all numpy."""
    cfg_raised = scripted.raised_table_cfg(load_task_config(TASK))
    out = {}
    built = {}
    for raised in (False, True):
        cfg = cfg_raised if raised else load_task_config(TASK)
        je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=B, cfg=cfg)
        je.sim._maybe_build_pallas(force=True)
        pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=cfg)
        built[raised] = (je, pe)
    spec = load_task_config(TASK)["task"]["randomization_params"]
    for i, kind in enumerate(KINDS):
        raised = kind == "paddle_table"
        je, pe = built[raised]
        rng = np.random.RandomState(100 + i)
        ins = (_rollout_inputs(pe, rng) if kind == "rollout"
               else scripted.k2_inputs(pe, kind, B, rng))
        oj = je.sim._fused(*[jnp.asarray(x) for x in ins])
        chan = full_strength_dr(spec, 7, rng)
        oj_dr = je.sim._fused_dr(*[jnp.asarray(x) for x in ins], dr_chan=jnp.asarray(chan))
        dr_want = {f: np.asarray(getattr(oj_dr, f)) for f in oj_dr._fields}
        out[kind] = (pe, ins, {f: np.asarray(getattr(oj, f)) for f in oj._fields},
                     chan, dr_want)
    return out


def _np_out(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def _flags(imp):
    """Per env and impulse row: did any contact act."""
    return np.abs(imp).sum(-1) > 0


def compare(a, b):
    """Max deviation per output over no-flip envs, and the flip rate."""
    flip = np.any(_flags(a["impulses"]) != _flags(b["impulses"]), axis=1)
    keep = ~flip
    dev = {f: float(np.abs(a[f] - b[f]).reshape(len(keep), -1)[keep].max())
           for f in TOL}
    return dev, float(flip.mean())


def _assert_close(a, b, what):
    dev, flip_rate = compare(a, b)
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{what}: {f} deviates {dev[f]:.3e} > {tol}"
    assert flip_rate <= MAX_FLIP_RATE, f"{what}: flip rate {flip_rate}"


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_kernel(cases, kind):
    pe, ins, want = cases[kind][:3]
    got = pe.sim.fused_substep(*[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_dr_matches_pallas_dr_kernel(cases, kind):
    pe, ins, _, chan, want = cases[kind]
    got = pe.sim.fused_substep_dr(*[torch.as_tensor(x) for x in ins], torch.as_tensor(chan))
    got = _np_out(got)
    _assert_close(got, want, f"dr/{kind}")
    assert compare(got, want)[1] == 0.0   # no flips at all


def test_full_strength_dr_changes_the_step(cases):
    """The channel acts: torques, joint velocities and the ball's flight all
    move away from K2's at full strength."""
    pe, ins, _, chan, _ = cases["rollout"]
    t = [torch.as_tensor(x) for x in ins]
    k2, k2dr = _np_out(pe.sim.fused_substep(*t)), _np_out(pe.sim.fused_substep_dr(
        *t, torch.as_tensor(chan)))
    for f in ("tau", "qd_new", "ball_vel"):
        assert np.abs(k2dr[f] - k2[f]).max() > 1e-3, f


def _identity_chan(nd=7):
    return torch.cat([torch.ones(B, 2 * nd), torch.zeros(B, 2 * nd), torch.ones(B, 1),
                      torch.zeros(B, 3), torch.ones(B, 2)], dim=1)


@pytest.mark.parametrize("kind", KINDS)
def test_identity_channel_reproduces_k2(cases, kind):
    pe, ins = cases[kind][:2]
    t = [torch.as_tensor(x) for x in ins]
    a = _np_out(pe.sim.fused_substep_dr(*t, _identity_chan()))
    b = _np_out(pe.sim.fused_substep(*t))
    for f in a:
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-6, err_msg=f)


def test_state_sets_exercise_every_contact_kind(cases):
    """The sets reach what they are for: paddle-ball, art-vs-static (with
    some contacts in the 2 mm band) and ball-on-table contacts."""
    imp = {k: _flags(v[2]["impulses"]) for k, v in cases.items()}
    assert imp["paddle_ball"][:, 1].mean() > 0.3          # paddle row
    assert imp["paddle_table"][:, :2].any(1).mean() > 0.3  # art-vs-static rows
    assert imp["ball_rest"][:, 2].mean() > 0.9            # ball total row
    assert not imp["reset"].any()


@pytest.fixture(scope="module")
def host_lib():
    lib = _build.build_host_library()
    F.check_library_layout(lib, 7)
    return lib


def _run_host(lib, pe, ins, fn="igt_fused_substep_host", chan=None):
    extra = () if chan is None else (torch.as_tensor(chan),)
    x = F.pack_inputs(*[torch.as_tensor(a) for a in ins], *extra)
    y = torch.empty((F.n_out(7, pe.sim.fused_substep.ng), B), dtype=torch.float32)
    c = torch.as_tensor(pe.sim.constants)
    ret = getattr(lib, fn)(c.data_ptr(), x.data_ptr(), y.data_ptr(), B, 7)
    return ret, F.unpack_outputs(y, 7, pe.sim.fused_substep.ng)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_body_matches_plain(cases, host_lib, kind):
    pe, ins = cases[kind][:2]
    ret, got = _run_host(host_lib, pe, ins)
    assert ret == 0
    want = pe.sim.fused_substep(*[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), _np_out(want), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_dr_kernel_body_matches_plain(cases, host_lib, kind):
    pe, ins, _, chan, _ = cases[kind]
    ret, got = _run_host(host_lib, pe, ins, "igt_fused_substep_dr_host", chan)
    assert ret == 0
    want = pe.sim.fused_substep_dr(*[torch.as_tensor(x) for x in ins], torch.as_tensor(chan))
    _assert_close(_np_out(got), _np_out(want), f"dr/{kind}")
    ops, counted = _run_host(host_lib, pe, ins, "igt_fused_substep_dr_count_ops", chan)
    assert 5000 * B < ops < 50000 * B
    for f in got._fields:
        torch.testing.assert_close(getattr(counted, f), getattr(got, f), rtol=0, atol=0)


def test_operation_count_runs_the_same_body(cases, host_lib):
    pe, ins = cases["paddle_ball"][:2]
    ops, counted = _run_host(host_lib, pe, ins, "igt_fused_substep_count_ops")
    _, plain = _run_host(host_lib, pe, ins)
    for f in plain._fields:
        torch.testing.assert_close(getattr(counted, f), getattr(plain, f), rtol=0, atol=0)
    # dynamics alone are several thousand operations per env
    assert 5000 * B < ops < 50000 * B
    idle_ops, _ = _run_host(host_lib, *cases["reset"][:2], "igt_fused_substep_count_ops")
    assert idle_ops < ops   # skipped contact resolution is not counted


def test_layout_check_rejects_a_mismatch(host_lib, monkeypatch):
    monkeypatch.setattr(F, "MAX_PAIRS", F.MAX_PAIRS + 1)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        F.check_library_layout(host_lib, 7)
