"""K4 and K4-tau as one warp per env: the g++ host build of
``csrc/fused_substep_floating.cuh`` runs the warp's 32 lanes of every phase
one after another, the card's own schedule (``csrc/fused_substep_host.cpp``).

- The host build, lanes in order, against the plain version on the biped
  sets and at 8 envs on the C10 sets of
  ``tests/test_torch_fused_substep_floating.py`` (its stand, strike, fall
  and table; its rollout set's 30 env steps cost ~17 CPU-seconds and are
  left to that file), at that file's tolerances, flip-aware.
- K4-tau's moment rows on the strike sets (the biped's paddle sphere, C10's
  paddle sensor) against the plain version, at
  ``tests/test_torch_floating_torque.py``'s moment tolerances.
- The operation count (the bound's) on C10's strike set equals the count of
  the one-thread-per-env body this design replaced (commit a4fec81), read
  from that body's g++ build on the same inputs: lanes split the work and
  never repeat it.
- Each phase's lanes run in reverse give the same bits as in order: no phase
  reads what another lane of it writes. The float build (the dynamics' and
  the contacts' scratch overlaid in one union, as on the card) and the
  counting build (side by side) give the same bits too.
- More art-vs-static pairs than a warp has lanes (the biped on nine
  overlapping blocks, 36 pairs; C10's table set with its statics copied
  three times, 54): the pairs past the first chunk of 32 act, and the host
  build matches the plain version there, with the lanes in either order.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import (DRIVE_EFFORT, DRIVE_POS, ActorSpec, PlaneParams,
                                          SceneSpec, compile_scene)
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_fused_substep_floating import (B, C10, MAX_FLIP_RATE, SCENE_SETS, TOL,
                                                     _toy_spec, compare, toy_inputs)

C10_B = 8
#: K4's and K4-tau's operations on C10's strike set (8 envs,
#: ``scripted.k4_inputs(env, "strike", 8, RandomState(61))``; K4-tau with the
#: paddle sensor scene's pack), counted by the g++ build of the
#: one-thread-per-env body of commit a4fec81
#: (``igt_fused_substep_floating_count_ops``, ``..._tau_count_ops``)
PARENT_OPS = {"k4": 652_056, "k4tau": 652_722}
MOMENT_TOL = dict(geom_moments=1e-5, ball_moments=1e-7)
BIPED_KINDS = [k for ks in SCENE_SETS.values() for k in ks]


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    for nd in (4, 27):
        FF.check_library_layout(lib, nd)
    return lib


def run_host(host, consts, ins, with_torque=False, reverse=False, count=False):
    """The host build on numpy inputs -> (outputs, operation count or None)."""
    nd = ins[0].shape[1]
    x = FF.pack_inputs(*[torch.as_tensor(a) for a in ins])
    c = torch.as_tensor(consts)
    y = torch.zeros((FF.n_out(nd, int(consts[FF.C_NART]), with_torque), x.shape[1]))
    args = (c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], nd)
    ops = None
    if count:
        fn = (host.igt_fused_substep_floating_tau_count_ops if with_torque
              else host.igt_fused_substep_floating_count_ops)
        ops = fn(*args)
    elif reverse:
        assert host.igt_fused_substep_floating_reversed_host(*args, int(with_torque)) == 0
    else:
        fn = (host.igt_fused_substep_floating_tau_host if with_torque
              else host.igt_fused_substep_floating_host)
        assert fn(*args) == 0
    return FF.unpack_outputs(y, nd), ops


def _np(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def _assert_close(got, want, what):
    dev, flip_rate = compare(got, want)
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{what}: {f} deviates {dev[f]:.3e} > {tol}"
    assert flip_rate <= MAX_FLIP_RATE, f"{what}: flip rate {flip_rate}"


@pytest.fixture(scope="module")
def biped():
    """kind -> (K4, K4-tau, inputs) on the biped sets."""
    out = {}
    for scene, kinds in SCENE_SETS.items():
        drive = DRIVE_EFFORT if scene == "effort" else DRIVE_POS
        ps = Simulator(compile_scene(_toy_spec(U, K, ActorSpec, PlaneParams, SceneSpec, scene,
                                               drive)), device="cpu")
        tau = FF.FusedSubstepFloating(ps.constants, with_torque=True)
        for i, kind in enumerate(kinds):
            out[kind] = (ps.fused_substep_floating, tau,
                         toy_inputs(ps, kind, np.random.RandomState(40 + i)))
    return out


@pytest.fixture(scope="module")
def c10():
    """kind -> (K4, K4-tau of the paddle sensor scene, inputs) on C10's sets."""
    out = {}
    for raised in (False, True):
        cfg = load_task_config(C10)
        if raised:
            cfg = scripted.raised_table_cfg(cfg)
        env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=C10_B, device="cpu", cfg=cfg)
        tau = Simulator(scripted.paddle_sensor_scene(cfg, floating_base=True), device="cpu")
        for i, kind in enumerate(("table",) if raised else ("stand", "strike", "fall")):
            ins = scripted.k4_inputs(env, kind, C10_B, np.random.RandomState(60 + i + 10 * raised))
            out[kind] = (env.sim.fused_substep_floating, tau.fused_substep_floating, ins)
    return out


@pytest.mark.parametrize("kind", BIPED_KINDS)
def test_warp_body_matches_the_plain_version_on_the_biped(biped, host, kind):
    k, _, ins = biped[kind]
    got, _ = run_host(host, k.consts, ins)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(a) for a in ins])
    _assert_close(_np(got), _np(want), kind)


@pytest.mark.parametrize("kind", scripted.K4_KINDS)
def test_warp_body_matches_the_plain_version_on_c10(c10, host, kind):
    k, _, ins = c10[kind]
    got, _ = run_host(host, k.consts, ins)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(a) for a in ins])
    _assert_close(_np(got), _np(want), kind)


def _moments(out, ng):
    imp = out.impulses.numpy()
    return imp[:, :ng + 1], {"geom_moments": imp[:, ng + 1:2 * ng + 1],
                             "ball_moments": imp[:, 2 * ng + 1:]}


def _assert_tau_close(got, want, ng, what):
    """K4-tau's outputs: the moment rows within the moment tolerances over
    the envs without a flip, every other output as K4's; -> the moment rows."""
    forces, mom = _moments(got, ng)
    forces_w, mom_w = _moments(want, ng)
    flags = lambda imp: np.abs(imp).sum(-1) > 0
    keep = ~np.any(flags(forces) != flags(forces_w), axis=1)
    assert 1.0 - keep.mean() <= MAX_FLIP_RATE
    for f, tol in MOMENT_TOL.items():
        d = float(np.abs(mom[f] - mom_w[f]).reshape(len(keep), -1)[keep].max())
        assert d <= tol, f"{what}: {f} deviates {d:.3e} > {tol}"
    _assert_close({**_np(got), "impulses": forces}, {**_np(want), "impulses": forces_w}, what)
    return mom


@pytest.mark.parametrize("scene", ["biped", "c10"])
def test_k4tau_moment_rows_on_the_strike_set(biped, c10, host, scene):
    """K4-tau's host build on the strike set: its moment rows within the
    moment tolerances of the plain K4-tau's, every other output as K4's
    tolerances, and the strikes reach the geom and ball moment rows."""
    _, k, ins = (biped if scene == "biped" else c10)["strike"]
    got, _ = run_host(host, k.consts, ins, with_torque=True)
    want = FF.floating_substep_plain(k.consts, *[torch.as_tensor(a) for a in ins],
                                     with_torque=True)
    mom = _assert_tau_close(got, want, k.ng, scene)
    assert (np.abs(mom["geom_moments"]).sum(-1) > 0).any(1).mean() > 0.3
    assert (np.abs(mom["ball_moments"]).sum(-1) > 0).any(1).mean() > 0.3


@pytest.mark.parametrize("kernel", ["k4", "k4tau"])
def test_operation_count_equals_the_one_thread_body(c10, host, kernel):
    k4, k4tau, ins = c10["strike"]
    k = k4tau if kernel == "k4tau" else k4
    _, ops = run_host(host, k.consts, ins, with_torque=kernel == "k4tau", count=True)
    assert ops == PARENT_OPS[kernel]


CASES = [("biped", kind) for kind in ("strike", "block", "ground")] + \
    [("c10", kind) for kind in scripted.K4_KINDS]


@pytest.mark.parametrize("with_torque", [False, True])
@pytest.mark.parametrize("scene,kind", CASES)
def test_lanes_in_reverse_give_the_same_bits(biped, c10, host, scene, kind, with_torque):
    k4, k4tau, ins = (biped if scene == "biped" else c10)[kind]
    k = k4tau if with_torque else k4
    fwd, _ = run_host(host, k.consts, ins, with_torque)
    rev, _ = run_host(host, k.consts, ins, with_torque, reverse=True)
    counted, _ = run_host(host, k.consts, ins, with_torque, count=True)
    for f in fwd._fields:
        assert torch.equal(getattr(rev, f), getattr(fwd, f)), f"reversed lanes: {f}"
        assert torch.equal(getattr(counted, f), getattr(fwd, f)), f"counting build: {f}"
    assert all(torch.isfinite(getattr(fwd, f)).all() for f in fwd._fields)


#: the statics' copies of the wide scenes, world offsets (m): the biped's
#: block eight times, each a little higher; C10's slab and net twice
SHIFTS = {"biped": [(0.01 * j, -0.01 * j, 0.001 * j) for j in range(1, 9)],
          "c10": [(0.01 * j, -0.01 * j, -0.001 * j) for j in (1, 2)]}


@pytest.fixture(scope="module")
def wide(biped, c10):
    """scene -> (K4's pack, K4-tau's pack, inputs) with more art-vs-static
    pairs than a warp has lanes: the block set (biped) and the table set
    (C10) with their statics copied (``scripted.with_static_copies``)."""
    return {scene: tuple(scripted.with_static_copies(k.consts, SHIFTS[scene])
                         for k in (k4, k4tau)) + (ins,)
            for scene, (k4, k4tau, ins) in (("biped", biped["block"]), ("c10", c10["table"]))}


@pytest.mark.parametrize("with_torque", [False, True])
@pytest.mark.parametrize("scene", ["biped", "c10"])
def test_more_pairs_than_a_warp(wide, host, scene, with_torque):
    """The pairs are narrowphased a chunk of 32 at a time, one lane each: on
    a pack with more pairs, the pairs past the first chunk change the
    step, and the host build matches the plain version with the lanes of
    every phase in order and gives the same bits with them in reverse."""
    consts, ins = wide[scene][int(with_torque)], wide[scene][2]
    t = [torch.as_tensor(a) for a in ins]
    assert int(consts[FF.C_NPAIR]) > 32
    want = FF.floating_substep_plain(consts, *t, with_torque=with_torque)
    first_chunk = consts.copy()
    first_chunk[FF.C_NPAIR] = 32
    assert not torch.equal(want.qd_new, FF.floating_substep_plain(
        first_chunk, *t, with_torque=with_torque).qd_new)
    got, _ = run_host(host, consts, ins, with_torque)
    if with_torque:
        _assert_tau_close(got, want, int(consts[FF.C_NART]), scene)
    else:
        _assert_close(_np(got), _np(want), scene)
    rev, _ = run_host(host, consts, ins, with_torque, reverse=True)
    for f in got._fields:
        assert torch.equal(getattr(rev, f), getattr(got, f)), f"reversed lanes: {f}"
