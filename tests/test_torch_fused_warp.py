"""K1 and K2's four builds (K2, K2-dr, K2-tau, K2-dr-tau) as several envs
to a warp (K2: two, one on each half; K1: four): the g++ host build of
``csrc/arm_step.cuh`` and
``csrc/fused_substep_warp.cuh`` runs the warp's 32 lanes of every phase one
after another, the card's own schedule (``csrc/fused_substep_host.cpp``).

- The host build, lanes in order, against the plain version on the
  flagship's sets at 8 envs (``scripted.k2_inputs``; paddle_table on the
  raised-table scene), each build, at ``tests/test_torch_fused_substep.py``'s
  tolerances (the torque builds' moment rows at
  ``tests/test_torch_multi_warp.py``'s); K1 on ``tests/test_torch_arm_step.py``'s
  sets at its host tolerance.
- Each phase's lanes run in reverse give the same bits as in order, and so
  does the counting build (int32 views, so -0 and +0 differ).
- The operation count (the bound's) is pinned, and it stays below the count
  of the one-thread-per-env bodies this design replaced (commit 640a705),
  which formed I_l axw_j again for every mass-matrix entry and ran every
  contact test that the culls now skip.
- Halves that branch apart: a warp whose one env strikes the paddle and
  whose other does not, and one whose two static walks stop at different
  statics; each env's outputs equal that env run in a warp alone.
- An odd B: the last warp's idle groups run the last env again and write
  nothing of their own, so the B envs' outputs equal those of a run of
  B + 1, and the count is each env's own work.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import arm_step as A
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_arm_step import HOST_TOL
from tests.test_torch_arm_step import _inputs as k1_inputs
from tests.test_torch_fused_substep import TASK, TOL, compare, full_strength_dr
from tests.test_torch_multi_warp import MOMENT_TOL

B = 8
K1_B = 128   # tests/test_torch_arm_step.py's sets
#: (with_dr, with_torque) of each build
BUILDS = {"k2": (0, 0), "k2dr": (1, 0), "k2tau": (0, 1), "k2drtau": (1, 1)}
#: K2's builds' operations on the flagship's sets (8 envs,
#: ``scripted.k2_inputs(env, kind, 8, RandomState(71 + i))``; the DR builds
#: with ``full_strength_dr(spec, 7, RandomState(7))``), counted by
#: ``igt_fused_substep_count_ops`` (``..._dr_``, ``..._tau_``), in BUILDS'
#: order: NEEDED_OPS from this body, PARENT_OPS from the one-thread-per-env
#: body of commit 640a705
NEEDED_OPS = {"reset": (60_200, 61_064, 65_496, 66_360),
              "paddle_ball": (66_774, 67_678, 72_863, 73_767),
              "paddle_table": (62_748, 62_830, 68_284, 68_270),
              "ball_rest": (60_300, 61_164, 65_037, 65_901)}
PARENT_OPS = {"reset": (79_528, 80_728, 80_704, 81_904),
              "paddle_ball": (82_034, 83_274, 83_672, 84_912),
              "paddle_table": (82_076, 82_494, 83_492, 83_814),
              "ball_rest": (80_185, 81_385, 81_361, 82_561)}
#: K1's on tests/test_torch_arm_step.py's first set (128 envs): this body's,
#: and the one-thread body's of commit 640a705
K1_NEEDED_OPS, K1_PARENT_OPS = 810_880, 918_400
KINDS = ("reset", "paddle_ball", "paddle_table", "ball_rest")


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    F.check_library_layout(lib, 7)
    return lib


@pytest.fixture(scope="module")
def flagship():
    """kind -> (the flagship's K2 pack, its ng, the seven inputs, the
    full-strength DR channel), 8 envs, tensors."""
    cfg = load_task_config(TASK)
    envs = {raised: isaacgym_tpu_torch.make(
        seed=0, task=TASK, num_envs=B, device="cpu",
        cfg=scripted.raised_table_cfg(cfg) if raised else cfg) for raised in (False, True)}
    chan = torch.as_tensor(full_strength_dr(cfg["task"]["randomization_params"], 7,
                                            np.random.RandomState(7))[:B])
    out = {}
    for i, kind in enumerate(KINDS):
        k = envs[kind == "paddle_table"].sim.fused_substep
        ins = [torch.as_tensor(a) for a in scripted.k2_inputs(
            envs[kind == "paddle_table"], kind, B, np.random.RandomState(71 + i))]
        out[kind] = (k.consts, k.ng, ins, chan)
    return out


def run_k2(host, consts, ng, ins, chan, build, reverse=False, count=False):
    """The host build of K2's ``build`` on (b, n) inputs -> (outputs, the
    operation count or None)."""
    dr, tau = BUILDS[build]
    x = F.pack_inputs(*ins, *([chan[:ins[0].shape[0]]] if dr else []))
    b = x.shape[1]
    c = torch.as_tensor(consts)
    y = torch.full((F.n_out(7, ng, bool(tau)), b), float("nan"))
    args = (c.data_ptr(), x.data_ptr(), y.data_ptr(), b, 7)
    ops = None
    if count:
        if tau:
            ops = host.igt_fused_substep_tau_count_ops(*args, dr)
        else:
            ops = (host.igt_fused_substep_dr_count_ops if dr
                   else host.igt_fused_substep_count_ops)(*args)
        assert ops > 0
    elif reverse:
        assert host.igt_fused_substep_reversed_host(*args, dr, tau) == 0
    elif tau:
        assert host.igt_fused_substep_tau_host(*args, dr) == 0
    else:
        assert (host.igt_fused_substep_dr_host if dr else host.igt_fused_substep_host)(*args) == 0
    return F.unpack_outputs(y, 7, ng), ops


def plain_k2(consts, ins, chan, build):
    dr, tau = BUILDS[build]
    return F.fused_substep_reference(consts, *ins, dr_chan=chan if dr else None,
                                     with_torque=bool(tau))


def _split(o, ng, tau):
    """numpy outputs; a torque build's impulses split into the force rows and
    the geom and ball moment rows."""
    v = {f: getattr(o, f).numpy() for f in o._fields}
    if not tau:
        return v, {}
    imp = v["impulses"]
    v["impulses"] = imp[:, :ng + 1]
    return v, {"geom_moments": imp[:, ng + 1:2 * ng + 1], "ball_moments": imp[:, 2 * ng + 1:]}


def _bits_equal(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f).view(torch.int32), getattr(b, f).view(torch.int32)), \
            f"{what}: {f}"


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("kind", KINDS)
def test_warp_body_matches_the_plain_version(flagship, host, kind, build):
    consts, ng, ins, chan = flagship[kind]
    tau = BUILDS[build][1]
    got, got_m = _split(run_k2(host, consts, ng, ins, chan, build)[0], ng, tau)
    want, want_m = _split(plain_k2(consts, ins, chan, build), ng, tau)
    dev, flip_rate = compare(got, want)
    assert flip_rate == 0.0, f"{kind}/{build}: flip rate {flip_rate}"
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{kind}/{build}: {f} deviates {dev[f]:.3e} > {tol}"
    for f, tol in MOMENT_TOL.items() if tau else ():
        d = float(np.abs(got_m[f] - want_m[f]).max())
        assert d <= tol, f"{kind}/{build}: {f} deviates {d:.3e} > {tol}"


def test_the_sets_reach_every_contact_kind(flagship, host):
    """The sets exercise what the warp's contact phases do: paddle strikes
    (the ball-vs-art reaction), art-vs-static pairs and the table."""
    flags = {}
    for kind in KINDS:
        consts, ng, ins, chan = flagship[kind]
        out = run_k2(host, consts, ng, ins, chan, "k2")[0]
        flags[kind] = out.impulses.abs().sum(-1).numpy() > 0
    assert flags["paddle_ball"][:, 1].any()
    assert flags["paddle_table"][:, :2].any()
    assert flags["ball_rest"][:, 2].all()


def _k1(host, consts, ins, reverse=False, count=False):
    x = A.pack_inputs(*ins)
    c = torch.as_tensor(consts)
    y = torch.full((A.n_out(7), x.shape[1]), float("nan"))
    args = (c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], 7)
    ops = None
    if count:
        ops = host.igt_arm_step_count_ops(*args)
    elif reverse:
        assert host.igt_arm_step_reversed_host(*args) == 0
    else:
        assert host.igt_arm_step_host(*args) == 0
    return A.unpack_outputs(y, 7), ops


@pytest.fixture(scope="module")
def k1():
    """K1's pack of tests/test_torch_arm_step.py (the 7-DOF G1 arm) and its
    two sets (the second drives joints into their limits)."""
    from tests.test_torch_arm_step import BASE_POS, BASE_QUAT, DT, GRAV, KD, KP, URDF
    from isaacgym_tpu_torch.ops import dynamics as D
    from isaacgym_tpu_torch.tasks.pingpong_common import load_tree
    consts = A.build_arm_constants(D.build_articulation(load_tree(URDF)), KP, KD, GRAV, DT)
    base = [torch.as_tensor(np.tile(v, (K1_B, 1))) for v in (BASE_POS, BASE_QUAT)]
    sets = [[torch.as_tensor(a) for a in k1_inputs(seed, q, qd)] + base
            for seed, q, qd in ((0, 0.8, 2.0), (2, 3.0, 6.0))]
    return consts, sets


@pytest.mark.parametrize("which", [0, 1])
def test_k1_warp_body_matches_the_plain_version(k1, host, which):
    consts, sets = k1
    got = _k1(host, consts, sets[which])[0]
    want = A.arm_step_plain(consts, *sets[which])
    for f in A.ArmStepOutputs._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                   rtol=0, atol=HOST_TOL, err_msg=f)


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("kind", KINDS)
def test_lanes_in_reverse_give_the_same_bits(flagship, host, kind, build):
    consts, ng, ins, chan = flagship[kind]
    fwd = run_k2(host, consts, ng, ins, chan, build)[0]
    _bits_equal(run_k2(host, consts, ng, ins, chan, build, reverse=True)[0], fwd, "reversed lanes")
    _bits_equal(run_k2(host, consts, ng, ins, chan, build, count=True)[0], fwd, "counting build")
    assert all(torch.isfinite(getattr(fwd, f)).all() for f in fwd._fields)


@pytest.mark.parametrize("which", [0, 1])
def test_k1_lanes_in_reverse_give_the_same_bits(k1, host, which):
    consts, sets = k1
    fwd = _k1(host, consts, sets[which])[0]
    _bits_equal(_k1(host, consts, sets[which], reverse=True)[0], fwd, "reversed lanes")
    _bits_equal(_k1(host, consts, sets[which], count=True)[0], fwd, "counting build")


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("kind", KINDS)
def test_operation_count_is_the_work_the_data_needs(flagship, host, kind, build):
    consts, ng, ins, chan = flagship[kind]
    _, ops = run_k2(host, consts, ng, ins, chan, build, count=True)
    i = list(BUILDS).index(build)
    assert ops == NEEDED_OPS[kind][i]
    assert ops < PARENT_OPS[kind][i]


def test_k1_operation_count(k1, host):
    consts, sets = k1
    _, ops = _k1(host, consts, sets[0], count=True)
    assert ops == K1_NEEDED_OPS < K1_PARENT_OPS


def _pick(host, flagship, kind, want):
    """The first env of ``kind``'s set whose K2-tau outputs show ``want``:
    'paddle' (the paddle row acts), 'no_paddle', 'table' (the ball row acts),
    'free' (no row acts)."""
    consts, ng, ins, chan = flagship[kind]
    act = run_k2(host, consts, ng, ins, chan, "k2tau")[0].impulses[:, :ng + 1].abs().sum(-1) > 0
    ok = {"paddle": act[:, 1], "no_paddle": ~act[:, 1], "table": act[:, ng],
          "free": ~act.any(1)}[want]
    assert ok.any(), f"no env of {kind} shows {want}"
    return int(torch.nonzero(ok)[0])


#: warps whose halves branch apart: (set, what its env shows) for each half
PAIRS = {"strike_and_not": (("paddle_ball", "paddle"), ("paddle_ball", "no_paddle")),
         "strike_and_free": (("reset", "free"), ("paddle_ball", "paddle")),
         "walks_stop_apart": (("ball_rest", "table"), ("reset", "free"))}


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_halves_that_branch_apart(flagship, host, pair, build):
    """Each env of a warp whose halves need different phases (one strikes
    the paddle, the other does not; one's statics walk stops at the table,
    the other's takes every static) gives the bits of that env in a warp
    alone (the other half idle, B = 1). The two envs share a pack: the
    paddle_table set (the raised table's) is not paired."""
    halves = []
    for kind, want in PAIRS[pair]:
        consts, ng, ins, chan = flagship[kind]
        j = _pick(host, flagship, kind, want)
        halves.append((consts, ng, [t[j:j + 1] for t in ins], chan[j:j + 1]))
    consts, ng = halves[0][:2]
    both = [torch.cat([h[2][i] for h in halves]) for i in range(7)]
    chan = torch.cat([h[3] for h in halves])
    warp = run_k2(host, consts, ng, both, chan, build)[0]
    for a, (_, _, ins, ch) in enumerate(halves):
        alone = run_k2(host, consts, ng, ins, ch, build)[0]
        _bits_equal(type(warp)(*[t[a:a + 1] for t in warp]), alone, f"{pair} env {a}")


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_odd_batch(flagship, host, build):
    """B = 7: the last warp runs env 6 on both halves and writes it once;
    every env's outputs equal those of the run at B = 8, and the count is
    each env's own work (the 7 envs' and env 7's alone make the 8's)."""
    consts, ng, ins, chan = flagship["paddle_ball"]
    full, ops = run_k2(host, consts, ng, ins, chan, build, count=True)
    odd, ops_odd = run_k2(host, consts, ng, [t[:B - 1] for t in ins], chan, build, count=True)
    _bits_equal(odd, type(full)(*[t[:B - 1] for t in full]), "odd B")
    _, ops_last = run_k2(host, consts, ng, [t[B - 1:] for t in ins], chan[B - 1:], build,
                         count=True)
    assert ops_odd + ops_last == ops


def test_k1_odd_batch(k1, host):
    consts, sets = k1
    full, ops = _k1(host, consts, sets[1], count=True)
    odd, ops_odd = _k1(host, consts, [t[:K1_B - 1] for t in sets[1]], count=True)
    _bits_equal(odd, type(full)(*[t[:K1_B - 1] for t in full]), "odd B")
    _, ops_last = _k1(host, consts, [t[K1_B - 1:] for t in sets[1]], count=True)
    assert ops_odd + ops_last == ops
