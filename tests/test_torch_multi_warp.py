"""K3 and K3-tau as one warp per env, the two articulations side by side:
the g++ host build of ``csrc/fused_substep_multi.cuh`` runs the warp's 32
lanes of every phase one after another, the card's own schedule
(``csrc/fused_substep_host.cpp``).

- The host build, lanes in order, against the plain version on the two-arm,
  two-ball check scene's sets (128 rows, PD and effort drive, ``ball_ball``
  included) and at 8 envs on C8's sets, at
  ``tests/test_torch_fused_substep_multi.py``'s tolerances, flip-aware; and
  at <26, 2, 2> on C11's sets (8 envs, both balls at the paddles, random
  efforts), K3 and K3-tau (a sensor on each paddle), every output but the
  moment rows at the same tolerances and no flip.
- K3-tau's moment rows on a paddle set (C8 with a sensor on each paddle)
  and on ``ball_ball`` (the check scene with paddle sensors) against the
  plain version, at ``tests/test_torch_floating_torque.py``'s moment
  tolerances.
- The operation count (the bound's) on C8's sets: the work the data needs,
  which the counting build reads from this body by dropping the tests that a
  state change throws away. It is pinned, and it stays below the count of
  the one-thread-per-env body this design replaced (commit 2f478e1), which
  formed I_l axw_j again for every mass-matrix entry and ran every contact
  test that culls now skip.
- Each phase's lanes run in reverse give the same bits as in order: no phase
  reads what another lane of it writes (C11's sets at <26, 2, 2> too). The float build (the dynamics' and
  the contacts' scratch overlaid in one union, as on the card) and the
  counting build (side by side) give the same bits too, signed zeros
  included.
- The phase probe (``phase_probe``) finds every anchor it marks, for K3,
  K2 and K1.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep_multi as M
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.tasks.humanoid_pingpong_draft_5actor import build_5actor_scene
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_fused_substep_multi import C8, DRIVES, TOL, compare

C8_B = 8
C11 = "HumanoidPingpong5ActorG1"
C11_EFFORT = 20.0   # N m: C11's sets' efforts are uniform in +-20 (effort drive)
TOY_ROWS = 32   # per set: the check scene's four sets make 128 rows
#: K3's and K3-tau's operations on C8's sets (8 envs,
#: ``scripted.k3_inputs(env, kind, 8, RandomState(61))``; K3-tau with the
#: pack of C8's scene with a sensor on each paddle), counted by
#: ``igt_fused_substep_multi_count_ops`` (``..._tau_count_ops``): NEEDED_OPS
#: from this body, PARENT_OPS from the one-thread-per-env body of commit
#: 2f478e1
NEEDED_OPS = {"reset": (118_360, 127_840), "paddle_ball1": (121_880, 132_236),
              "paddle_ball2": (122_063, 132_347), "ball_rest": (116_247, 125_175)}
PARENT_OPS = {"reset": (155_752, 157_768), "paddle_ball1": (157_889, 160_301),
              "paddle_ball2": (157_877, 160_289), "ball_rest": (156_299, 158_315)}
MOMENT_TOL = dict(geom_moments=1e-5, ball_moments=1e-7)


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host_library()
    for nd in (3, 7, 26):
        M.check_library_layout(lib, nd, 2)
    return lib


def run_host(host, k, ins, reverse=False, count=False):
    """The host build of wrapper ``k``'s pack on numpy inputs -> (outputs,
    operation count or None)."""
    x = M.pack_inputs(*[torch.as_tensor(a) for a in ins])
    c = torch.as_tensor(k.consts)
    y = torch.zeros((M.n_out(k.nd_tot, k.nb, k.ng, k.with_torque), x.shape[1]))
    args = (c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], k.nd, k.K, k.nb)
    ops = None
    if count:
        fn = (host.igt_fused_substep_multi_tau_count_ops if k.with_torque
              else host.igt_fused_substep_multi_count_ops)
        ops = fn(*args)
        assert ops > 0
    elif reverse:
        assert host.igt_fused_substep_multi_reversed_host(*args, int(k.with_torque)) == 0
    else:
        fn = (host.igt_fused_substep_multi_tau_host if k.with_torque
              else host.igt_fused_substep_multi_host)
        assert fn(*args) == 0
    return M.unpack_outputs(y, k.nd_tot, k.nb, k.ng), ops


def plain(k, ins):
    return M.fused_substep_multi_reference(k.consts, *[torch.as_tensor(a) for a in ins],
                                           with_torque=k.with_torque)


def _np(o):
    return {f: getattr(o, f).numpy() for f in o._fields}


def _assert_close(got, want, what, max_flip_rate):
    dev, flip_rate = compare(got, want)
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{what}: {f} deviates {dev[f]:.3e} > {tol}"
    assert flip_rate <= max_flip_rate, f"{what}: flip rate {flip_rate}"


@pytest.fixture(scope="module")
def toy():
    """(drive, kind) -> (K3, K3-tau of the paddle sensor scene, inputs) on
    the check scene, 32 rows a set."""
    out = {}
    for name, (drive, scale) in DRIVES.items():
        k = scripted.ToyEnv(drive).sim.fused_substep_multi
        tau = scripted.ToyEnv(drive, paddle_sensor=True).sim.fused_substep_multi
        for i, kind in enumerate(scripted.TOY_KINDS):
            out[(name, kind)] = (k, tau, scripted.k3_inputs(
                scripted.ToyEnv(drive), kind, TOY_ROWS, np.random.RandomState(10 + i), scale))
    return out


@pytest.fixture(scope="module")
def c8():
    """kind -> (K3, K3-tau of C8 with a sensor on each paddle, inputs), 8 envs."""
    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=C8_B, device="cpu")
    tau = Simulator(scripted.paddle_sensor_scene(load_task_config(C8), 2), device="cpu")
    return {kind: (env.sim.fused_substep_multi, tau.fused_substep_multi,
                   scripted.k3_inputs(env, kind, C8_B, np.random.RandomState(61)))
            for kind in scripted.C8_KINDS}


@pytest.fixture(scope="module")
def c11():
    """kind -> (K3, K3-tau of C11 with a sensor on each paddle, inputs), 8
    envs: <26, 2, 2>."""
    env = isaacgym_tpu_torch.make(seed=0, task=C11, num_envs=C8_B, device="cpu")
    tau = Simulator(scripted.with_paddle_sensor(
        build_5actor_scene(load_task_config(C11)["sim"])), device="cpu")
    return {kind: (env.sim.fused_substep_multi, tau.fused_substep_multi,
                   scripted.k3_inputs(env, kind, C8_B, np.random.RandomState(71), C11_EFFORT))
            for kind in scripted.C8_KINDS}


TOY_CASES = [(d, kind) for d in sorted(DRIVES) for kind in scripted.TOY_KINDS]


@pytest.mark.parametrize("drive,kind", TOY_CASES)
def test_warp_body_matches_the_plain_version_on_the_check_scene(toy, host, drive, kind):
    k, _, ins = toy[(drive, kind)]
    got, _ = run_host(host, k, ins)
    _assert_close(_np(got), _np(plain(k, ins)), f"{drive}/{kind}", max_flip_rate=0.0)


@pytest.mark.parametrize("kind", scripted.C8_KINDS)
def test_warp_body_matches_the_plain_version_on_c8(c8, host, kind):
    k, _, ins = c8[kind]
    got, _ = run_host(host, k, ins)
    _assert_close(_np(got), _np(plain(k, ins)), kind, max_flip_rate=0.002)


@pytest.mark.parametrize("with_torque", [False, True])
@pytest.mark.parametrize("kind", scripted.C8_KINDS)
def test_warp_body_matches_the_plain_version_on_c11(c11, host, kind, with_torque):
    k3, k3tau, ins = c11[kind]
    k = k3tau if with_torque else k3
    assert (k.nd, k.K, k.nb) == (26, 2, 2) and k.with_torque == with_torque
    got, want = run_host(host, k, ins)[0], plain(k, ins)
    if with_torque:
        forces, mom = _moments(got, k.ng, k.nb)
        forces_w, mom_w = _moments(want, k.ng, k.nb)
        for f, tol in MOMENT_TOL.items():
            d = float(np.abs(mom[f] - mom_w[f]).max())
            assert d <= tol, f"{kind}: {f} deviates {d:.3e} > {tol}"
        got, want = (_np(got), _np(want))
        got["impulses"], want["impulses"] = forces, forces_w
    else:
        got, want = _np(got), _np(want)
    _assert_close(got, want, f"c11/{kind}", max_flip_rate=0.0)
    if kind != "reset":
        assert (np.abs(got["impulses"]).sum(-1) > 0).any()


def _moments(out, ng, nb):
    imp = out.impulses.numpy()
    return imp[:, :ng + 2 * nb], {"geom_moments": imp[:, ng + 2 * nb:2 * ng + 2 * nb],
                                  "ball_moments": imp[:, 2 * ng + 2 * nb:]}


@pytest.mark.parametrize("scene", ["c8", "toy"])
def test_k3tau_moment_rows(c8, toy, host, scene):
    """K3-tau's host build on a paddle set (C8's humanoid 2) and on the
    check scene's ball pair: its moment rows within the moment tolerances
    of the plain K3-tau's over the envs without a flip, every other output
    at K3's tolerances, and the contacts reach the geom and ball moment rows."""
    _, k, ins = c8["paddle_ball2"] if scene == "c8" else toy[("pd", "ball_ball")]
    got, want = run_host(host, k, ins)[0], plain(k, ins)
    forces, mom = _moments(got, k.ng, k.nb)
    forces_w, mom_w = _moments(want, k.ng, k.nb)
    flags = lambda imp: np.abs(imp).sum(-1) > 0
    keep = ~np.any(flags(forces) != flags(forces_w), axis=1)
    assert keep.all()
    for f, tol in MOMENT_TOL.items():
        d = float(np.abs(mom[f] - mom_w[f]).max())
        assert d <= tol, f"{scene}: {f} deviates {d:.3e} > {tol}"
    _assert_close({**_np(got), "impulses": forces}, {**_np(want), "impulses": forces_w}, scene,
                  max_flip_rate=0.0)
    assert (np.abs(mom["ball_moments"]).sum(-1) > 0).any(1).mean() > 0.3
    if scene == "c8":
        assert (np.abs(mom["geom_moments"]).sum(-1) > 0).any(1).mean() > 0.3


@pytest.mark.parametrize("kernel", ["k3", "k3tau"])
@pytest.mark.parametrize("kind", scripted.C8_KINDS)
def test_operation_count_is_the_work_the_data_needs(c8, host, kind, kernel):
    k3, k3tau, ins = c8[kind]
    _, ops = run_host(host, k3tau if kernel == "k3tau" else k3, ins, count=True)
    assert ops == NEEDED_OPS[kind][kernel == "k3tau"]
    assert ops < PARENT_OPS[kind][kernel == "k3tau"]


CASES = ([("toy", d, kind) for d, kind in TOY_CASES]
         + [(scene, None, kind) for scene in ("c8", "c11") for kind in scripted.C8_KINDS])


@pytest.mark.parametrize("with_torque", [False, True])
@pytest.mark.parametrize("scene,drive,kind", CASES)
def test_lanes_in_reverse_give_the_same_bits(c8, c11, toy, host, scene, drive, kind,
                                            with_torque):
    k3, k3tau, ins = toy[(drive, kind)] if scene == "toy" else {"c8": c8, "c11": c11}[scene][kind]
    k = k3tau if with_torque else k3
    fwd, _ = run_host(host, k, ins)
    rev, _ = run_host(host, k, ins, reverse=True)
    counted, _ = run_host(host, k, ins, count=True)
    bits = lambda o, f: getattr(o, f).view(torch.int32)   # -0 and +0 differ
    for f in fwd._fields:
        assert torch.equal(bits(rev, f), bits(fwd, f)), f"reversed lanes: {f}"
        assert torch.equal(bits(counted, f), bits(fwd, f)), f"counting build: {f}"
    assert all(torch.isfinite(getattr(fwd, f)).all() for f in fwd._fields)



def test_phase_probe_finds_every_anchor(tmp_path):
    """``phase_probe``'s copy of ``csrc`` for each kernel it probes (K3, K2,
    K1) holds its mark macro and each of that kernel's marks once: a renamed
    phase comment fails here, not on the card."""
    import os
    import re
    from isaacgym_tpu_torch import phase_probe
    assert sorted(phase_probe.MARKS) == ["k1", "k2", "k3"]
    for kernel, header, name in (("k1", "arm_step.cuh", "K1_ENVS"),
                                 ("k2", "fused_substep_warp.cuh", "K2_ENVS")):
        with open(os.path.join(_build.CSRC, header)) as fh:
            envs = int(re.search(rf"constexpr int {name} = (\d+);", fh.read()).group(1))
        assert phase_probe.ENVS_PER_WARP[kernel] == envs, kernel
    for kernel, marks_of in phase_probe.MARKS.items():
        out = phase_probe.marked_copy(_build.CSRC, str(tmp_path / kernel), kernel)
        with open(os.path.join(out, "warp.cuh")) as fh:
            assert "g_probe" in fh.read()
        with open(os.path.join(out, f"{phase_probe.SOURCES[kernel]}.cu")) as fh:
            assert "igt_probe_read" in fh.read()
        marks = 0
        for f in sorted({f for f, _, _ in marks_of}):
            with open(os.path.join(out, f)) as fh:
                marks += fh.read().count("  IGT_MARK(")
        assert marks == len(marks_of), kernel
