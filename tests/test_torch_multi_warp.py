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
- The phase probe (``phase_probe``) finds every anchor it marks, for K3
  (and K3 at <26, 2, 2>), K2 and K1.
- At <26, 2, 2> the body runs each articulation's tree as the subtrees of
  its base (``csrc/tree_warp.cuh``): the blocks it derives from the ancestor
  mask are the G1's four chains (6, 6, 7, 7 DOFs, 98 active columns and 98
  factor entries), one block for C8's 7-DOF arm and one per base subtree for
  a branched tree whose subtrees interleave; ``tree_blocks`` derives the
  same. Its operation count on C11's sets is pinned and below the dense
  body's (commit 16cb4ab), which summed and factored the zero entries
  between the blocks.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep as F
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
#: the same on C11's sets at <26, 2, 2> (8 envs, RandomState(71), efforts in
#: +-20; K3-tau with a sensor on each paddle): NEEDED_OPS_C11 from the
#: tree-blocked body, PARENT_OPS_C11 from the dense body of commit 16cb4ab
NEEDED_OPS_C11 = {"reset": (413_328, 425_008), "paddle_ball1": (420_231, 433_335),
                  "paddle_ball2": (419_217, 432_323), "ball_rest": (403_810, 414_946)}
PARENT_OPS_C11 = {"reset": (610_364, 622_044), "paddle_ball1": (639_367, 652_471),
                  "paddle_ball2": (636_720, 649_826), "ball_rest": (616_630, 627_766)}
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


@pytest.mark.parametrize("kernel", ["k3", "k3tau"])
@pytest.mark.parametrize("kind", scripted.C8_KINDS)
def test_operation_count_is_the_work_the_data_needs_on_c11(c11, host, kind, kernel):
    k3, k3tau, ins = c11[kind]
    _, ops = run_host(host, k3tau if kernel == "k3tau" else k3, ins, count=True)
    assert ops == NEEDED_OPS_C11[kind][kernel == "k3tau"]
    assert ops < PARENT_OPS_C11[kind][kernel == "k3tau"]


def _branched_block(nd=7, parents=(-1, -1, 0, 1, 2, 0, 3)):
    """An articulation block of a K3 pack whose tree has two base subtrees
    that interleave in DOF order ({0, 2, 4, 5} and {1, 3, 6}), its mask from
    ``parents``."""
    block = np.zeros(M.multi_layout(nd, 2)["art_stride"], np.float32)
    mask = np.zeros((nd, nd), np.float32)
    for d in range(nd):
        a = d
        while a >= 0:
            mask[d, a] = 1.0
            a = parents[a]
    m = F.layout(nd)["mask"]
    block[m:m + nd * nd] = mask.reshape(-1)
    return block, mask


@pytest.mark.parametrize("tree", ["c11", "c8", "branched"])
def test_tree_blocks_from_the_mask(c8, c11, host, tree):
    """The blocks the <26, 2, 2> body derives from an articulation's
    ancestor mask (``igt_multi_tree``, the body's own routines): (blocks,
    factor entries, active columns, DOFs of each block), and
    ``tree_blocks`` on the same mask."""
    if tree == "branched":
        block, mask = _branched_block()
        want = (2, 16, 14, [4, 3])
    else:
        k = (c11 if tree == "c11" else c8)["reset"][0]
        lay = M.multi_layout(k.nd, k.K)
        block = np.ascontiguousarray(k.consts[lay["art0"]:lay["art0"] + lay["art_stride"]])
        mask = M.pack_masks(k.consts)[0]
        want = (4, 98, 98, [6, 6, 7, 7]) if tree == "c11" else (1, 28, 28, [7])
    out = np.zeros(32, np.int32)
    assert host.igt_multi_tree(block.ctypes.data, mask.shape[0], out.ctypes.data, 32) == 0
    assert (int(out[0]), int(out[1]), int(out[2]), out[3:3 + out[0]].tolist()) == want
    blocks = M.tree_blocks(mask)
    assert [len(b) for b in blocks] == want[3]
    assert sorted(sum(blocks, [])) == list(range(mask.shape[0]))
    if tree == "branched":
        assert blocks == [[0, 2, 4, 5], [1, 3, 6]]
    if tree == "c11":
        assert M.tree_refusal((26, 2, 2), M.pack_masks(k.consts)) is None
        chain = np.tril(np.ones((26, 26), np.float32))   # one chain: 351 entries
        assert "351" in M.tree_refusal((26, 2, 2), [chain])


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
    """``phase_probe``'s copy of ``csrc`` for each kernel it probes (K3, K3
    at <26, 2, 2>, K2, K1) holds its mark macro and each of that kernel's
    marks once: a renamed phase comment fails here, not on the card."""
    import os
    import re
    from isaacgym_tpu_torch import phase_probe
    assert sorted(phase_probe.MARKS) == ["k1", "k2", "k3", "k3c11"]
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
