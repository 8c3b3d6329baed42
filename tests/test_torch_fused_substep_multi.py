"""K3 (the fused substep of K articulations and M balls): the port's plain
version against the JAX package's ``build_fused_substep_multi`` (Pallas,
interpret mode on the CPU), and the kernel's own per-env body
(``csrc/fused_substep_multi.cuh`` compiled by g++ into a host loop) against
the plain version; the constant pack against one built from the JAX
package's build arguments.

The Pallas kernel runs on the two-arm, two-ball check scene of
``tests/test_pallas_dynamics.py`` (two 3-DOF arms, the second yawed 180
deg), which the port rebuilds from the same URDF string
(``sim/scripted.py``), once per drive mode (PD, effort), at B = 128: one
interpret-mode trace each. The state sets sit in rows of that one batch,
32 each (``scripted.TOY_KINDS``): reset launches, each ball in front of a
paddle (both arms), and the two balls about to collide. The 14-DOF C8 trace
costs minutes of XLA:CPU compile, so on C8 the host body is held against the
plain version, on C8's state sets (``scripted.C8_KINDS`` and a rollout).

Tolerances, over envs whose contact pattern agrees (no flip): 1e-4 on q,
ball pos and ball vel; 1e-3 on qd, tau, impulses and omega, as for K2
(``tests/test_torch_fused_substep.py``); no flips on the toy scene.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.sim.simulator import Simulator as JaxSimulator
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import fused_substep_multi as M
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS
from isaacgym_tpu_torch.sim.simulator import fused_geom_lists
from tests.test_pallas_dynamics import TOY_ARM_URDF, _toy_multi_scene

B = 128
ROWS = B // len(scripted.TOY_KINDS)
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3)
DRIVES = {"pd": (DRIVE_POS, 0.0), "effort": (DRIVE_EFFORT, 15.0)}
C8 = "Humanoid12PingpongTiltG1"


def _np_out(o):
    return {f: np.asarray(getattr(o, f)) for f in o._fields}


def compare(a, b):
    """Max deviation per output over no-flip envs, and the flip rate."""
    fa, fb = np.abs(a["impulses"]).sum(-1) > 0, np.abs(b["impulses"]).sum(-1) > 0
    keep = ~np.any(fa != fb, axis=1)
    dev = {f: float(np.abs(a[f] - b[f]).reshape(len(keep), -1)[keep].max()) for f in TOL}
    return dev, float((~keep).mean())


def _assert_close(a, b, what, max_flip_rate=0.002):
    dev, flip_rate = compare(a, b)
    for f, tol in TOL.items():
        assert dev[f] <= tol, f"{what}: {f} deviates {dev[f]:.3e} > {tol}"
    assert flip_rate <= max_flip_rate, f"{what}: flip rate {flip_rate}"


def _rows(out, kind):
    i = scripted.TOY_KINDS.index(kind)
    return {f: v[i * ROWS:(i + 1) * ROWS] for f, v in out.items()}


@pytest.fixture(scope="module", params=sorted(DRIVES))
def toy(request):
    """drive -> (port toy env, inputs, JAX Pallas K3 outputs), numpy."""
    drive, scale = DRIVES[request.param]
    jsim = JaxSimulator(_toy_multi_scene(drive))
    jsim._maybe_build_pallas(force=True)
    te = scripted.ToyEnv(drive)
    parts = [scripted.k3_inputs(te, kind, ROWS, np.random.RandomState(10 + i), scale)
             for i, kind in enumerate(scripted.TOY_KINDS)]
    ins = tuple(np.concatenate(p) for p in zip(*parts))
    want = _np_out(jsim._fused_multi(*[jnp.asarray(x) for x in ins]))
    return request.param, te, ins, want


def test_toy_scene_is_the_jax_tests_scene():
    assert scripted.TOY_ARM_URDF == TOY_ARM_URDF


@pytest.mark.parametrize("kind", scripted.TOY_KINDS)
def test_plain_matches_pallas_kernel(toy, kind):
    name, te, ins, want = toy
    got = _np_out(te.sim.fused_substep_multi(*[torch.as_tensor(x) for x in ins]))
    _assert_close(_rows(got, kind), _rows(want, kind), f"{name}/{kind}", max_flip_rate=0.0)


def test_toy_sets_exercise_every_contact_kind(toy):
    """Both arms' paddles react to both balls, the balls hit each other, and
    under effort drive tau is the clamped effort input."""
    name, te, ins, want = toy
    ng = te.sim.fused_substep_multi.ng
    act = {k: (np.abs(_rows(want, k)["impulses"]).sum(-1) > 0).mean(0)
           for k in scripted.TOY_KINDS}
    assert not act["reset"].any()
    for kind in ("paddle_ball1", "paddle_ball2"):
        assert min(act[kind][:ng]) > 0.3, (kind, act[kind])        # both paddles
        assert min(act[kind][ng + 2:]) > 0.3, (kind, act[kind])    # both balls' reactions
    assert min(act["ball_ball"][ng:ng + 2]) > 0.5                  # the pair, on each ball
    if name == "effort":
        lim = np.concatenate([s.model.tree.effort for s in te.scene.articulations])
        np.testing.assert_allclose(want["tau"], np.clip(ins[3], -lim, lim), rtol=0, atol=0)


@pytest.fixture(scope="module")
def host_lib():
    lib = _build.build_host_library()
    for nd in (3, 7):
        M.check_library_layout(lib, nd, 2)
    return lib


def _run_host(lib, env, ins, fn="igt_fused_substep_multi_host"):
    k = env.sim.fused_substep_multi
    x = M.pack_inputs(*[torch.as_tensor(a) for a in ins])
    n = x.shape[1]
    y = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng), n), dtype=torch.float32)
    c = torch.as_tensor(env.sim.constants)
    ret = getattr(lib, fn)(c.data_ptr(), x.data_ptr(), y.data_ptr(), n, k.nd, k.K, k.nb)
    return ret, M.unpack_outputs(y, k.nd_tot, k.nb, k.ng)


def test_toy_kernel_body_matches_plain(toy, host_lib):
    name, te, ins, _ = toy
    ret, got = _run_host(host_lib, te, ins)
    assert ret == 0
    want = te.sim.fused_substep_multi(*[torch.as_tensor(x) for x in ins])
    _assert_close(_np_out(got), _np_out(want), name, max_flip_rate=0.0)


@pytest.fixture(scope="module")
def c8():
    """(port C8 env on the CPU, kind -> K3 inputs at B = 128)."""
    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B, device="cpu")
    sets = {kind: scripted.k3_inputs(env, kind, B, np.random.RandomState(40 + i))
            for i, kind in enumerate(scripted.C8_KINDS)}
    rng = np.random.RandomState(7)
    state, _ = env.reset()
    for _ in range(40):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (B, 14)),
                                                    dtype=torch.float32))
    tgt, eff = env.action_to_drive(torch.as_tensor(rng.uniform(-1, 1, (B, 14)),
                                                   dtype=torch.float32))
    s = state.sim
    sets["rollout"] = tuple(np.ascontiguousarray(t.numpy(), dtype=np.float32) for t in (
        s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 3:4, 0:3], s.root[:, 3:4, 7:10],
        s.root[:, 3:4, 10:13]))
    return env, sets


@pytest.mark.parametrize("kind", scripted.C8_KINDS + ("rollout",))
def test_c8_kernel_body_matches_plain(c8, host_lib, kind):
    env, sets = c8
    ret, got = _run_host(host_lib, env, sets[kind])
    assert ret == 0
    want = env.sim.fused_substep_multi(*[torch.as_tensor(x) for x in sets[kind]])
    _assert_close(_np_out(got), _np_out(want), kind)


def test_c8_sets_reach_both_humanoids(c8):
    """A ball at humanoid 2's paddle changes only humanoid 2's DOFs' contact
    rows, and the resting ball acts on the table through its static row."""
    env, sets = c8
    ng = env.sim.fused_substep_multi.ng
    geom_art = np.asarray([g["art"] for g in fused_geom_lists(env.scene)[2]])
    act = {k: (np.abs(_np_out(env.sim.fused_substep_multi(
        *[torch.as_tensor(x) for x in v]))["impulses"]).sum(-1) > 0).mean(0)
        for k, v in sets.items()}
    assert act["paddle_ball1"][:ng][geom_art == 0].max() > 0.3
    assert act["paddle_ball1"][:ng][geom_art == 1].max() == 0.0
    assert act["paddle_ball2"][:ng][geom_art == 1].max() > 0.3
    assert act["paddle_ball2"][:ng][geom_art == 0].max() == 0.0
    assert act["ball_rest"][ng] > 0.9
    assert not act["reset"].any()


def test_operation_count_runs_the_same_body(c8, host_lib):
    env, sets = c8
    ops, counted = _run_host(host_lib, env, sets["paddle_ball2"],
                             "igt_fused_substep_multi_count_ops")
    _, plain = _run_host(host_lib, env, sets["paddle_ball2"])
    for f in plain._fields:
        torch.testing.assert_close(getattr(counted, f), getattr(plain, f), rtol=0, atol=0)
    # two 7-DOF articulations' dynamics: about twice K2's ~10^4 per env
    assert 15000 * B < ops < 60000 * B
    idle_ops, _ = _run_host(host_lib, env, sets["reset"], "igt_fused_substep_multi_count_ops")
    assert idle_ops < ops


@pytest.fixture(scope="module")
def jax_c8_build():
    """The arguments the JAX package's simulator passes to
    ``build_fused_substep_multi`` for C8 (no trace: the kernel is not run)."""
    je = isaacgym_tpu.make(seed=0, task=C8, num_envs=16)
    captured = {}
    real = PDK.build_fused_substep_multi

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    PDK.build_fused_substep_multi = capture
    try:
        je.sim._maybe_build_pallas(force=True)
    finally:
        PDK.build_fused_substep_multi = real
    return je, captured


def test_c8_geom_lists_and_pack_equal_the_jax_build_arguments(jax_c8_build):
    je, cap = jax_c8_build
    arts, balls, j_static, j_art, gravity, dt_s = cap["args"]
    kw = cap["kwargs"]
    assert kw["with_torque"] is False and kw["exact_support"] is True
    pe = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=16, device="cpu")
    static, n_true, art, art_bodies = fused_geom_lists(pe.scene)
    assert n_true == kw["n_true_static"] == 2
    assert len(static) == len(j_static) == 16 and len(art) == len(j_art) == 4
    for mine, theirs in zip(static + art, j_static + j_art):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]), err_msg=k)
    np.testing.assert_array_equal(art_bodies, je.sim._fused_art_bodies)
    pack = M.build_multi_constants(
        arts, balls, j_static, j_art, gravity, dt_s, bounce_threshold=kw["bounce_threshold"],
        n_true_static=kw["n_true_static"], max_depenetration=kw["max_depenetration"],
        exact_support=kw["exact_support"])
    np.testing.assert_array_equal(pe.sim.constants, pack)
    # the Pallas kernel's own reach pruning keeps the same pairs, per humanoid
    lay = M.multi_layout(7, 2)
    pairs = [tuple(int(v) for v in pe.sim.constants[lay["pair"] + 8 * i:lay["pair"] + 8 * i + 2])
             for i in range(int(pe.sim.constants[M.F.C_NPAIR]))]
    want = [(gi, si) for gi, g in enumerate(j_art) for si, sg in enumerate(j_static[:n_true])
            if not PDK._static_pair_unreachable(arts[g["art"]]["model"],
                                                arts[g["art"]]["base_pos"], g, sg)]
    assert pairs == want and len(pairs) == 4
    # humanoid 2's base: x = 3.5, yawed 180 deg
    np.testing.assert_allclose(arts[1]["base_pos"], [3.5, 0.0, 1.0])
    np.testing.assert_allclose(np.abs(arts[1]["base_quat"]), [0, 0, 1, 0], atol=1e-7)


def test_multi_layout_check_rejects_a_mismatch(host_lib, monkeypatch):
    monkeypatch.setattr(M, "MAX_ART", M.MAX_ART + 1)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        M.check_library_layout(host_lib, 7, 2)


def test_wrapper_refuses_other_shapes():
    te = scripted.ToyEnv(DRIVE_POS)
    k = M.FusedSubstepMulti(te.sim.constants)
    k.nb = 1   # a shape the kernel is not built for
    with pytest.raises(NotImplementedError, match="built for"):
        k.launch(torch.zeros((M.n_in(6, 1), 4)))
