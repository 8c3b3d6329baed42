"""K1, the arm step (``ops/arm_step.py``), against the JAX package's Pallas K1
(``build_arm_step``, interpret mode on the CPU).

The inputs and tolerances are those of ``tests/test_pallas_dynamics.py:53-99``
(the 7-DOF G1 arm, base yawed -30 deg, B = 128, numpy seeds 0 and 1): there
the Pallas K1 is held to the XLA substep within tau 1e-4, q 1e-3, qd 5e-3 and
frames 1e-3, and its factor reconstructs the mass matrix within 2e-4. The
plain K1 repeats the Pallas arithmetic, so it meets the same bars against
the Pallas kernel with far to spare (measured: q 6e-8, qd 1.3e-5, tau 3.8e-6,
frames 1.8e-7, factor 1.8e-7). The g++ host loop over the CUDA kernel's own
body (``csrc/arm_step.cuh``) is held to the plain version within 1e-4 on
every output (measured: qd 1.7e-5, the rest 2.4e-7 or less); it also counts
the body's operations per env (7,175 on these inputs).
"""

import ctypes

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.ops import dynamics as JD
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.tasks.pingpong_common import load_tree as jax_load_tree
from isaacgym_tpu_torch.ops import _build
from isaacgym_tpu_torch.ops import arm_step as A
from isaacgym_tpu_torch.ops import dynamics as D
from isaacgym_tpu_torch.ops.linalg import chol_solve
from isaacgym_tpu_torch.tasks.pingpong_common import load_tree

URDF = "g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf"
GRAV = np.asarray([0.0, 0.0, -9.81], np.float32)
DT = 1.0 / 240.0
KP = np.asarray([20.0, 20, 20, 20, 20, 5, 5], np.float32)
KD = KP / 40.0
BASE_POS = np.asarray([0.0, 0.0, 1.0], np.float32)
BASE_QUAT = np.asarray([0.0, 0.0, -0.2588, 0.9659], np.float32)   # -30 deg yaw
B = 128
# the JAX package's K1 tolerances (tests/test_pallas_dynamics.py:74-78)
TOL = dict(tau=1e-4, q_new=1e-3, qd_new=5e-3, frame_pos=1e-3, frame_quat=1e-3, chol=2e-4)
HOST_TOL = 1e-4


@pytest.fixture(scope="module")
def k1():
    jm = JD.build_articulation(jax_load_tree(URDF))
    pm = D.build_articulation(load_tree(URDF))
    pallas = PDK.build_arm_step(jm, BASE_POS, BASE_QUAT, KP, KD, GRAV, DT)
    consts = A.build_arm_constants(pm, KP, KD, GRAV, DT)
    return pm, pallas, consts


def _inputs(seed, q_range=0.8, qd_range=2.0):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-q_range, q_range, (B, 7)).astype(np.float32)
    qd = rng.uniform(-qd_range, qd_range, (B, 7)).astype(np.float32)
    tgt = rng.uniform(-1.0, 1.0, (B, 7)).astype(np.float32)
    return q, qd, tgt, np.zeros((B, 7), np.float32)


def _base():
    return (torch.as_tensor(np.tile(BASE_POS, (B, 1))),
            torch.as_tensor(np.tile(BASE_QUAT, (B, 1))))


def test_plain_k1_matches_the_pallas_k1(k1):
    pm, pallas, consts = k1
    ins = _inputs(0)
    want = pallas(*[jnp.asarray(a) for a in ins])
    got = A.ArmStep(consts)(*[torch.as_tensor(a) for a in ins], *_base())
    for f in A.ArmStepOutputs._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=TOL[f], err_msg=f)


def test_plain_k1_factor_reconstructs_the_mass_matrix(k1):
    pm, pallas, consts = k1
    q = torch.as_tensor(np.random.RandomState(1).uniform(-0.5, 0.5, (B, 7)).astype(np.float32))
    z = torch.zeros(B, 7)
    out = A.arm_step_plain(consts, q, z, z, z, *_base())
    bp, bq = _base()
    fp, fq, com, ax, Iw = D.link_geometry(pm, bp, bq, q)
    M = D.mass_matrix(pm, *D.jacobians(pm, fp, ax, com, bp), Iw).double().numpy()
    L = np.zeros((B, 7, 7))
    L[:, np.tril_indices(7)[0], np.tril_indices(7)[1]] = out.chol.double().numpy()
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), M, atol=TOL["chol"])
    # the factor as the contact phase solves with it (unpack_chol's rows)
    rhs = torch.randn(B, 7, 5, generator=torch.Generator().manual_seed(0))
    x = chol_solve(A.unpack_chol(out.chol, 7), rhs)
    np.testing.assert_allclose((torch.as_tensor(M) @ x.double()).numpy(), rhs.numpy(),
                               atol=1e-4)


def test_k1_body_in_the_host_loop_matches_the_plain_version(k1):
    pm, _, consts = k1
    lib = _build.build_host_library()
    for seed, q_range in ((0, 0.8), (2, 3.0)):   # 3 rad drives joints into their limits
        ins = [torch.as_tensor(a) for a in _inputs(seed, q_range, 6.0)] + list(_base())
        want = A.arm_step_plain(consts, *ins)
        x = A.pack_inputs(*ins)
        y = torch.empty(A.n_out(7), B)
        c = torch.as_tensor(consts)
        assert lib.igt_arm_step_host(c.data_ptr(), x.data_ptr(), y.data_ptr(), B, 7) == 0
        got = A.unpack_outputs(y, 7)
        for f in A.ArmStepOutputs._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                       rtol=0, atol=HOST_TOL, err_msg=f)
    ops = lib.igt_arm_step_count_ops(c.data_ptr(), x.data_ptr(), y.data_ptr(), B, 7)
    assert 3000 < ops / B < 20000


def test_k1_integrates_a_bounded_trajectory(k1):
    """120 substeps under gravity and PD to zero targets stay finite and
    bounded (``tests/test_pallas_dynamics.py:99``)."""
    _, _, consts = k1
    k = A.ArmStep(consts)
    q = qd = z = torch.zeros(B, 7)
    for _ in range(120):
        out = k(q, qd, z, z, *_base())
        q, qd = out.q_new, out.qd_new
    assert torch.isfinite(q).all() and torch.isfinite(qd).all()
    assert float(qd.abs().max()) < 50.0


def test_k1_wrapper_checks_its_inputs(k1):
    _, _, consts = k1
    k = A.ArmStep(consts)
    ins = [torch.zeros(4, 7)] * 4 + [torch.zeros(4, 3), torch.zeros(4, 4)]
    with pytest.raises(ValueError, match="float32"):
        k(*[t.double() for t in ins])
    with pytest.raises(ValueError, match=r"\(4, 4\)"):
        k(*ins[:5], torch.zeros(4, 3))
    with pytest.raises(ValueError, match="no kernel for device"):
        k(*[t.to("meta") for t in ins])
    with pytest.raises(ValueError, match="CUDA"):
        k.launch(A.pack_inputs(*ins))
    assert k.launches == 0


def test_k1_refuses_other_dof_counts():
    A.check_nd(A.KERNEL_ND)
    with pytest.raises(NotImplementedError, match="built for 7 DOFs, the articulation has 6"):
        A.check_nd(6)
