"""K1, the arm step: wrapper, plain version and the constant pack.

One launch computes one substep of fixed-base dynamics for one articulation,
as ``isaacgym_tpu/ops/pallas_dynamics.py:447`` (``build_arm_step``) does:
PD drive with the effort clamp -> FK -> world inertias -> mass matrix with
the static ancestor masks -> RNEA bias at q̈ = 0 -> Cholesky ->
semi-implicit Euler with the velocity clamp and the joint limits -> FK at
the new q. It returns what the non-kernel contact phase of
``sim/simulator.py`` consumes (``ArmStepOutputs``, ``pallas_dynamics.py:438``):
the new q, the joint velocities before any contact, the drive torques, the
post-step DOF frames and the packed Cholesky factor.

The Pallas kernel folds the base pose in as a constant. Here the pack
(``build_arm_constants``: K2's header, DOF table and ancestor mask, the
slots of ``ops/fused_substep.py``) carries no pose: the base position and
quaternion are per-env inputs, so one pack serves any base pose. The CUDA
kernel (``csrc/arm_step.cu``) runs K2's dynamics phases
(``csrc/art_warp.cuh``), two envs to a warp; ``arm_step_plain`` is K2's
plain dynamics phase (``fused_substep.art_dynamics``) on those inputs, the
kernel's order. ``ArmStep`` takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops.dynamics import ArticulationModel

KERNEL_ND = 7    # the DOF count the kernel is instantiated for


def check_nd(nd: int) -> None:
    """Raise unless the kernel is instantiated for ``nd`` DOFs."""
    if nd != KERNEL_ND:
        raise NotImplementedError(f"arm step kernel is built for {KERNEL_ND} DOFs, "
                                  f"the articulation has {nd}")


class ArmStepOutputs(NamedTuple):
    q_new: torch.Tensor       # (B, nd)
    qd_new: torch.Tensor      # (B, nd) before any contact
    tau: torch.Tensor         # (B, nd)
    frame_pos: torch.Tensor   # (B, nd, 3) post-step
    frame_quat: torch.Tensor  # (B, nd, 4)
    chol: torch.Tensor        # (B, nd (nd + 1) / 2) packed lower factor, row by row


def n_in(nd: int) -> int:
    """Input rows: q, qd, targets, efforts (nd each), base position, base
    quaternion."""
    return 4 * nd + 7


def n_out(nd: int) -> int:
    """Output rows: q, qd, tau (nd each), frame positions (3 nd), frame
    quaternions (4 nd), the factor."""
    return 10 * nd + nd * (nd + 1) // 2


def build_arm_constants(model: ArticulationModel, kp, kd, gravity, dt_s: float) -> np.ndarray:
    """The articulation's constants in K2's layout up to its ancestor mask
    (header, DOF table, mask); the base-pose slots stay zero. Position drive,
    as the Pallas K1 always is."""
    F.check_supported(model)
    nd = model.tree.n_dof
    c = np.zeros(F.layout(nd)["static"], np.float64)
    F.pack_header(c, nd, dt_s, gravity, 0.0, 0.0, 0, 0, 0, 0)
    F.pack_articulation(c, model, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.0), kp, kd)
    return c.astype(np.float32)


def unpack_chol(packed, nd: int):
    """(B, nd (nd + 1) / 2) packed factor -> nested rows ``L[i][j]`` of (B,)
    tensors, the form ``ops.linalg.chol_solve`` takes (``:718``)."""
    out, t = [], 0
    for i in range(nd):
        out.append(tuple(packed[:, t + j] for j in range(i + 1)))
        t += i + 1
    return tuple(out)


def arm_step_plain(consts, q, qd, targets, efforts, base_pos, base_quat) -> ArmStepOutputs:
    """Plain PyTorch version of K1 on (B, n) inputs of any float type, the
    kernel's arithmetic and order (K2's dynamics phase with the base pose
    as a per-env channel)."""
    k = F.as_list(consts)
    nd = int(k[F.C_ND])
    for i in range(3):
        k[F.C_BASE_P + i] = base_pos[:, i]
    for i in range(4):
        k[F.C_BASE_Q + i] = base_quat[:, i]
    cols = lambda t: [t[:, d] for d in range(nd)]
    tau, q_new, art = F.art_dynamics(k, nd, cols(q), cols(qd), cols(targets), cols(efforts))
    fp = torch.stack([F.stack(p) for p in art.fp], dim=1)
    fq = torch.stack([F.stack(p) for p in art.fq], dim=1)
    chol = torch.stack([art.L[i][j] for i in range(nd) for j in range(i + 1)], dim=1)
    return ArmStepOutputs(F.stack(q_new), F.stack(art.u), F.stack(tau), fp, fq, chol)


def check_library_layout(lib, nd: int) -> None:
    """Raise unless the library's DOF table and mask sit where the pack
    puts them."""
    out = (ctypes.c_int * 16)()
    if lib.igt_arm_layout(nd, ctypes.addressof(out), 16) != 0:
        raise RuntimeError(f"arm step library rejects nd={nd}")
    lay = F.layout(nd)
    if (out[0], out[1], out[2]) != (lay["dof"], lay["mask"], lay["static"]):
        raise RuntimeError(f"arm step layout mismatch: C {list(out[:3])} vs Python {lay}")


def pack_inputs(q, qd, targets, efforts, base_pos, base_quat):
    """(B, n) inputs -> one (n_in, B) channel-major buffer."""
    return torch.cat([q, qd, targets, efforts, base_pos, base_quat], dim=1).t().contiguous()


def unpack_outputs(y, nd: int) -> ArmStepOutputs:
    """(n_out, B) channel-major buffer -> (B, ...) views."""
    yt = y.t()
    B = yt.shape[0]
    return ArmStepOutputs(yt[:, 0:nd], yt[:, nd:2 * nd], yt[:, 2 * nd:3 * nd],
                          yt[:, 3 * nd:6 * nd].reshape(B, nd, 3),
                          yt[:, 6 * nd:10 * nd].reshape(B, nd, 4), yt[:, 10 * nd:])


class ArmStep:
    """K1 for one articulation: holds the constant pack and counts kernel
    launches. ``__call__`` takes (B, nd) q, qd, targets, efforts and the
    (B, 3) base position and (B, 4) base quaternion in float32. On CPU
    tensors it runs :func:`arm_step_plain`; on CUDA tensors it launches
    ``csrc/arm_step.cu`` on the current stream (building the library at
    first use) and adds one to ``launches``; anything else raises."""

    def __init__(self, consts: np.ndarray):
        self.consts = np.asarray(consts, np.float32)
        self.nd = int(self.consts[F.C_ND])
        self.launches = 0
        self._dev_consts = {}
        self._lib = None
        self._checked = {}   # id -> the libraries whose layout matched

    def device_consts(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = torch.as_tensor(self.consts, device=device)
        return self._dev_consts[key]

    def __call__(self, q, qd, targets, efforts, base_pos, base_quat) -> ArmStepOutputs:
        ins = (q, qd, targets, efforts, base_pos, base_quat)
        B, nd = q.shape[0], self.nd
        for t, w in zip(ins, (nd, nd, nd, nd, 3, 4)):
            if t.dtype != torch.float32 or t.dim() != 2 or tuple(t.shape) != (B, w):
                raise ValueError(f"arm step: expected float32 ({B}, {w}), got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != q.device:
                raise ValueError("arm step: inputs on different devices")
        if q.device.type == "cpu":
            return arm_step_plain(self.consts, *ins)
        if q.device.type != "cuda":
            raise ValueError(f"arm step: no kernel for device {q.device}")
        return self.launch(pack_inputs(*ins))

    def launch(self, x: torch.Tensor) -> ArmStepOutputs:
        """Launch the kernel on a packed (n_in, B) CUDA buffer."""
        y = torch.empty((n_out(self.nd), x.shape[1]), dtype=torch.float32, device=x.device)
        self.launcher(x, y)()
        return unpack_outputs(y, self.nd)

    def launcher(self, x: torch.Tensor, y: torch.Tensor, lib=None):
        """The kernel's launch on a packed (n_in, B) CUDA buffer ``x`` into
        the (n_out, B) CUDA buffer ``y``, both checked here, once: each call
        of the returned function launches on the stream current now and adds
        one to ``launches``. ``lib``: another build of the library (a parent
        tree's, a probe's copy), checked against this pack's layout; this
        package's by default, built at first use."""
        from isaacgym_tpu_torch.ops import _build
        nd = self.nd
        check_nd(nd)
        for t, rows in ((x, n_in(nd)), (y, n_out(nd))):
            if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
                    or t.shape[0] != rows or t.shape[1] != x.shape[1] or x.shape[1] < 1
                    or not t.is_contiguous()):
                raise ValueError(f"arm step: expected a contiguous float32 CUDA "
                                 f"({rows}, B) buffer, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        if lib is None:
            if self._lib is None:
                self._lib = _build.cuda_library("arm_step")
            lib = self._lib
        if id(lib) not in self._checked:
            check_library_layout(lib, nd)
            self._checked[id(lib)] = lib
        args = (self.device_consts(x.device).data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1],
                nd, torch.cuda.current_stream(x.device).cuda_stream)

        def run():
            err = lib.igt_arm_step_launch(*args)
            if err != 0:
                raise RuntimeError(f"arm step launch failed: cudaError {err}")
            self.launches += 1
        return run
