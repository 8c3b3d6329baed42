"""K4, the fused substep of one floating-base humanoid with one ball (the
27-DOF whole-body C10 scene): wrapper, plain version and the constant pack.

One launch computes the whole substep, as
``isaacgym_tpu/ops/pallas_dynamics.py:2225`` (``build_fused_substep_floating``,
``with_torque=False``) does: PD or effort drive with the effort clamp -> FK
from the runtime base pose -> velocity and bias propagation with the base
composite link -> Jacobian columns over ``u = [omega, v, qdot]`` (nv = nd + 6)
-> mass matrix -> nv x nv Cholesky -> semi-implicit Euler with the base
velocity clamps, the DOF velocity clamp, joint limits and the base quaternion
integration -> FK at the new pose -> ball flight, plane and static contacts
-> ball contacts with every articulated geom, each reaction going into the
whole generalized velocity (the base too) through the factor -> articulated
geoms against the true statics (Baumgarte, exact support, the 2 mm resting
band) -> articulated geoms against the ground plane -> ball caps and
integration.

Every articulated geom, the two welded to the base included (link -1),
moves with the runtime base pose; only the true statics (table, net) are
scene constants. The pack (``build_floating_constants``) keeps K2's header,
DOF table, ancestor mask and entry layouts (``fused_substep.py``) and adds
the base composite link's block, K4's header slots and room for 16
articulated geoms; every art-static pair is kept (a floating base has no
build-time reach pruning). The CUDA kernel (``csrc/fused_substep_floating.cu``)
reads it from device memory, so one nvcc build serves every such scene.

``floating_substep_plain`` is the plain PyTorch version over (B, n)
inputs, float32 or float64. It repeats the kernel's arithmetic in the
kernel's order, vectorized only where the order is not changed: the mass
matrix and the bias accumulate link by link over every column pair at once,
the Cholesky factor column by column, the triangular solves and the sums
over the generalized velocity one index at a time; the contacts follow in
the kernel's order with ``torch.where`` for its branches. So on float32
inputs it rounds as the kernel does but for the transcendentals, and the
card's check credits the kernel with no more than the plain version's own
float32 rounding (``chip_smoke.py``, ``compare``): a 33 x 33 solve with
velocities of a few hundred rad/s in a falling ragdoll amplifies a
different summation order past the 1e-3 gates. ``FusedSubstepFloating``
takes it only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops.dynamics import ArticulationModel
from isaacgym_tpu_torch.ops.fused_substep import (
    A_KIND, A_LINK, A_OFF_POS, A_OFF_QUAT, A_RBOUND, A_SIZE, A_E, A_MU, ART_STRIDE,
    C_BOUNCE, C_BIAS_K, C_DRIVE, C_DT, C_E_BALL, C_GX, C_GY, C_GZ, C_INV_MB, C_KAPPA,
    C_KAPPA_INVMB_OVER_RB, C_MAX_DEPEN, C_MB, C_MU_BALL, C_ND, C_NSTATIC, C_NART, C_NPAIR,
    C_RB, C_WT0, C_DT_QUARTER, D_ARMATURE, D_AXIS, D_COM, D_EFFORT, D_HI, D_INERTIA, D_KD,
    D_KP, D_LO, D_MASS, D_MAXVEL, D_PARENT, D_PRE_POS, D_PRE_QUAT, D_REV, DOF_OFF,
    DOF_STRIDE, G_E, G_KIND, G_MU, G_POS, G_ROT, G_SIZE, P_ART, P_E, P_EXACT, P_MU,
    P_STATIC, PAIR_STRIDE, RESTING_SMOOTH_BAND, STATIC_STRIDE,
)

# ---------------------------------------------------------------------------
# constant-pack layout (mirrors csrc/fused_substep_floating.cuh)
# ---------------------------------------------------------------------------

KERNEL_ND = 27           # the one DOF count the CUDA library is built for
MAX_STATIC = 16
MAX_ART = 16
MAX_PAIRS = 64
# K4's header slots past K2's (0 .. 40)
C_BASE_MAX_ANG = 41      # the base's angular velocity clamp (0: none)
C_BASE_MAX_LIN = 42      # the base's linear velocity clamp (0: none)
C_E_GND = 43             # art-vs-ground restitution, 0.5 (0 + plane e)
C_MU_GND = 44            # art-vs-ground friction, 0.5 (0.8 + plane mu)
C_ART_STATIC = 45        # 1: art-vs-static contacts on
# the base composite link's block
BASE_STRIDE = 16
B_MASS, B_COM, B_INERTIA = 0, 1, 4


def layout(nd: int) -> dict:
    """Offsets of the pack's blocks for an ``nd``-DOF floating articulation."""
    mask = DOF_OFF + nd * DOF_STRIDE
    base = mask + nd * nd
    static = base + BASE_STRIDE
    art = static + MAX_STATIC * STATIC_STRIDE
    pair = art + MAX_ART * ART_STRIDE
    return dict(dof=DOF_OFF, mask=mask, base=base, static=static, art=art, pair=pair,
                total=pair + MAX_PAIRS * PAIR_STRIDE)


def n_in(nd: int) -> int:
    """Input channels: q, qd, targets, efforts (nd each), base pos, quat,
    linvel, angvel (3, 4, 3, 3), ball pos, vel, omega (3 each)."""
    return 4 * nd + 22


def n_out(nd: int, ng: int) -> int:
    """Output channels: q, qd, tau, the base's pos, quat, linvel, angvel, the
    ball's pos, vel, omega, then ng + 1 impulse rows."""
    return 3 * nd + 22 + 3 * (ng + 1)


# ---------------------------------------------------------------------------
# constant packing (the trace-time half of pallas_dynamics.py:2225-2304)
# ---------------------------------------------------------------------------

def check_supported(model: ArticulationModel) -> None:
    tree = model.tree
    if not model.floating or not np.all((tree.dof_type == U.JOINT_REVOLUTE)
                                        | (tree.dof_type == U.JOINT_PRISMATIC)):
        raise NotImplementedError("floating fused substep: floating base, "
                                  "revolute/prismatic only")


def build_floating_constants(model: ArticulationModel, kp, kd, gravity, dt_s: float,
                             ball_cfg: dict, static_geoms: list, art_geoms: list,
                             plane_cfg: dict, *, bounce_threshold: float = 0.2,
                             drive_mode: int = 0, max_angular_velocity: float = 64.0,
                             max_linear_velocity: float = 1000.0, art_static: bool = True,
                             exact_support: bool = False) -> np.ndarray:
    """Pack the scene's constants into one float32 array.

    Arguments are those of ``build_fused_substep_floating``: ``ball_cfg`` as
    ``fused_substep.build_constants`` takes it; ``static_geoms`` the true
    statics (kind, pos, quat, size, e, mu in the world frame); ``art_geoms``
    every articulated geom (kind, link with -1 for the base, off_pos,
    off_quat, size, e, mu, radius_bound); ``plane_cfg`` the ground's e, mu
    and max_depen for the articulated geoms' ground contacts."""
    check_supported(model)
    nd = model.tree.n_dof
    if (len(static_geoms) > MAX_STATIC or len(art_geoms) > MAX_ART
            or len(static_geoms) * len(art_geoms) > MAX_PAIRS):
        raise ValueError(f"scene exceeds K4's maxima: {len(static_geoms)} static "
                         f"(max {MAX_STATIC}), {len(art_geoms)} art (max {MAX_ART}), "
                         f"{len(static_geoms) * len(art_geoms)} pairs (max {MAX_PAIRS})")
    lay = layout(nd)
    c = np.zeros(lay["total"], np.float64)
    n_pair = len(art_geoms) * len(static_geoms) if art_static else 0
    F.pack_header(c, nd, dt_s, gravity, bounce_threshold,
                  float(plane_cfg.get("max_depen", 10.0)), len(static_geoms),
                  len(art_geoms), n_pair, len(static_geoms))
    F.pack_ball(c, ball_cfg, dt_s)
    F.pack_articulation(c, model, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), kp, kd, drive_mode)
    for d in range(nd):   # the model's armature leads with the base's six zeros
        c[DOF_OFF + d * DOF_STRIDE + D_ARMATURE] = model.armature[6 + d]
    c[C_BASE_MAX_ANG] = float(max_angular_velocity)
    c[C_BASE_MAX_LIN] = float(max_linear_velocity)
    c[C_E_GND] = 0.5 * (0.0 + float(plane_cfg["e"]))
    c[C_MU_GND] = 0.5 * (0.8 + float(plane_cfg["mu"]))
    c[C_ART_STATIC] = float(bool(art_static))
    b = lay["base"]
    c[b + B_MASS] = model.link_mass[nd]
    c[b + B_COM:b + B_COM + 3] = model.link_com[nd]
    c[b + B_INERTIA:b + B_INERTIA + 9] = model.link_inertia_com[nd].reshape(9)
    e_ball, mu_ball = c[C_E_BALL], c[C_MU_BALL]
    for si, g in enumerate(static_geoms):
        o = lay["static"] + si * STATIC_STRIDE
        F.pack_static_geom(c[o:o + STATIC_STRIDE], g)
        c[o + G_E] = 0.5 * (e_ball + float(g["e"]))
        c[o + G_MU] = 0.5 * (mu_ball + float(g["mu"]))
    for gi, g in enumerate(art_geoms):
        o = lay["art"] + gi * ART_STRIDE
        F.pack_art_geom(c[o:o + ART_STRIDE], g)
        c[o + A_E] = 0.5 * (e_ball + float(g["e"]))
        c[o + A_MU] = 0.5 * (mu_ball + float(g["mu"]))
    if art_static:
        for pi, (gi, si) in enumerate((gi, si) for gi in range(len(art_geoms))
                                      for si in range(len(static_geoms))):
            o = lay["pair"] + pi * PAIR_STRIDE
            F.pack_pair(c[o:o + PAIR_STRIDE], gi, si, art_geoms[gi], static_geoms[si],
                        exact_support)
    return c.astype(np.float32)


class FloatingStepOutputs(NamedTuple):
    """K4's outputs (``pallas_dynamics.py:2206``)."""
    q_new: torch.Tensor        # (B, nd)
    qd_new: torch.Tensor       # (B, nd) post-contact
    tau: torch.Tensor          # (B, nd)
    base_pos: torch.Tensor     # (B, 3)
    base_quat: torch.Tensor    # (B, 4)
    base_linvel: torch.Tensor  # (B, 3) post-contact
    base_angvel: torch.Tensor  # (B, 3) post-contact
    ball_pos: torch.Tensor     # (B, 3)
    ball_vel: torch.Tensor     # (B, 3)
    ball_omega: torch.Tensor   # (B, 3)
    impulses: torch.Tensor     # (B, ng+1, 3): per art geom body (its ball reaction
    #                            and art-vs-static impulses), then the ball's total


# ---------------------------------------------------------------------------
# plain PyTorch version: 3-vectors and quaternions on the last dimension
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.stack((a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _qrot(q, v):
    """v + 2w(u x v) + u x (2 u x v), K2's association."""
    t = 2.0 * _cross(q[..., :3], v)
    return v + q[..., 3:4] * t + _cross(q[..., :3], t)


def _qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(((aw * bx + ax * bw) + (ay * bz - az * by),
                        (aw * by + ay * bw) + (az * bx - ax * bz),
                        (aw * bz + az * bw) + (ax * by - ay * bx),
                        aw * bw - ((ax * bx + ay * by) + az * bz)), -1)


def _rotmat(q):
    """Rows of the rotation matrix of ``q``: R[i][j] (..., ) tensors."""
    x, y, z, w = q.unbind(-1)
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def _world_inertia(R, I):
    """R I R^T in the kernel's order: RI = R I, then the upper triangle of
    RI R^T, mirrored. ``I`` (..., 3, 3) constants; returns rows of (...)."""
    RI = [[R[i][0] * I[..., 0, j] + R[i][1] * I[..., 1, j] + R[i][2] * I[..., 2, j]
           for j in range(3)] for i in range(3)]
    Iw = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]
            Iw[j][i] = Iw[i][j]
    return Iw


def _mat_vec(Iw, v):
    """Rows ``Iw`` (each (...,)) times v (..., 3)."""
    return torch.stack([Iw[i][0] * v[..., 0] + Iw[i][1] * v[..., 1] + Iw[i][2] * v[..., 2]
                        for i in range(3)], -1)


def _sqrt_floor(x, floor):
    return torch.sqrt(torch.clamp(x, min=floor))


def _ch(v):
    """(B, 3) -> K2's plain version's tuple of (B,) channels."""
    return tuple(v.unbind(-1))


def _st(t):
    return torch.stack(tuple(t), -1)


class _Scene:
    """The pack's constants as tensors of the inputs' type and device."""

    def __init__(self, consts, like):
        self.k = F.as_list(consts)
        k = self.k
        self.nd = nd = int(k[C_ND])
        self.nv, self.nl = nd + 6, nd + 1
        self.lay = lay = layout(nd)
        t = torch.as_tensor(np.asarray(k, np.float32), dtype=like.dtype, device=like.device)
        self.t = t
        dof = torch.arange(nd) * DOF_STRIDE + DOF_OFF
        col = lambda s, n=1: t[(dof[:, None] + s + torch.arange(n)).to(like.device)]
        self.parent = [int(k[DOF_OFF + d * DOF_STRIDE + D_PARENT]) for d in range(nd)]
        self.rev_list = [k[DOF_OFF + d * DOF_STRIDE + D_REV] != 0.0 for d in range(nd)]
        self.rev = col(D_REV)[:, 0] != 0
        self.pre_pos, self.pre_quat = col(D_PRE_POS, 3), col(D_PRE_QUAT, 4)
        self.axis = col(D_AXIS, 3)
        b = lay["base"]
        self.mass = torch.cat([col(D_MASS)[:, 0], t[b + B_MASS:b + B_MASS + 1]])
        self.com = torch.cat([col(D_COM, 3), t[b + B_COM:b + B_COM + 3][None]])
        self.inertia = torch.cat([col(D_INERTIA, 9), t[b + B_INERTIA:b + B_INERTIA + 9][None]]
                                 ).reshape(self.nl, 3, 3)
        self.armature = torch.cat([torch.zeros(6, dtype=t.dtype, device=t.device),
                                   col(D_ARMATURE)[:, 0]])
        self.kp, self.kd, self.effort = col(D_KP)[:, 0], col(D_KD)[:, 0], col(D_EFFORT)[:, 0]
        self.lo, self.hi, self.maxvel = col(D_LO)[:, 0], col(D_HI)[:, 0], col(D_MAXVEL)[:, 0]
        self.mask = t[lay["mask"]:lay["mask"] + nd * nd].reshape(nd, nd)   # (link, dof)
        self.eye = torch.eye(3, dtype=t.dtype, device=t.device)

    def entry(self, block, i, stride):
        o = self.lay[block] + i * stride
        return self.k[o:o + stride]


def _fk(s: _Scene, q, bp, bq):
    """DOF frames (B, nd, 3/4) and world axes from the base pose ``bp``, ``bq``."""
    fp, fq, ax = [], [], []
    for d in range(s.nd):
        par = s.parent[d]
        pp, pq = (bp, bq) if par < 0 else (fp[par], fq[par])
        jp = pp + _qrot(pq, s.pre_pos[d].expand_as(pp))
        jq = _qmul(pq, s.pre_quat[d].expand_as(pq))
        a = s.axis[d].expand_as(pp)
        if s.rev_list[d]:
            half = 0.5 * q[:, d:d + 1]
            fq.append(_qmul(jq, torch.cat([a * torch.sin(half), torch.cos(half)], -1)))
            fp.append(jp)
        else:
            fq.append(jq)
            fp.append(jp + _qrot(jq, a) * q[:, d:d + 1])
        ax.append(_qrot(fq[d], a))
    return torch.stack(fp, 1), torch.stack(fq, 1), torch.stack(ax, 1)


def _chol(M):
    """Lower Cholesky factor of (B, n, n) M (its lower triangle read), column
    by column with the kernel's 1e-12 floor under each pivot; each entry's
    sum runs over k ascending, as the kernel's does."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        col = M[:, j:, j]
        for k in range(j):
            col = col - L[:, j:, k] * L[:, j, k:k + 1]
        dia = _sqrt_floor(col[:, 0], 1e-12)
        L[:, j, j] = dia
        L[:, j + 1:, j] = col[:, 1:] * (1.0 / dia)[:, None]
    return L


def _fwd(L, b):
    """L y = b for (B, n) or (B, n, k) right-hand sides; row i subtracts
    L[i][j] y[j] over j ascending, as the kernel does."""
    s = b.clone()
    y = torch.zeros_like(b)
    n = b.shape[1]
    for j in range(n):
        y[:, j] = s[:, j] / (L[:, j, j] if b.dim() == 2 else L[:, j, j, None])
        if b.dim() == 2:
            s[:, j + 1:] = s[:, j + 1:] - L[:, j + 1:, j] * y[:, j:j + 1]
        else:
            s[:, j + 1:] = s[:, j + 1:] - L[:, j + 1:, j, None] * y[:, j:j + 1]
    return y


def _back(L, y):
    """L^T x = y; row i subtracts L[j][i] x[j] over j descending, as the
    kernel does."""
    s = y.clone()
    x = torch.zeros_like(y)
    for j in reversed(range(y.shape[1])):
        x[:, j] = s[:, j] / L[:, j, j]
        s[:, :j] = s[:, :j] - L[:, j, :j] * x[:, j:j + 1]
    return x


def _sum_sq(y):
    """sum_k y[:, k]^2 over k ascending."""
    acc = torch.zeros_like(y[:, 0])
    for k in range(y.shape[1]):
        acc = acc + y[:, k] * y[:, k]
    return acc


class _Art:
    """The articulation after its dynamics: post-step base pose and frames,
    the factor ``L`` and the generalized velocity ``u`` the contacts change."""

    def __init__(self, s: _Scene, L, u, bp, bq, frames):
        self.s, self.L, self.u, self.bp, self.bq = s, L, u, bp, bq
        self.fp, self.fq, self.ax = frames

    def link_pose(self, link):
        if link < 0:
            return self.bp, self.bq
        return self.fp[:, link], self.fq[:, link]

    def cols(self, link, point):
        """(B, nv, 3) Jacobian columns of a world point on ``link``."""
        s = self.s
        B = point.shape[0]
        r = point - self.bp
        ang = _cross(s.eye.expand(B, 3, 3), r[:, None, :].expand(B, 3, 3))
        lin = s.eye.expand(B, 3, 3)
        if link < 0:
            dof = torch.zeros((B, s.nd, 3), dtype=point.dtype, device=point.device)
        else:
            rv = _cross(self.ax, point[:, None, :] - self.fp)
            dof = torch.where(s.rev[None, :, None], rv, self.ax) * s.mask[link][None, :, None]
        return torch.cat([ang, lin, dof], 1)

    def point_vel(self, cols):
        """sum_c cols[c] u[c] over c ascending."""
        v = torch.zeros_like(cols[:, 0])
        for c in range(cols.shape[1]):
            v = v + cols[:, c] * self.u[:, c:c + 1]
        return v

    def solve_dirs(self, cols, n, t_hat):
        """L^-1 J^T n and L^-1 J^T t_hat -> (yn, yt); the caller then forms
        du = L^-T (yn Pn' + yt Pt') with :meth:`apply`."""
        jv = torch.stack([_dot(cols, n[:, None]), _dot(cols, t_hat[:, None])], -1)
        y = _fwd(self.L, jv)
        return y[..., 0], y[..., 1]

    def apply(self, rhs):
        self.u = self.u + _back(self.L, rhs)


def _dynamics(s: _Scene, q, qd, targets, efforts, bp, bq, v_base, w_base):
    """Drive -> FK -> bias and mass matrix -> Cholesky -> Euler with the
    clamps, limits and base integration -> FK at the new pose.
    Returns (tau, q_new, _Art)."""
    k = s.k
    nd, nl = s.nd, s.nl
    dt = k[C_DT]
    B = q.shape[0]
    zero3 = torch.zeros_like(bp)
    if k[C_DRIVE] != 0.0:
        t = efforts
    else:
        t = s.kp * (targets - q) - s.kd * qd + efforts
    tau = torch.clamp(t, -s.effort, s.effort)

    fp, fq, ax = _fk(s, q, bp, bq)
    # velocity / bias propagation (u-dot = 0) from the base (omega, 0, 0)
    w, wd, ao = [], [], []
    for d in range(nd):
        par = s.parent[d]
        if par < 0:
            w_p, wd_p, ao_p, o_p = w_base, zero3, zero3, bp
        else:
            w_p, wd_p, ao_p, o_p = w[par], wd[par], ao[par], fp[:, par]
        r = fp[:, d] - o_p
        ao_d = ao_p + (_cross(wd_p, r) + _cross(w_p, _cross(w_p, r)))
        a = ax[:, d]
        if s.rev_list[d]:
            w.append(w_p + a * qd[:, d:d + 1])
            wd.append(wd_p + _cross(w_p, a) * qd[:, d:d + 1])
        else:
            w.append(w_p)
            wd.append(wd_p)
            ao_d = ao_d + _cross(w_p, a) * (2.0 * qd[:, d:d + 1])
        ao.append(ao_d)
    # links 0 .. nd-1 ride their DOF frames; link nd is the base composite
    org = torch.cat([fp, bp[:, None]], 1)
    orient = torch.cat([fq, bq[:, None]], 1)
    w = torch.stack(w + [w_base], 1)
    wd = torch.stack(wd + [zero3], 1)
    ao = torch.stack(ao + [zero3], 1)
    com = org + _qrot(orient, s.com.expand(B, nl, 3))
    Iw = _world_inertia(_rotmat(orient), s.inertia)             # rows of (B, nl)
    rc = com - org
    a_com = ao + (_cross(wd, rc) + _cross(w, _cross(w, rc)))
    g = s.t[C_GX:C_GZ + 1]
    f = (a_com - g) * s.mass[:, None]
    n = _mat_vec(Iw, wd) + _cross(w, _mat_vec(Iw, w))

    # Jacobian columns at each link COM, (B, nl, nv, 3): the base's angular
    # and linear columns, then the ancestors' (zero elsewhere)
    E = s.eye
    mask = torch.cat([s.mask, torch.zeros_like(s.mask[:1])], 0)       # (nl, nd)
    j_ang = torch.cat([E.expand(B, nl, 3, 3),
                       torch.zeros((B, nl, 3, 3), dtype=q.dtype, device=q.device),
                       (ax[:, None] * (mask * s.rev)[None, :, :, None])], 2)
    rel = com[:, :, None, :] - fp[:, None, :, :]                        # (B, nl, nd, 3)
    dof_lin = torch.where(s.rev[None, None, :, None],
                          _cross(ax[:, None].expand_as(rel), rel), ax[:, None].expand_as(rel))
    r_b = (com - bp[:, None])[:, :, None, :].expand(B, nl, 3, 3)
    j_lin = torch.cat([_cross(E.expand(B, nl, 3, 3), r_b), E.expand(B, nl, 3, 3),
                       dof_lin * mask[None, :, :, None]], 2)
    # the bias and the mass matrix accumulate link by link, as the kernel's
    # (an inactive column adds an exact zero)
    acc = torch.zeros((B, nd + 6), dtype=q.dtype, device=q.device)
    M = torch.zeros((B, nd + 6, nd + 6), dtype=q.dtype, device=q.device)
    for l in range(nl):
        ja, jl = j_ang[:, l], j_lin[:, l]                               # (B, nv, 3)
        acc = acc + (_dot(ja, n[:, l, None]) + _dot(jl, f[:, l, None]))
        ija = _mat_vec([[Iw[i][j][:, l, None] for j in range(3)] for i in range(3)], ja)
        M = M + (_dot(ja[:, :, None], ija[:, None]) + s.mass[l] * _dot(jl[:, :, None],
                                                                      jl[:, None]))
    tau_gen = torch.cat([torch.zeros((B, 6), dtype=q.dtype, device=q.device), tau], 1)
    rhs = tau_gen - acc
    M = M + torch.diag(s.armature)
    L = _chol(M)
    udot = _back(L, _fwd(L, rhs))

    # semi-implicit Euler: base velocity clamps, DOF clamp and limits
    w_n = w_base + dt * udot[:, 0:3]
    if k[C_BASE_MAX_ANG] > 0.0:
        w_n = torch.clamp(w_n, -k[C_BASE_MAX_ANG], k[C_BASE_MAX_ANG])
    v_n = v_base + dt * udot[:, 3:6]
    if k[C_BASE_MAX_LIN] > 0.0:
        v_n = torch.clamp(v_n, -k[C_BASE_MAX_LIN], k[C_BASE_MAX_LIN])
    v = qd + dt * udot[:, 6:]
    v = torch.where(s.maxvel > 0.0, torch.clamp(v, -s.maxvel, s.maxvel), v)
    p = q + dt * v
    at_lo, at_hi = p < s.lo, p > s.hi
    p = torch.clamp(p, s.lo, s.hi)
    v = torch.where(at_lo, torch.clamp(v, min=0.0), v)
    v = torch.where(at_hi, torch.clamp(v, max=0.0), v)
    bp2 = bp + v_n * dt
    dq = _qmul(torch.cat([w_n, torch.zeros_like(w_n[:, :1])], 1), bq)
    bq2 = bq + (0.5 * dt) * dq
    x_, y_, z_, w_ = bq2.unbind(-1)
    nrm = _sqrt_floor(x_ * x_ + y_ * y_ + z_ * z_ + w_ * w_, 1e-12)[:, None]
    bq2 = bq2 / nrm
    u = torch.cat([w_n, v_n, v], 1)
    return tau, p, _Art(s, L, u, bp2, bq2, _fk(s, p, bp2, bq2))


def _geom_pose(art: _Art, kg):
    lp, lq = art.link_pose(int(kg[A_LINK]))
    dev = dict(dtype=lp.dtype, device=lp.device)
    gp = lp + _qrot(lq, torch.tensor(kg[A_OFF_POS:A_OFF_POS + 3], **dev).expand_as(lp))
    gq = _qmul(lq, torch.tensor(kg[A_OFF_QUAT:A_OFF_QUAT + 4], **dev).expand_as(lq))
    return gp, gq


def _conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def _ball_art(art: _Art, k, kg, pos, vel, omg):
    """One ball against one articulated geom: swept CCD along the relative
    motion, gated restitution, spin friction, the reaction through the
    factor into the whole generalized velocity -> (pos, vel, omg, P)."""
    rb, inv_mb = k[C_RB], k[C_INV_MB]
    kind, size = int(kg[A_KIND]), kg[A_SIZE:A_SIZE + 3]
    gp, gq = _geom_pose(art, kg)
    gqi = _conj(gq)
    c0 = _qrot(gqi, pos - gp)
    d_now, n_now_l = F._sphere_geom(kind, size, _ch(c0), rb)
    n_now = _qrot(gq, _st(n_now_l))
    cp = pos - n_now * rb
    cols = art.cols(int(kg[A_LINK]), cp)
    v_rel = vel - art.point_vel(cols)
    dv_l = _qrot(gqi, v_rel * k[C_DT_QUARTER])
    dist, n_l = F._sweep(kind, size, rb, _ch(c0), d_now, n_now_l, _ch(dv_l), 4)
    n = _qrot(gq, _st(n_l))
    vn = _dot(v_rel, n)
    active = (dist < 0.0) & (vn < 0.0)
    e_eff = torch.where(torch.abs(vn) > k[C_BOUNCE], kg[A_E], 0.0)
    slip = v_rel - _cross(omg, n) * rb if k[C_KAPPA] > 0 else v_rel
    vt = slip - n * _dot(slip, n)[:, None]
    vt_n = _sqrt_floor(_dot(vt, vt), 1e-18)
    t_hat = vt * (1.0 / vt_n)[:, None]
    yn, yt = art.solve_dirs(cols, n, t_hat)
    w_n = inv_mb + _sum_sq(yn)
    Pn = torch.where(active, -(1.0 + e_eff) * vn / w_n, 0.0)
    w_t = k[C_WT0] + _sum_sq(yt)
    Pt = torch.where(active, torch.minimum(kg[A_MU] * Pn, vt_n / w_t), 0.0)
    P = n * Pn[:, None] - t_hat * Pt[:, None]
    vel = vel + P * inv_mb
    omg = omg + _cross(n, t_hat) * (k[C_KAPPA_INVMB_OVER_RB] * Pt)[:, None]
    art.apply(yn * (-Pn)[:, None] + yt * Pt[:, None])
    pos = pos + n * torch.where(active, torch.clamp(-d_now, min=0.0), 0.0)[:, None]
    return pos, vel, omg, P


def _baumgarte(art: _Art, k, link, point, n, dist, e, mu):
    """A Baumgarte impulse at ``point`` of ``link`` along the normal ``n``
    at penetration ``dist`` with the 2 mm resting band (art-vs-static and
    art-vs-ground) -> the impulse on the geom's body."""
    cols = art.cols(link, point)
    v_point = art.point_vel(cols)
    vn = _dot(v_point, n)
    active = (dist < 0.0) & (vn < 0.1)
    bias = torch.clamp(k[C_BIAS_K] * torch.clamp(-dist - 0.005, min=0.0), max=k[C_MAX_DEPEN])
    e_eff = torch.where(torch.abs(vn) > k[C_BOUNCE], e, 0.0)
    vt = v_point - n * vn[:, None]
    vt_n = _sqrt_floor(_dot(vt, vt), 1e-18)
    t_hat = vt * (1.0 / vt_n)[:, None]
    yn, yt = art.solve_dirs(cols, n, t_hat)
    w_n = _sum_sq(yn)
    Pn = torch.where(active, (-(1.0 + e_eff) * torch.clamp(vn, max=0.0) + bias)
                     / torch.clamp(w_n, min=1e-9), 0.0)
    w_t = _sum_sq(yt)
    Pt = torch.where(active, torch.minimum(mu * Pn, vt_n / torch.clamp(w_t, min=1e-9)), 0.0)
    s_r = torch.where(torch.abs(vn) > k[C_BOUNCE], 1.0,
                      torch.clamp(-dist / RESTING_SMOOTH_BAND, 0.0, 1.0))
    Pn, Pt = Pn * s_r, Pt * s_r
    art.apply(yn * Pn[:, None] - yt * Pt[:, None])
    return n * Pn[:, None] - t_hat * Pt[:, None]


def _art_static(art: _Art, k, kp, kg, ks):
    """One articulated geom against one true static: narrowphase of its
    bounding sphere (exact support of a cylinder or box along the normal
    where the pair says so), then the Baumgarte impulse."""
    link, rbound = int(kg[A_LINK]), kg[A_RBOUND]
    center, gq = _geom_pose(art, kg)
    R = ks[G_ROT:G_ROT + 9]
    c_local = F._mat_t(R, _ch(center - torch.tensor(ks[G_POS:G_POS + 3], dtype=center.dtype,
                                                    device=center.device)))
    dist, n_local = F._sphere_geom(int(ks[G_KIND]), ks[G_SIZE:G_SIZE + 3], c_local, rbound)
    n = _st(F._mat(R, n_local))
    if kp[P_EXACT]:
        n_g = _qrot(_conj(gq), n)
        gs = kg[A_SIZE:A_SIZE + 3]
        if int(kg[A_KIND]) == U.GEOM_CYLINDER:
            na = torch.abs(n_g[:, 2])
            sup = na * gs[1] + _sqrt_floor(1.0 - na * na, 0.0) * gs[0]
        else:
            sup = (torch.abs(n_g[:, 0]) * gs[0] + torch.abs(n_g[:, 1]) * gs[1]
                   + torch.abs(n_g[:, 2]) * gs[2])
        dist = dist + rbound - sup
        point = center - n * sup[:, None]
    else:
        point = center - n * rbound
    return _baumgarte(art, k, link, point, n, dist, kp[P_E], kp[P_MU])


def _art_ground(art: _Art, k, kg):
    """One articulated geom's bounding sphere against the plane z = 0."""
    center, _ = _geom_pose(art, kg)
    rbound = kg[A_RBOUND]
    dist = center[:, 2] - rbound
    point = torch.stack([center[:, 0], center[:, 1], center[:, 2] - rbound], -1)
    n = torch.zeros_like(center)
    n[:, 2] = 1.0
    return _baumgarte(art, k, int(kg[A_LINK]), point, n, dist, k[C_E_GND], k[C_MU_GND])


def floating_substep_plain(consts, q, qd, targets, efforts, base_pos, base_quat,
                           base_linvel, base_angvel, ball_pos, ball_vel,
                           ball_omega) -> FloatingStepOutputs:
    """Plain PyTorch version of K4 over (B, n) inputs of one floating type
    (float32 or float64); ``consts`` is the pack of
    :func:`build_floating_constants` (numpy or a tensor)."""
    s = _Scene(consts, q)
    k = s.k
    tau, q_new, art = _dynamics(s, q, qd, targets, efforts, base_pos, base_quat,
                                base_linvel, base_angvel)

    # ------------------------------- ball ---------------------------------
    g = (k[C_GX], k[C_GY], k[C_GZ])
    pos, vel, omg = F.ball_flight(k, _ch(ball_pos), _ch(ball_vel), _ch(ball_omega), g)
    pos, vel, omg, dv = F.ball_plane(k, pos, vel, omg)
    imp = F._scale(dv, k[C_MB])
    inv_mb = k[C_INV_MB]
    for si in range(int(k[C_NSTATIC])):
        kg = s.entry("static", si, STATIC_STRIDE)
        pos, vel, omg, dv, _ = F.ball_static(k, kg, kg[G_E], kg[G_MU], pos, vel, omg)
        imp = tuple(imp[i] + dv[i] / inv_mb for i in range(3))
    pos, vel, omg, imp = _st(pos), _st(vel), _st(omg), _st(imp)

    n_art = int(k[C_NART])
    geom_imp = [torch.zeros_like(pos) for _ in range(n_art)]
    for gi in range(n_art):
        pos, vel, omg, P = _ball_art(art, k, s.entry("art", gi, ART_STRIDE), pos, vel, omg)
        imp = imp + P
        geom_imp[gi] = -P
    for pi in range(int(k[C_NPAIR])):
        kp = s.entry("pair", pi, PAIR_STRIDE)
        gi = int(kp[P_ART])
        geom_imp[gi] = geom_imp[gi] + _art_static(
            art, k, kp, s.entry("art", gi, ART_STRIDE),
            s.entry("static", int(kp[P_STATIC]), STATIC_STRIDE))
    for gi in range(n_art):
        _art_ground(art, k, s.entry("art", gi, ART_STRIDE))

    pos, vel, omg = F.ball_finish(k, _ch(pos), _ch(vel), _ch(omg))
    u = art.u
    return FloatingStepOutputs(q_new, u[:, 6:], tau, art.bp, art.bq, u[:, 3:6], u[:, 0:3],
                               _st(pos), _st(vel), _st(omg),
                               torch.stack(geom_imp + [imp], 1))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_LAYOUT_KEYS = ("dof", "mask", "base", "static", "art", "pair", "total", "max_static",
                "max_art", "max_pairs", "max_ang_slot", "art_static_slot", "n_in", "n_out1")


def library_layout(nd: int) -> dict:
    """The layout the Python side packs, in the C side's terms."""
    return dict(layout(nd), max_static=MAX_STATIC, max_art=MAX_ART, max_pairs=MAX_PAIRS,
                max_ang_slot=C_BASE_MAX_ANG, art_static_slot=C_ART_STATIC, n_in=n_in(nd),
                n_out1=n_out(nd, 1))


def check_library_layout(lib, nd: int) -> None:
    """Raise unless the C side packs constants as :func:`layout` says."""
    out = (ctypes.c_int * 16)()
    if lib.igt_floating_layout(nd, ctypes.addressof(out), 16) != 0:
        raise RuntimeError(f"floating substep library rejects nd={nd}")
    theirs = dict(zip(_LAYOUT_KEYS, out[:len(_LAYOUT_KEYS)]))
    if theirs != library_layout(nd):
        raise RuntimeError(f"K4 constant-pack layout mismatch: C {theirs} vs Python "
                           f"{library_layout(nd)}")


def input_widths(nd: int):
    """Widths of the eleven inputs, in order."""
    return (nd, nd, nd, nd, 3, 4, 3, 3, 3, 3, 3)


def pack_inputs(*ins):
    """The eleven (B, n) inputs -> one (n_in, B) channel-major buffer."""
    return torch.cat(ins, dim=1).t().contiguous()


def unpack_outputs(y, nd: int) -> FloatingStepOutputs:
    """(n_out, B) channel-major buffer -> (B, n) views."""
    yt = y.t()
    o, parts = 0, []
    for w in (nd, nd, nd, 3, 4, 3, 3, 3, 3, 3):
        parts.append(yt[:, o:o + w])
        o += w
    return FloatingStepOutputs(*parts, yt[:, o:].reshape(yt.shape[0], -1, 3))


class FusedSubstepFloating:
    """K4 for one scene: holds the constant pack and counts kernel launches.

    ``__call__`` takes the Pallas wrapper's eleven (B, n) float32 inputs (q,
    qd, targets, efforts, base pos, quat, linvel, angvel, ball pos, vel,
    omega). On CPU tensors it runs :func:`floating_substep_plain`; on CUDA
    tensors it launches ``csrc/fused_substep_floating.cu`` on the current
    stream (building the library at first use) and adds one to
    ``launches``; anything else raises.
    """

    def __init__(self, consts: np.ndarray):
        self.consts = np.asarray(consts, np.float32)
        self.nd = int(self.consts[C_ND])
        self.ng = int(self.consts[C_NART])
        self.launches = 0
        self._dev_consts = {}
        self._lib = None

    def device_consts(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = torch.as_tensor(self.consts, device=device)
        return self._dev_consts[key]

    def __call__(self, *ins) -> FloatingStepOutputs:
        widths = input_widths(self.nd)
        if len(ins) != len(widths):
            raise ValueError(f"floating substep: expected {len(widths)} inputs, got {len(ins)}")
        B = ins[0].shape[0]
        for t, w in zip(ins, widths):
            if t.dtype != torch.float32 or t.dim() != 2 or tuple(t.shape) != (B, w):
                raise ValueError(f"floating substep: expected float32 ({B}, {w}), got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != ins[0].device:
                raise ValueError("floating substep: inputs on different devices")
        dev = ins[0].device
        if dev.type == "cpu":
            return floating_substep_plain(self.consts, *ins)
        if dev.type != "cuda":
            raise ValueError(f"floating substep: no kernel for device {dev}")
        return self.launch(pack_inputs(*ins))

    def launch(self, x: torch.Tensor) -> FloatingStepOutputs:
        """Launch the kernel on a packed (n_in, B) CUDA buffer."""
        from isaacgym_tpu_torch.ops import _build
        nd, ng = self.nd, self.ng
        if nd != KERNEL_ND:
            raise NotImplementedError(f"floating substep kernel is built for {KERNEL_ND} "
                                      f"DOFs, scene has {nd}")
        rows = n_in(nd)
        if (x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2
                or x.shape[0] != rows or x.shape[1] < 1 or not x.is_contiguous()):
            raise ValueError(f"floating substep: expected a contiguous float32 CUDA "
                             f"({rows}, B) buffer, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if self._lib is None:
            lib = _build.cuda_library("fused_substep_floating")
            check_library_layout(lib, nd)
            self._lib = lib
        B = x.shape[1]
        c = self.device_consts(x.device)
        y = torch.empty((n_out(nd, ng), B), dtype=torch.float32, device=x.device)
        err = self._lib.igt_fused_substep_floating_launch(
            c.data_ptr(), x.data_ptr(), y.data_ptr(), B, nd, ng,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"floating substep launch failed: cudaError {err}")
        self.launches += 1
        return unpack_outputs(y, nd)
