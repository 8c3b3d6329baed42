"""Articulated rigid-body dynamics in generalized coordinates, batched in torch.

Counterpart of ``isaacgym_tpu/ops/dynamics.py``: ``build_articulation``
(``:61``, numpy: the ancestor mask, composite link masses, COMs and
inertias about the COM, the armature, which the kernels' constant packs
read) and the non-kernel path's dynamics (``:112-317``): link geometry,
Jacobians at the link COMs, the mass matrix ``J_ang^T I J_ang + m J_lin^T
J_lin`` (with a per-env mass scale), the Coriolis, centrifugal and gravity
bias as one forward-mode derivative (``torch.func.jvp``) of the link
velocities along ``q̇`` with ``u̇ = 0``, the Cholesky solve for ``u̇`` and
the contact-point Jacobians. Fixed and floating bases; the generalized
velocity is ``u = [ω_base (world), v_base (world), q̇]`` when floating, else
``q̇``.

Every function takes a leading env dimension B where the JAX package's
single-env functions are vmapped.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Optional, Tuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import KinematicTree, fk_dof_frames
from isaacgym_tpu_torch.ops.linalg import chol_factor, chol_solve
from isaacgym_tpu_torch.utils import rotations as rot


@dataclass(frozen=True)
class ArticulationModel:
    """Static (compile-time) dynamics view of a KinematicTree."""

    tree: KinematicTree
    floating: bool
    nv: int                          # generalized velocity dimension
    ancestor_mask: np.ndarray        # (nl, nd) link l moved by joint dof d
    link_mass: np.ndarray            # (nl,)
    link_com: np.ndarray             # (nl,3) composite com in link body frame
    link_inertia_com: np.ndarray     # (nl,3,3) composite inertia about com, body frame
    armature: np.ndarray             # (nv,)
    is_revolute: np.ndarray          # (nd,) 1.0 for revolute, 0.0 prismatic

    @property
    def nd(self) -> int:
        return self.tree.n_dof

    @property
    def nl(self) -> int:
        # one articulated link per dof, plus the base composite when floating
        return self.tree.n_dof + (1 if self.floating else 0)


def build_articulation(tree: KinematicTree) -> ArticulationModel:
    nd = tree.n_dof
    # ancestor-or-self mask over the dof tree
    mask = np.zeros((nd, nd), dtype=np.float32)
    for l in range(nd):
        a = l
        while a != -1:
            mask[l, a] = 1.0
            a = int(tree.dof_parent[a])
    # composite inertia about composite com (stored about body origin)
    m = tree.comp_mass
    c = tree.comp_com
    I_com = np.zeros_like(tree.comp_inertia)
    for l in range(nd):
        cc = c[l]
        shift = m[l] * ((cc @ cc) * np.eye(3) - np.outer(cc, cc))
        I_com[l] = tree.comp_inertia[l] - shift
    floating = tree.floating_base
    nv = nd + (6 if floating else 0)
    armature = np.concatenate([np.zeros(6, np.float32), tree.armature]) if floating else tree.armature
    link_mass = m.astype(np.float32)
    link_com = c.astype(np.float32)
    link_inertia = I_com.astype(np.float32)
    if floating:
        # the base's welded composite is a link of its own, moved only by the
        # 6 base columns (zero row in the joint ancestor mask)
        bm = tree.base_comp_mass
        bc = tree.base_comp_com
        shift = bm * ((bc @ bc) * np.eye(3) - np.outer(bc, bc))
        b_inertia = tree.base_comp_inertia - shift
        mask = np.concatenate([mask, np.zeros((1, nd), np.float32)], axis=0)
        link_mass = np.concatenate([link_mass, np.asarray([bm], np.float32)])
        link_com = np.concatenate([link_com, bc[None].astype(np.float32)], axis=0)
        link_inertia = np.concatenate([link_inertia, b_inertia[None].astype(np.float32)], axis=0)
    return ArticulationModel(
        tree=tree,
        floating=floating,
        nv=nv,
        ancestor_mask=mask,
        link_mass=link_mass,
        link_com=link_com,
        link_inertia_com=link_inertia,
        armature=armature.astype(np.float32),
        is_revolute=(tree.dof_type == U.JOINT_REVOLUTE).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Kinematic quantities, batched over B envs
# ---------------------------------------------------------------------------

def _c(x, like):
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def quat_to_rotmat(q):
    """(..., 4) xyzw -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def link_geometry(model: ArticulationModel, base_pos, base_quat, q):
    """(B,3), (B,4), (B,nd) -> frame_pos (B,nd,3), frame_quat (B,nd,4),
    com_w (B,nl,3), axis_w (B,nd,3), I_w (B,nl,3,3)."""
    fp, fq = fk_dof_frames(model.tree, base_pos, base_quat, q)
    axis_w = rot.quat_rotate(fq, _c(model.tree.dof_axis, q).expand_as(fp))
    frames_q = torch.cat([fq, base_quat[:, None]], dim=1) if model.floating else fq
    origins = torch.cat([fp, base_pos[:, None]], dim=1) if model.floating else fp
    com_w = origins + rot.quat_rotate(frames_q, _c(model.link_com, q).expand_as(origins))
    R = quat_to_rotmat(frames_q)                                   # (B,nl,3,3)
    I_w = torch.einsum("zlij,ljk,zlmk->zlim", R, _c(model.link_inertia_com, q), R)
    return fp, fq, com_w, axis_w, I_w


def _skew(v):
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1)], -2)


def jacobians(model: ArticulationModel, frame_pos, axis_w, com_w, base_pos):
    """Geometric Jacobians at each link COM: (J_ang, J_lin), (B, nl, 3, nv)."""
    mask = _c(model.ancestor_mask, frame_pos)                      # (nl, nd)
    rev = _c(model.is_revolute, frame_pos)                         # (nd,)
    r = com_w[:, :, None, :] - frame_pos[:, None, :, :]            # (B,nl,nd,3)
    ax = axis_w[:, None, :, :].expand_as(r)
    ang_cols = ax * (mask * rev)[..., None]
    lin_rev = torch.linalg.cross(ax, r, dim=-1) * (mask * rev)[..., None]
    lin_pris = ax * (mask * (1.0 - rev))[..., None]
    J_ang_j = ang_cols.transpose(2, 3)                             # (B,nl,3,nd)
    J_lin_j = (lin_rev + lin_pris).transpose(2, 3)
    if not model.floating:
        return J_ang_j, J_lin_j
    B, nl = com_w.shape[0], model.nl
    eye = torch.eye(3, dtype=com_w.dtype, device=com_w.device).expand(B, nl, 3, 3)
    rb = com_w - base_pos[:, None]
    J_ang = torch.cat([eye, torch.zeros_like(eye), J_ang_j], dim=-1)
    J_lin = torch.cat([-_skew(rb), eye, J_lin_j], dim=-1)
    return J_ang, J_lin


def mass_matrix(model: ArticulationModel, J_ang, J_lin, I_w, mass_scale=None):
    """(B, nv, nv) joint-space mass matrix; ``mass_scale`` (B,) scales the
    link masses."""
    m = _c(model.link_mass, J_lin).expand(J_lin.shape[0], -1)
    if mass_scale is not None:
        m = m * mass_scale[:, None]
    M = (torch.einsum("zlai,zlab,zlbj->zij", J_ang, I_w, J_ang)
         + torch.einsum("zl,zlai,zlaj->zij", m, J_lin, J_lin))
    return M + torch.diag(_c(model.armature, J_lin))


def _qpos_pack(model, base_pos, base_quat, q):
    if model.floating:
        return torch.cat([base_pos, base_quat, q], dim=-1)
    return q


def _qpos_unpack(model, qpos):
    if model.floating:
        return qpos[:, 0:3], qpos[:, 3:7], qpos[:, 7:]
    zero3 = torch.zeros(qpos.shape[0], 3, dtype=qpos.dtype, device=qpos.device)
    ident = zero3.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(qpos.shape[0], 4)
    return zero3, ident, qpos


def _qpos_dot(model: ArticulationModel, qpos, u):
    """Time derivative of the generalized position under velocity u."""
    if not model.floating:
        return u
    omega = u[:, 0:3]
    vq = torch.cat([omega, torch.zeros_like(omega[:, :1])], dim=-1)
    quat_dot = 0.5 * rot.quat_mul(vq, qpos[:, 3:7])
    return torch.cat([u[:, 3:6], quat_dot, u[:, 6:]], dim=-1)


def link_velocities(model: ArticulationModel, qpos, u, base_pos=None, base_quat=None):
    """(B, nl, 6): each link's [ω; v_com]. A fixed base's pose comes from
    ``base_pos`` and ``base_quat`` (``qpos`` carries only the joints)."""
    bp0, bq0, q = _qpos_unpack(model, qpos)
    if not model.floating:
        if base_pos is not None:
            bp0 = base_pos
        if base_quat is not None:
            bq0 = base_quat
    fp, fq, com_w, axis_w, I_w = link_geometry(model, bp0, bq0, q)
    J_ang, J_lin = jacobians(model, fp, axis_w, com_w, bp0)
    w = torch.einsum("zlav,zv->zla", J_ang, u)
    v = torch.einsum("zlav,zv->zla", J_lin, u)
    return torch.cat([w, v], dim=-1)


def forward_dynamics(model: ArticulationModel, base_pos, base_quat, q, u, tau, gravity,
                     ext_forces: Optional[Tuple] = None, mass_scale=None):
    """Generalized accelerations (B, nv) and the mass matrix's Cholesky
    factor (``ops.linalg``), reused by the contacts. ``gravity`` is (3,) or
    (B, 3); ``mass_scale`` (B,) or None; ``ext_forces`` an optional pair of
    (B, nl, 3) world force at the COM and torque per link."""
    qpos = _qpos_pack(model, base_pos, base_quat, q)
    fp, fq, com_w, axis_w, I_w = link_geometry(model, base_pos, base_quat, q)
    if mass_scale is not None:
        I_w = I_w * mass_scale[:, None, None, None]
    J_ang, J_lin = jacobians(model, fp, axis_w, com_w, base_pos)
    M = mass_matrix(model, J_ang, J_lin, I_w, mass_scale=mass_scale)

    # bias accelerations: d/dt (J(q) u) with u fixed, one forward-mode pass
    wv, wv_dot = torch.func.jvp(
        lambda qp: link_velocities(model, qp, u, base_pos, base_quat),
        (qpos,), (_qpos_dot(model, qpos, u),))
    w, wdot, a_com = wv[..., 0:3], wv_dot[..., 0:3], wv_dot[..., 3:6]

    m = _c(model.link_mass, q).expand(q.shape[0], -1)
    if mass_scale is not None:
        m = m * mass_scale[:, None]
    g = gravity if gravity.dim() == 2 else gravity.expand(q.shape[0], 3)
    f_bias = m[..., None] * (a_com - g[:, None, :])
    n_bias = (torch.einsum("zlab,zlb->zla", I_w, wdot)
              + torch.linalg.cross(w, torch.einsum("zlab,zlb->zla", I_w, w), dim=-1))
    Q_bias = (torch.einsum("zlai,zla->zi", J_ang, n_bias)
              + torch.einsum("zlai,zla->zi", J_lin, f_bias))
    rhs = tau - Q_bias
    if ext_forces is not None:
        f_ext, n_ext = ext_forces
        rhs = (rhs + torch.einsum("zlai,zla->zi", J_lin, f_ext)
               + torch.einsum("zlai,zla->zi", J_ang, n_ext))
    factor = chol_factor(M)
    return chol_solve(factor, rhs), factor


def point_jacobians(model: ArticulationModel, frames, base_pos, links, points_w):
    """Linear-velocity Jacobians (B, K, 3, nv) of K world points (B, K, 3)
    on the links ``links`` (numpy (K,), -1 = welded to the base), from the
    DOF frames ``(fp (B,nd,3), fq (B,nd,4))`` of the substep."""
    fp, fq = frames
    nd = model.tree.n_dof
    axis_w = rot.quat_rotate(fq, _c(model.tree.dof_axis, fp).expand_as(fp))   # (B,nd,3)
    rev = _c(model.is_revolute, fp)
    joint_mask = np.concatenate([model.ancestor_mask[:nd, :nd],
                                 np.zeros((1, nd), np.float32)], axis=0)
    links = np.asarray(links)
    rows = _c(joint_mask[np.where(links < 0, nd, links)], fp)                 # (K,nd)
    r = points_w[:, :, None, :] - fp[:, None, :, :]                           # (B,K,nd,3)
    ax = axis_w[:, None].expand_as(r)
    cols = (torch.linalg.cross(ax, r, dim=-1) * rev[:, None]
            + ax * (1.0 - rev)[:, None]) * rows[..., None]
    J = cols.transpose(2, 3)                                                  # (B,K,3,nd)
    if not model.floating:
        return J
    rb = points_w - base_pos[:, None]
    eye = torch.eye(3, dtype=J.dtype, device=J.device).expand(J.shape[0], J.shape[1], 3, 3)
    return torch.cat([-_skew(rb), eye, J], dim=-1)


def point_jacobian(model: ArticulationModel, base_pos, base_quat, q, link: int, point_w):
    """One point's (B, 3, nv) Jacobian."""
    frames = fk_dof_frames(model.tree, base_pos, base_quat, q)
    return point_jacobians(model, frames, base_pos, np.asarray([link]), point_w[:, None])[:, 0]
