"""Asset compiler and batched forward kinematics for the port.

``compile_tree`` and its helpers are a numpy copy of
``isaacgym_tpu/models/kinematics.py`` (so the port never imports the JAX
package); ``fk_dof_frames``, ``fk_dof_velocities`` and ``fk_body_states`` are
the same functions written over a leading batch dimension in torch.

Reduced-coordinate convention (matches URDF): the child link frame of joint j
equals the joint frame rotated by the joint's motion, i.e.
``X_child = X_parent · T(xyz, rpy) · R(axis, q)``. Fixed joints are welded
away: each movable DOF carries the composite inertia of its welded subtree,
and every body keeps a fixed offset from its nearest movable ancestor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.utils import rotations as rot


def _quat_from_rpy(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy -> xyzw quaternion (numpy, compile time)."""
    r, p, y = rpy
    cr, sr = np.cos(r * 0.5), np.sin(r * 0.5)
    cp, sp = np.cos(p * 0.5), np.sin(p * 0.5)
    cy, sy = np.cos(y * 0.5), np.sin(y * 0.5)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    u, w = q[:3], q[3]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


@dataclass(frozen=True)
class KinematicTree:
    """Frozen compile-time description of one articulated asset.

    All arrays are numpy (static); nothing here is traced. ``nb`` bodies in
    reference depth-first order, ``nd`` movable DOFs in document order.
    """

    name: str
    body_names: Tuple[str, ...]
    dof_names: Tuple[str, ...]
    floating_base: bool

    # per body (nb)
    parent: np.ndarray            # int, -1 for root
    joint_pos: np.ndarray         # (nb,3) parent->joint translation
    joint_quat: np.ndarray        # (nb,4) parent->joint rotation, xyzw
    joint_type: np.ndarray        # int, urdf.JOINT_*
    joint_axis: np.ndarray        # (nb,3)
    dof_of_body: np.ndarray       # int, dof index if movable joint child else -1
    mass: np.ndarray              # (nb,)
    com: np.ndarray               # (nb,3)
    inertia: np.ndarray           # (nb,3,3) about COM in body frame

    # per dof (nd)
    dof_body: np.ndarray          # body driven by this dof
    dof_parent: np.ndarray        # nearest movable ancestor dof (-1 = base)
    dof_pre_pos: np.ndarray       # (nd,3) parent-dof body frame -> joint frame
    dof_pre_quat: np.ndarray      # (nd,4)
    dof_axis: np.ndarray          # (nd,3) axis in child body frame
    dof_type: np.ndarray          # (nd,) JOINT_REVOLUTE / JOINT_PRISMATIC
    lower: np.ndarray
    upper: np.ndarray
    effort: np.ndarray
    max_velocity: np.ndarray
    damping: np.ndarray
    friction: np.ndarray
    armature: np.ndarray

    # composite (welded) inertia attached to each dof body, in that body frame
    comp_mass: np.ndarray         # (nd,)
    comp_com: np.ndarray          # (nd,3)
    comp_inertia: np.ndarray      # (nd,3,3) about the body-frame origin
    # composite inertia of everything welded directly to the base
    base_comp_mass: float
    base_comp_com: np.ndarray
    base_comp_inertia: np.ndarray

    # body reporting: pose of body b = pose(ref frame) · (ref_pos, ref_quat)
    body_ref_dof: np.ndarray      # (nb,) dof whose child frame b is welded to (-1 = base)
    body_ref_pos: np.ndarray      # (nb,3)
    body_ref_quat: np.ndarray     # (nb,4)

    # collision geoms: (ng) arrays
    geom_body: np.ndarray         # body index
    geom_kind: np.ndarray         # urdf.GEOM_*
    geom_pos: np.ndarray          # (ng,3) offset in body frame
    geom_quat: np.ndarray         # (ng,4)
    geom_size: np.ndarray         # (ng,3)

    @property
    def n_bodies(self) -> int:
        return len(self.body_names)

    @property
    def n_dof(self) -> int:
        return len(self.dof_names)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def dof_index(self, name: str) -> int:
        return self.dof_names.index(name)


def compile_tree(model: U.UrdfModel, floating_base: bool = False) -> KinematicTree:
    """Compile a parsed URDF into a :class:`KinematicTree` (the
    ``load_asset`` equivalent)."""
    body_names = model.link_names
    nb = len(body_names)
    idx = {n: i for i, n in enumerate(body_names)}

    parent = np.full(nb, -1, dtype=np.int64)
    joint_pos = np.zeros((nb, 3))
    joint_quat = np.tile(np.array([0.0, 0, 0, 1.0]), (nb, 1))
    joint_type = np.zeros(nb, dtype=np.int64)
    joint_axis = np.zeros((nb, 3))
    joint_of_body: List[Optional[U.Joint]] = [None] * nb

    for j in model.joints:
        b = idx[j.child]
        parent[b] = idx[j.parent]
        joint_pos[b] = j.xyz
        joint_quat[b] = _quat_from_rpy(j.rpy)
        joint_type[b] = j.kind
        joint_axis[b] = j.axis
        joint_of_body[b] = j

    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for i, name in enumerate(body_names):
        link = model.links[name]
        mass[i] = link.mass
        com[i] = link.com
        inertia[i] = link.inertia

    # DOFs in joint document order
    movable = [j for j in model.joints if j.kind != U.JOINT_FIXED]
    dof_names = tuple(j.name for j in movable)
    nd = len(movable)
    dof_body = np.array([idx[j.child] for j in movable], dtype=np.int64)
    dof_of_body = np.full(nb, -1, dtype=np.int64)
    for d, j in enumerate(movable):
        dof_of_body[idx[j.child]] = d

    # nearest movable ancestor + accumulated fixed pre-transform for each body
    body_ref_dof = np.full(nb, -1, dtype=np.int64)
    body_ref_pos = np.zeros((nb, 3))
    body_ref_quat = np.tile(np.array([0.0, 0, 0, 1.0]), (nb, 1))
    for b in range(nb):
        if dof_of_body[b] >= 0:
            body_ref_dof[b] = dof_of_body[b]
            continue  # identity offset: the dof child frame *is* this body frame
        # walk up through fixed joints, composing transforms
        pos = np.zeros(3)
        quat = np.array([0.0, 0, 0, 1.0])
        a = b
        while a != -1 and dof_of_body[a] < 0 and parent[a] != -1:
            pos = joint_pos[a] + _qrot(joint_quat[a], pos)
            quat = _qmul(joint_quat[a], quat)
            a = parent[a]
        if a == -1 or (parent[a] == -1 and dof_of_body[a] < 0):
            body_ref_dof[b] = -1  # welded to base
        else:
            body_ref_dof[b] = dof_of_body[a]
        body_ref_pos[b] = pos
        body_ref_quat[b] = quat

    # per-dof parent dof + pre-transform (parent dof body frame -> joint frame)
    dof_parent = np.full(nd, -1, dtype=np.int64)
    dof_pre_pos = np.zeros((nd, 3))
    dof_pre_quat = np.tile(np.array([0.0, 0, 0, 1.0]), (nd, 1))
    for d, j in enumerate(movable):
        b = idx[j.child]
        pos = joint_pos[b].copy()
        quat = joint_quat[b].copy()
        a = parent[b]
        while a != -1 and dof_of_body[a] < 0 and parent[a] != -1:
            pos = joint_pos[a] + _qrot(joint_quat[a], pos)
            quat = _qmul(joint_quat[a], quat)
            a = parent[a]
        if a != -1 and dof_of_body[a] >= 0:
            dof_parent[d] = dof_of_body[a]
        dof_pre_pos[d] = pos
        dof_pre_quat[d] = quat
    # sanity: document order must already be topological (URDF guarantees
    # parents precede children in our generated assets; verify anyway)
    for d in range(nd):
        if dof_parent[d] >= d:
            raise ValueError("DOF ordering is not topological; reorder joints")

    dof_axis = np.stack([joint_axis[idx[j.child]] for j in movable]) if nd else np.zeros((0, 3))
    dof_type = np.array([j.kind for j in movable], dtype=np.int64)

    def _arr(attr):
        return np.array([getattr(j, attr) for j in movable])

    # composite inertia per dof: fold every welded descendant body into the
    # frame of its reference dof body (parallel-axis theorem)
    comp_mass = np.zeros(nd)
    comp_com_sum = np.zeros((nd, 3))
    comp_inertia = np.zeros((nd, 3, 3))
    base_mass = 0.0
    base_com_sum = np.zeros(3)
    base_inertia = np.zeros((3, 3))

    def _fold(m, c, I, R, p):
        """Transform (m, com c, inertia-about-com I) by rotation R + offset p;
        return (m, m*com', inertia about target-frame origin)."""
        c_t = R @ c + p
        I_rot = R @ I @ R.T
        d = c_t
        # parallel axis: inertia about target origin
        I_o = I_rot + m * ((d @ d) * np.eye(3) - np.outer(d, d))
        return m, m * c_t, I_o

    def _quat_to_rotmat_np(q):
        x, y, z, w = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    for b in range(nb):
        if mass[b] <= 0.0:
            continue
        d = body_ref_dof[b]
        Rq = _quat_to_rotmat_np(body_ref_quat[b])
        m, mc, I_o = _fold(mass[b], com[b], inertia[b], Rq, body_ref_pos[b])
        if d < 0:
            base_mass += m
            base_com_sum += mc
            base_inertia += I_o
        else:
            comp_mass[d] += m
            comp_com_sum[d] += mc
            comp_inertia[d] += I_o

    comp_com = np.where(comp_mass[:, None] > 0, comp_com_sum / np.maximum(comp_mass[:, None], 1e-12), 0.0)
    base_com = base_com_sum / base_mass if base_mass > 0 else np.zeros(3)

    # collision geoms
    gb, gk, gp, gq, gs = [], [], [], [], []
    for i, name in enumerate(body_names):
        for g in model.links[name].geoms:
            gb.append(i)
            gk.append(g.kind)
            gp.append(g.xyz)
            gq.append(_quat_from_rpy(g.rpy))
            gs.append(g.size)
    ng = len(gb)

    return KinematicTree(
        name=model.name,
        body_names=tuple(body_names),
        dof_names=dof_names,
        floating_base=floating_base,
        parent=parent,
        joint_pos=joint_pos.astype(np.float32),
        joint_quat=joint_quat.astype(np.float32),
        joint_type=joint_type,
        joint_axis=joint_axis.astype(np.float32),
        dof_of_body=dof_of_body,
        mass=mass.astype(np.float32),
        com=com.astype(np.float32),
        inertia=inertia.astype(np.float32),
        dof_body=dof_body,
        dof_parent=dof_parent,
        dof_pre_pos=dof_pre_pos.astype(np.float32),
        dof_pre_quat=dof_pre_quat.astype(np.float32),
        dof_axis=dof_axis.astype(np.float32),
        dof_type=dof_type,
        lower=_arr("lower").astype(np.float32),
        upper=_arr("upper").astype(np.float32),
        effort=_arr("effort").astype(np.float32),
        max_velocity=_arr("velocity").astype(np.float32),
        damping=_arr("damping").astype(np.float32),
        friction=_arr("friction").astype(np.float32),
        armature=_arr("armature").astype(np.float32),
        comp_mass=comp_mass.astype(np.float32),
        comp_com=comp_com.astype(np.float32),
        comp_inertia=comp_inertia.astype(np.float32),
        base_comp_mass=float(base_mass),
        base_comp_com=base_com.astype(np.float32),
        base_comp_inertia=base_inertia.astype(np.float32),
        body_ref_dof=body_ref_dof,
        body_ref_pos=body_ref_pos.astype(np.float32),
        body_ref_quat=body_ref_quat.astype(np.float32),
        geom_body=np.asarray(gb, dtype=np.int64).reshape(ng),
        geom_kind=np.asarray(gk, dtype=np.int64).reshape(ng),
        geom_pos=np.asarray(gp, dtype=np.float64).reshape(ng, 3).astype(np.float32),
        geom_quat=np.asarray(gq, dtype=np.float64).reshape(ng, 4).astype(np.float32),
        geom_size=np.asarray(gs, dtype=np.float64).reshape(ng, 3).astype(np.float32),
    )


def load_asset(path: str, floating_base: bool = False, native: bool = True) -> KinematicTree:
    """Parse + compile a URDF or (``.xml``) MJCF file in one call.

    The native C++ parser (``isaacgym_tpu_torch.native``) reads the file; a
    file it cannot parse goes to the Python parser, which raises its own
    error on a malformed file. A failed build of the native library raises.
    ``native=False`` (the switch ``ISAACGYM_TPU_NATIVE=0``,
    ``sim/switches.py``) reads it with the Python parser alone, as the JAX
    package's ``load_asset`` does under that variable (``:342-356``)."""
    from isaacgym_tpu_torch import native as native_lib
    if path.endswith(".xml"):   # MJCF
        from isaacgym_tpu_torch.models.mjcf import parse_mjcf
        native_parse, python_parse = native_lib.parse_mjcf_native, parse_mjcf
    else:
        native_parse, python_parse = native_lib.parse_urdf_native, U.parse_urdf
    if not native:
        return compile_tree(python_parse(path), floating_base=floating_base)
    try:
        model = native_parse(path)
    except ValueError:
        model = python_parse(path)
    return compile_tree(model, floating_base=floating_base)


# ---------------------------------------------------------------------------
# Batched forward kinematics (torch, leading batch dimension B)
# ---------------------------------------------------------------------------

def _const(x, like):
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def fk_dof_frames(tree: KinematicTree, base_pos, base_quat, q):
    """World pose of every DOF child frame.

    Args: ``base_pos`` (B,3), ``base_quat`` (B,4), ``q`` (B,nd).
    Returns: ``(pos, quat)`` of shapes (B,nd,3) and (B,nd,4).
    """
    poses_p, poses_q = [], []
    for d in range(tree.n_dof):
        pd = int(tree.dof_parent[d])
        pp, pq = (base_pos, base_quat) if pd < 0 else (poses_p[pd], poses_q[pd])
        jp = pp + rot.quat_rotate(pq, _const(tree.dof_pre_pos[d], q).expand_as(pp))
        jq = rot.quat_mul(pq, _const(tree.dof_pre_quat[d], q).expand_as(pq))
        axis = _const(tree.dof_axis[d], q).expand_as(pp)
        if tree.dof_type[d] == U.JOINT_REVOLUTE:
            bq = rot.quat_mul(jq, rot.quat_from_angle_axis(q[:, d], axis))
            bp = jp
        else:
            bp = jp + rot.quat_rotate(jq, axis * q[:, d:d + 1])
            bq = jq
        poses_p.append(bp)
        poses_q.append(bq)
    return torch.stack(poses_p, dim=1), torch.stack(poses_q, dim=1)


def fk_dof_velocities(tree: KinematicTree, dof_pos_w, dof_quat_w, qd,
                      base_pos, base_linvel, base_angvel):
    """Spatial velocity (omega, v_origin) of every DOF frame: (B,nd,3) each."""
    ws, vs = [], []
    for d in range(tree.n_dof):
        pd = int(tree.dof_parent[d])
        w_p, v_p, p_p = ((base_angvel, base_linvel, base_pos) if pd < 0
                         else (ws[pd], vs[pd], dof_pos_w[:, pd]))
        axis_w = rot.quat_rotate(dof_quat_w[:, d],
                                 _const(tree.dof_axis[d], qd).expand_as(w_p))
        v_here = v_p + torch.linalg.cross(w_p, dof_pos_w[:, d] - p_p, dim=-1)
        if tree.dof_type[d] == U.JOINT_REVOLUTE:
            ws.append(w_p + axis_w * qd[:, d:d + 1])
            vs.append(v_here)
        else:
            ws.append(w_p)
            vs.append(v_here + axis_w * qd[:, d:d + 1])
    return torch.stack(ws, dim=1), torch.stack(vs, dim=1)


def fk_body_states(tree: KinematicTree, base_pos, base_quat, q, qd,
                   base_linvel=None, base_angvel=None, body_ids=None):
    """Rigid-body states (B, nb, 13), pos(3)+quat(4,xyzw)+linvel(3)+angvel(3);
    ``base_linvel`` and ``base_angvel`` (B, 3) are a floating base's
    velocity (zero, a fixed base's, when None); ``body_ids`` (numpy)
    restricts the rows."""
    zeros = torch.zeros_like(base_pos)
    base_linvel = zeros if base_linvel is None else base_linvel
    base_angvel = zeros if base_angvel is None else base_angvel
    dof_pos_w, dof_quat_w = fk_dof_frames(tree, base_pos, base_quat, q)
    omega, vel = fk_dof_velocities(tree, dof_pos_w, dof_quat_w, qd,
                                   base_pos, base_linvel, base_angvel)
    nd = tree.n_dof
    pos_ext = torch.cat([dof_pos_w, base_pos[:, None]], dim=1)
    quat_ext = torch.cat([dof_quat_w, base_quat[:, None]], dim=1)
    w_ext = torch.cat([omega, base_angvel[:, None]], dim=1)
    v_ext = torch.cat([vel, base_linvel[:, None]], dim=1)

    body_ref_dof = tree.body_ref_dof
    body_ref_pos = tree.body_ref_pos
    body_ref_quat = tree.body_ref_quat
    if body_ids is not None:
        body_ids = np.asarray(body_ids)
        body_ref_dof = body_ref_dof[body_ids]
        body_ref_pos = body_ref_pos[body_ids]
        body_ref_quat = body_ref_quat[body_ids]
    ref = torch.as_tensor(np.where(body_ref_dof < 0, nd, body_ref_dof),
                          device=q.device)
    rp, rq, rw, rv = pos_ext[:, ref], quat_ext[:, ref], w_ext[:, ref], v_ext[:, ref]
    off_p = _const(body_ref_pos, q).expand_as(rp)
    off_q = _const(body_ref_quat, q).expand_as(rq)
    bp = rp + rot.quat_rotate(rq, off_p)
    bq = rot.quat_mul(rq, off_q)
    bv = rv + torch.linalg.cross(rw, bp - rp, dim=-1)
    return torch.cat([bp, bq, bv, rw], dim=-1)
