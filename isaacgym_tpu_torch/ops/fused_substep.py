"""K2 and K2-dr, the fused substep of the flagship scene: wrapper, plain
version and the constant pack.

One launch computes the whole substep of a single fixed-base humanoid with
one ball, as ``isaacgym_tpu/ops/pallas_dynamics.py:754``
(``build_fused_substep``, ``with_torque=False``; K2 with ``with_dr=False``,
K2-dr with ``with_dr=True``) does: PD -> FK -> world inertias -> mass matrix -> RNEA bias -> Cholesky ->
semi-implicit Euler with limits -> FK at the new q -> ball gravity and
damping -> plane, static-geom and articulated-geom contacts (swept CCD,
gated restitution, spin friction, joint-space reactions through the factor)
-> art-vs-static narrowphase with exact support and the 2 mm resting band
-> ball integration.

The Pallas kernel folds the scene's numbers in at trace time. Here they are
packed once per simulator into one float32 buffer (``build_constants``);
the CUDA kernel (``csrc/fused_substep.cu``) reads it from device memory, so
one nvcc build serves every scene. The layout below mirrors the ``C_*``,
``D_*``, ``G_*``, ``A_*`` and ``P_*`` slots of ``csrc/fused_substep.cuh``;
the loaded library reports its own layout and the wrapper checks the two.

K2-dr takes one more input, the per-env randomization channel
``dr_chan`` (B, ``n_dr(nd)`` = 4 nd + 6) in the JAX package's order: kp
scale, kd scale, lower shift, upper shift (nd each), mass scale, gravity
offset (3), friction scale, restitution scale. It scales the PD gains, the
link masses (forces, gyroscopic terms and the mass matrix before the
armature), shifts the joint limits, adds the gravity offset to the links and
the ball's free flight, and scales the restitution and friction of the
articulated geoms and the base-welded humanoid geoms (not of the table, the
net or the plane).

``fused_substep_reference`` is the plain PyTorch version, batched over B in
the Pallas kernel's formulation and contact order. ``FusedSubstep`` takes
it only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.ops.dynamics import ArticulationModel

# ---------------------------------------------------------------------------
# constant-pack layout (mirrors csrc/fused_substep.cuh)
# ---------------------------------------------------------------------------

KERNEL_ND = 7            # the one DOF count the kernel is instantiated for
MAX_STATIC = 16
MAX_ART = 8
MAX_PAIRS = 32

(C_ND, C_NSTATIC, C_NART, C_NPAIR, C_DT, C_DT_HALF, C_DT_QUARTER, C_GX, C_GY,
 C_GZ, C_BOUNCE, C_MAX_DEPEN, C_BIAS_K) = range(13)
C_BASE_P = 13
C_BASE_Q = 16
(C_INV_MB, C_MB, C_RB, C_E_BALL, C_MU_BALL, C_PLANE_E, C_PLANE_MU, C_MAX_LIN,
 C_MAX_ANG, C_LIN_DAMP, C_ANG_DAMP, C_KD_AERO, C_KM_AERO, C_KAPPA,
 C_ONE_P_KAPPA, C_KAPPA_OVER_RB, C_WT0, C_KAPPA_INVMB_OVER_RB) = range(20, 38)
C_NTRUE_STATIC = 38
C_DRIVE = 39             # 0: PD position drive, 1: effort drive (K3's arts)
C_TQ_STATIC = 40         # -r / inv_m: a static contact's moment about the ball

DOF_OFF = 48
DOF_STRIDE = 32
D_PARENT, D_REV, D_PRE_POS, D_PRE_QUAT, D_AXIS = 0, 1, 2, 5, 9
D_MASS, D_COM, D_INERTIA, D_ARMATURE = 12, 13, 16, 25
D_LO, D_HI, D_EFFORT, D_MAXVEL, D_KP, D_KD = 26, 27, 28, 29, 30, 31

STATIC_STRIDE = 20
# G_E/G_MU: combined with the ball's material; *_RAW: the geom's own (K2-dr)
G_KIND, G_POS, G_ROT, G_SIZE, G_E, G_MU, G_E_RAW, G_MU_RAW = 0, 1, 4, 13, 16, 17, 18, 19
ART_STRIDE = 20
# A_BODY_OFF: the geom body's frame origin in its link's frame, the point
# the body's contact moments are taken about (K2-tau, K3-tau)
A_KIND, A_LINK, A_OFF_POS, A_OFF_QUAT, A_SIZE, A_E, A_MU, A_RBOUND, A_E_RAW, A_MU_RAW = (
    0, 1, 2, 5, 9, 12, 13, 14, 15, 16)
A_BODY_OFF = 17
PAIR_STRIDE = 8
P_ART, P_STATIC, P_EXACT, P_E, P_MU = 0, 1, 2, 3, 4

RESTING_SMOOTH_BAND = 0.002  # m, the JAX package's resting-contact band


def layout(nd: int) -> dict:
    """Offsets of the pack's blocks for an ``nd``-DOF articulation."""
    mask = DOF_OFF + nd * DOF_STRIDE
    static = mask + nd * nd
    art = static + MAX_STATIC * STATIC_STRIDE
    pair = art + MAX_ART * ART_STRIDE
    return dict(dof=DOF_OFF, mask=mask, static=static, art=art, pair=pair,
                total=pair + MAX_PAIRS * PAIR_STRIDE)


def n_in(nd: int) -> int:
    """Input channels: q, qd, targets, efforts (nd each), ball pos/vel/omega."""
    return 4 * nd + 9


def n_out(nd: int, ng: int, with_torque: bool = False) -> int:
    """Output channels: q, qd, tau, ball pos/vel/omega, impulse rows, and
    with the torque lanes the moment rows."""
    return 3 * nd + 9 + 3 * (ng + 1) * (2 if with_torque else 1)


def n_dr(nd: int) -> int:
    """K2-dr's randomization channel: kp, kd, lower, upper (nd each), mass,
    gravity offset (3), friction, restitution."""
    return 4 * nd + 6


# ---------------------------------------------------------------------------
# constant packing (the trace-time half of pallas_dynamics.py:754-950)
# ---------------------------------------------------------------------------

def _np_qrot(q, v):
    x, y, z, w = [float(c) for c in q]
    u = np.asarray([x, y, z], np.float64)
    v = np.asarray(v, np.float64)
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _point_geom_dist_np(p_world, sg) -> float:
    """Distance from a world point to a static geom's surface (negative
    inside; unknown kinds -> -inf, never pruned)."""
    sgq = np.asarray(sg["quat"], np.float64)
    c = _np_qrot((-sgq[0], -sgq[1], -sgq[2], sgq[3]),
                 np.asarray(p_world, np.float64) - np.asarray(sg["pos"], np.float64))
    kind, size = int(sg["kind"]), np.asarray(sg["size"], np.float64)
    if kind == U.GEOM_SPHERE:
        return float(np.linalg.norm(c) - size[0])
    if kind == U.GEOM_BOX:
        q = np.abs(c) - size
        return float(np.linalg.norm(np.maximum(q, 0.0)) + min(float(np.max(q)), 0.0))
    if kind == U.GEOM_CYLINDER:
        dr = float(np.hypot(c[0], c[1]) - size[0])
        dz = float(abs(c[2]) - size[1])
        if dr <= 0.0 and dz <= 0.0:
            return max(dr, dz)
        return float(np.hypot(max(dr, 0.0), max(dz, 0.0)))
    return -np.inf


def _art_geom_reach_np(model: ArticulationModel, g) -> float:
    """Upper bound on |geom centre - base origin| over all joint values."""
    tree = model.tree
    reach = float(np.linalg.norm(np.asarray(g["off_pos"], np.float64)))
    reach += float(g["radius_bound"])
    d = int(g["link"])
    while d >= 0:
        reach += float(np.linalg.norm(tree.dof_pre_pos[d].astype(np.float64)))
        if int(tree.dof_type[d]) == U.JOINT_PRISMATIC:
            lo, hi = float(tree.lower[d]), float(tree.upper[d])
            if not (np.isfinite(lo) and np.isfinite(hi)):
                return float(np.inf)
            reach += max(abs(lo), abs(hi))
        d = int(tree.dof_parent[d])
    return reach


def static_pair_unreachable(model: ArticulationModel, base_pos, g, sg,
                            margin: float = 0.02) -> bool:
    """Build-time broadphase for a fixed base (``pallas_dynamics.py:329``):
    True when art geom ``g`` can never touch static geom ``sg``."""
    return (_point_geom_dist_np(base_pos, sg)
            > _art_geom_reach_np(model, g) + 0.005 + margin)


def _round_unit(c, tol=1e-7):
    """Snap rotation coefficients to exact 0/±1, as the Pallas kernel's
    constant rotations do."""
    if abs(c) < tol:
        return 0.0
    if abs(c - 1.0) < tol:
        return 1.0
    if abs(c + 1.0) < tol:
        return -1.0
    return c


def _rotmat_np(q):
    x, y, z, w = [float(v) for v in q]
    R = ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
         (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
         (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))
    return [_round_unit(R[i][j]) for i in range(3) for j in range(3)]


def check_supported(model: ArticulationModel) -> None:
    tree = model.tree
    if model.floating or not np.all((tree.dof_type == U.JOINT_REVOLUTE)
                                    | (tree.dof_type == U.JOINT_PRISMATIC)):
        raise NotImplementedError("fused substep: fixed base, revolute/prismatic only")


def static_pairs(model: ArticulationModel, base_pos, art_geoms, true_statics, first=0,
                 art_static: bool = True, reach_prune: bool = True):
    """(art geom index, static index) pairs the build-time broadphase keeps,
    in the kernels' order; art geom indices count from ``first``. None
    without ``art_static``; every pair without ``reach_prune`` (the
    switches ``ISAACGYM_TPU_ART_STATIC=0`` and ``ISAACGYM_TPU_REACH_PRUNE=0``,
    ``pallas_dynamics.py:1296-1303``)."""
    if not art_static:
        return []
    return [(first + gi, si) for gi, g in enumerate(art_geoms)
            for si, sg in enumerate(true_statics)
            if not (reach_prune and static_pair_unreachable(model, base_pos, g, sg))]


def over_maxima(n_static: int, n_art: int, n_pairs: int, maxima=None):
    """Why a pack with these counts of static geoms, articulated geoms and
    art-vs-static pairs exceeds the kernel's maxima (``maxima``: (static,
    art, pairs), K2's by default), or None."""
    m_static, m_art, m_pairs = maxima or (MAX_STATIC, MAX_ART, MAX_PAIRS)
    if n_static > m_static or n_art > m_art or n_pairs > m_pairs:
        return (f"scene exceeds the kernel's maxima: {n_static} static (max {m_static}), "
                f"{n_art} art (max {m_art}), {n_pairs} pairs (max {m_pairs})")
    return None


def pack_header(c, nd, dt_s, gravity, bounce_threshold, max_depenetration,
                n_static, n_art, n_pair, n_true_static) -> None:
    """The scene-wide slots of a header block (``C_*``, ``c`` a view)."""
    c[C_ND], c[C_NSTATIC], c[C_NART], c[C_NPAIR] = nd, n_static, n_art, n_pair
    c[C_DT], c[C_DT_HALF], c[C_DT_QUARTER] = dt_s, dt_s / 2, dt_s / 4
    c[C_GX:C_GZ + 1] = [float(v) for v in gravity]
    c[C_BOUNCE] = bounce_threshold
    c[C_MAX_DEPEN] = max_depenetration
    c[C_BIAS_K] = 0.2 / dt_s
    c[C_NTRUE_STATIC] = n_true_static


def pack_ball(c, ball_cfg: dict, dt_s: float) -> None:
    """One ball's slots of a header block (``ball_cfg`` as ``build_constants``)."""
    mass = float(ball_cfg["mass"])
    inv_mb = 1.0 / mass
    rb = float(ball_cfg["radius"])
    e_ball = float(ball_cfg["restitution"])
    mu_ball = float(ball_cfg["friction"])
    kappa = float(ball_cfg.get("kappa", 0.0))
    c[C_INV_MB], c[C_MB], c[C_RB] = inv_mb, 1.0 / inv_mb, rb
    c[C_E_BALL], c[C_MU_BALL] = e_ball, mu_ball
    c[C_PLANE_E] = 0.5 * (e_ball + float(ball_cfg.get("plane_e", 0.0)))
    c[C_PLANE_MU] = 0.5 * (mu_ball + float(ball_cfg.get("plane_mu", 1.0)))
    c[C_MAX_LIN] = float(ball_cfg.get("max_lin", 1000.0))
    c[C_MAX_ANG] = float(ball_cfg.get("max_ang", 64.0))
    c[C_LIN_DAMP] = max(0.0, 1.0 - float(ball_cfg.get("lin_damp", 0.0)) * dt_s)
    c[C_ANG_DAMP] = max(0.0, 1.0 - float(ball_cfg.get("ang_damp", 0.5)) * dt_s)
    c[C_KD_AERO] = float(ball_cfg.get("drag_k", 0.0))
    c[C_KM_AERO] = float(ball_cfg.get("magnus_k", 0.0))
    c[C_KAPPA], c[C_ONE_P_KAPPA] = kappa, 1.0 + kappa
    c[C_KAPPA_OVER_RB] = kappa / rb
    c[C_WT0] = (1.0 + kappa) * inv_mb
    c[C_KAPPA_INVMB_OVER_RB] = kappa * inv_mb / rb
    c[C_TQ_STATIC] = -rb / inv_mb


def pack_articulation(c, model: ArticulationModel, base_pos, base_quat, kp, kd,
                      drive_mode: int = 0) -> None:
    """An articulation's base pose, drive mode, DOF table and ancestor mask
    into a block laid out as :func:`layout` says (``c`` a view)."""
    tree = model.tree
    nd = tree.n_dof
    c[C_BASE_P:C_BASE_P + 3] = [float(v) for v in base_pos]
    c[C_BASE_Q:C_BASE_Q + 4] = [float(v) for v in base_quat]
    c[C_DRIVE] = drive_mode
    kp = np.asarray(kp, np.float32)
    kd = np.asarray(kd, np.float32)
    for d in range(nd):
        o = DOF_OFF + d * DOF_STRIDE
        c[o + D_PARENT] = int(tree.dof_parent[d])
        c[o + D_REV] = 1.0 if int(tree.dof_type[d]) == U.JOINT_REVOLUTE else 0.0
        c[o + D_PRE_POS:o + D_PRE_POS + 3] = tree.dof_pre_pos[d]
        c[o + D_PRE_QUAT:o + D_PRE_QUAT + 4] = tree.dof_pre_quat[d]
        c[o + D_AXIS:o + D_AXIS + 3] = tree.dof_axis[d]
        c[o + D_MASS] = tree.comp_mass[d]
        c[o + D_COM:o + D_COM + 3] = tree.comp_com[d]
        c[o + D_INERTIA:o + D_INERTIA + 9] = model.link_inertia_com[d].reshape(9)
        c[o + D_ARMATURE] = model.armature[d]
        c[o + D_LO], c[o + D_HI] = tree.lower[d], tree.upper[d]
        c[o + D_EFFORT], c[o + D_MAXVEL] = tree.effort[d], tree.max_velocity[d]
        c[o + D_KP], c[o + D_KD] = kp[d], kd[d]
    mask = layout(nd)["mask"]
    c[mask:mask + nd * nd] = model.ancestor_mask[:nd, :nd].reshape(-1)


def pack_static_geom(c, g: dict) -> None:
    """A static geom's kind, world pose (as a rounded rotation matrix), size
    and own materials into an entry (``G_*``)."""
    c[G_KIND] = int(g["kind"])
    c[G_POS:G_POS + 3] = [float(v) for v in g["pos"]]
    c[G_ROT:G_ROT + 9] = _rotmat_np(g["quat"])
    c[G_SIZE:G_SIZE + 3] = [float(v) for v in g["size"]]
    c[G_E_RAW], c[G_MU_RAW] = float(g["e"]), float(g["mu"])


def pack_art_geom(c, g: dict) -> None:
    """An articulated geom's kind, link, offset, size, bounding radius, own
    materials and body origin (``body_off``, zero when absent) into an
    entry (``A_*``)."""
    c[A_KIND] = int(g["kind"])
    c[A_LINK] = int(g["link"])
    c[A_OFF_POS:A_OFF_POS + 3] = [float(v) for v in g["off_pos"]]
    c[A_OFF_QUAT:A_OFF_QUAT + 4] = [float(v) for v in g["off_quat"]]
    c[A_SIZE:A_SIZE + 3] = [float(v) for v in g["size"]]
    c[A_RBOUND] = float(g["radius_bound"])
    c[A_E_RAW], c[A_MU_RAW] = float(g["e"]), float(g["mu"])
    c[A_BODY_OFF:A_BODY_OFF + 3] = [float(v) for v in g.get("body_off", (0.0, 0.0, 0.0))]


def pack_pair(c, gi: int, si: int, g: dict, sg: dict, exact_support: bool) -> None:
    c[P_ART], c[P_STATIC] = gi, si
    c[P_EXACT] = float(exact_support and int(g["kind"]) in (U.GEOM_CYLINDER, U.GEOM_BOX))
    c[P_E] = 0.5 * (float(g["e"]) + float(sg["e"]))
    c[P_MU] = 0.5 * (float(g["mu"]) + float(sg["mu"]))


def build_constants(model: ArticulationModel, base_pos, base_quat, kp, kd,
                    gravity, dt_s: float, ball_cfg: dict, static_geoms: list,
                    art_geoms: list, *, bounce_threshold: float = 0.2,
                    n_true_static: int = None, max_depenetration: float = 10.0,
                    exact_support: bool = False, art_static: bool = True,
                    reach_prune: bool = True) -> np.ndarray:
    """Pack the scene's constants into one float32 array (integers are
    stored as exact small floats).

    Arguments are those of ``build_fused_substep``: ``ball_cfg`` a dict of
    mass, radius, restitution, friction, plane_e, plane_mu, max_lin, max_ang,
    lin_damp, ang_damp, drag_k, magnus_k, kappa; ``static_geoms`` dicts of
    kind, pos, quat, size, e, mu in the world frame; ``art_geoms`` dicts of
    kind, link, off_pos, off_quat, size, e, mu, radius_bound and, for the
    torque lanes, body_off. ``art_static`` and ``reach_prune`` shape the
    art-vs-static pair list (:func:`static_pairs`).
    """
    check_supported(model)
    nd = model.tree.n_dof
    if n_true_static is None:
        n_true_static = len(static_geoms)
    pairs = static_pairs(model, base_pos, art_geoms, static_geoms[:n_true_static],
                         art_static=art_static, reach_prune=reach_prune)
    why = over_maxima(len(static_geoms), len(art_geoms), len(pairs))
    if why:
        raise ValueError(why)
    lay = layout(nd)
    c = np.zeros(lay["total"], np.float64)
    pack_header(c, nd, dt_s, gravity, bounce_threshold, max_depenetration,
                len(static_geoms), len(art_geoms), len(pairs), n_true_static)
    pack_ball(c, ball_cfg, dt_s)
    pack_articulation(c, model, base_pos, base_quat, kp, kd)
    e_ball, mu_ball = c[C_E_BALL], c[C_MU_BALL]
    for si, g in enumerate(static_geoms):
        o = lay["static"] + si * STATIC_STRIDE
        pack_static_geom(c[o:o + STATIC_STRIDE], g)
        c[o + G_E] = 0.5 * (e_ball + float(g["e"]))
        c[o + G_MU] = 0.5 * (mu_ball + float(g["mu"]))
    f32 = np.float32
    for gi, g in enumerate(art_geoms):
        o = lay["art"] + gi * ART_STRIDE
        pack_art_geom(c[o:o + ART_STRIDE], g)
        # the Pallas kernel forms these in float32 (material x DR scale 1)
        c[o + A_E] = f32(0.5) * (f32(e_ball) + f32(g["e"]))
        c[o + A_MU] = f32(0.5) * (f32(mu_ball) + f32(g["mu"]))
    for pi, (gi, si) in enumerate(pairs):
        o = lay["pair"] + pi * PAIR_STRIDE
        pack_pair(c[o:o + PAIR_STRIDE], gi, si, art_geoms[gi], static_geoms[si],
                  exact_support)
    return c.astype(np.float32)


class FusedStepOutputs(NamedTuple):
    """K2's outputs; K3 returns the same fields with its balls as (B, NB, 3)
    and its impulse rows as ``fused_substep_multi`` says."""
    q_new: torch.Tensor       # (B, nd)
    qd_new: torch.Tensor      # (B, nd) post-contact
    tau: torch.Tensor         # (B, nd)
    ball_pos: torch.Tensor    # (B, 3)
    ball_vel: torch.Tensor    # (B, 3)
    ball_omega: torch.Tensor  # (B, 3)
    impulses: torch.Tensor    # (B, ng+1, 3): per art geom body, then the ball total;
    #                           with the torque lanes (B, 2 ng + 2, 3): then per art
    #                           geom body its contact moment about the body origin,
    #                           and the ball's about its centre


# ---------------------------------------------------------------------------
# plain PyTorch version: tuples of (B,) channels, the kernel's formulation
# ---------------------------------------------------------------------------

def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _qrot(q, v):
    qx, qy, qz, qw = q
    tx = 2.0 * (qy * v[2] - qz * v[1])
    ty = 2.0 * (qz * v[0] - qx * v[2])
    tz = 2.0 * (qx * v[1] - qy * v[0])
    return (v[0] + qw * tx + (qy * tz - qz * ty),
            v[1] + qw * ty + (qz * tx - qx * tz),
            v[2] + qw * tz + (qx * ty - qy * tx))


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return ((aw * bx + ax * bw) + (ay * bz - az * by),
            (aw * by + ay * bw) + (az * bx - ax * bz),
            (aw * bz + az * bw) + (ax * by - ay * bx),
            aw * bw - ((ax * bx + ay * by) + az * bz))


def _conj(q):
    return (-q[0], -q[1], -q[2], q[3])


def _mat(R, v):
    """Constant row-major 3x3 times a vector."""
    return tuple(R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2]
                 for i in range(3))


def _mat_t(R, v):
    return tuple(R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2] for i in range(3))


def _where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _sqrt_floor(x, floor):
    return torch.sqrt(torch.clamp(x, min=floor))


def _sphere_box(c, half, rad):
    """Closest point sphere-vs-box in the box frame -> (dist, n_local)."""
    cl = tuple(torch.clamp(c[i], -half[i], half[i]) for i in range(3))
    d = _sub(c, cl)
    out2 = _dot(d, d)
    out_dist = _sqrt_floor(out2, 1e-18)
    outside = out2 > 1e-12
    gaps = [half[i] - torch.abs(c[i]) for i in range(3)]
    s = [torch.where(c[i] >= 0, 1.0, -1.0) for i in range(3)]
    use_x = (gaps[0] <= gaps[1]) & (gaps[0] <= gaps[2])
    use_y = (~use_x) & (gaps[1] <= gaps[2])
    use_z = (~use_x) & (~use_y)
    n_in = (torch.where(use_x, s[0], 0.0), torch.where(use_y, s[1], 0.0),
            torch.where(use_z, s[2], 0.0))
    d_in = -torch.minimum(gaps[0], torch.minimum(gaps[1], gaps[2]))
    n_out = _scale(d, 1.0 / out_dist)
    return torch.where(outside, out_dist, d_in) - rad, _where(outside, n_out, n_in)


def _sphere_cyl(c, radius, half_len, rad):
    """Closest point sphere-vs-z-cylinder in the cylinder frame."""
    r2 = c[0] * c[0] + c[1] * c[1]
    r_xy = _sqrt_floor(r2, 1e-18)
    sc = torch.clamp(radius / r_xy, max=1.0)
    cl = (c[0] * sc, c[1] * sc, torch.clamp(c[2], -half_len, half_len))
    d = _sub(c, cl)
    out2 = _dot(d, d)
    out_dist = _sqrt_floor(out2, 1e-18)
    outside = out2 > 1e-12
    face_gap = half_len - torch.abs(c[2])
    wall_gap = radius - r_xy
    zsgn = torch.where(c[2] >= 0, 1.0, -1.0)
    use_face = face_gap < wall_gap
    inv_rxy = 1.0 / r_xy
    n_in = (torch.where(use_face, 0.0, c[0] * inv_rxy),
            torch.where(use_face, 0.0, c[1] * inv_rxy),
            torch.where(use_face, zsgn, 0.0))
    d_in = -torch.minimum(face_gap, wall_gap)
    n_out = _scale(d, 1.0 / out_dist)
    return torch.where(outside, out_dist, d_in) - rad, _where(outside, n_out, n_in)


def _sphere_geom(kind, size, c, rad):
    """Sphere of radius ``rad`` at local point ``c`` vs a geom -> (dist, n)."""
    if kind == U.GEOM_SPHERE:
        dn = _sqrt_floor(_dot(c, c), 1e-18)
        return dn - size[0] - rad, _scale(c, 1.0 / dn)
    if kind == U.GEOM_BOX:
        return _sphere_box(c, size, rad)
    return _sphere_cyl(c, size[0], size[1], rad)


def _sweep(kind, size, rad, c0, d0, n0, dv_l, samples):
    """Swept-sample CCD in the geom frame: activation at the first
    penetrating sample (entry-side normal)."""
    best_d, best_n, found = d0, n0, d0 < 0.0
    ck = c0
    for _ in range(samples):
        ck = _add(ck, dv_l)
        dk, nk = _sphere_geom(kind, size, ck, rad)
        take = (~found) & (dk < 0.0)
        best_d = torch.where(take, dk, best_d)
        best_n = _where(take, nk, best_n)
        found = found | (dk < 0.0)
    return best_d, best_n


def _resolve_static(k, vel, omg, dist, n, e, mu, dist_now):
    """Spin-aware impulse against a static surface -> (vel, omg, push, dv)."""
    rb, kappa = k[C_RB], k[C_KAPPA]
    vn = _dot(vel, n)
    active = (dist < 0.0) & (vn < 0.0)
    e_eff = torch.where(torch.abs(vn) > k[C_BOUNCE], e, 0.0)
    jn = torch.where(active, -(1.0 + e_eff) * vn, 0.0)
    slip = _sub(vel, _scale(_cross(omg, n), rb)) if kappa > 0 else vel
    vt = _sub(slip, _scale(n, _dot(slip, n)))
    vt_n = _sqrt_floor(_dot(vt, vt), 1e-18)
    jt = torch.where(active, torch.minimum(mu * jn, vt_n / k[C_ONE_P_KAPPA]), 0.0)
    t_hat = _scale(vt, 1.0 / vt_n)
    dv = _sub(_scale(n, jn), _scale(t_hat, jt))
    omg2 = _add(omg, _scale(_cross(n, t_hat), k[C_KAPPA_OVER_RB] * jt))
    push = _scale(n, torch.where(active, torch.clamp(-dist_now, min=0.0), 0.0))
    return _add(vel, dv), omg2, push, dv


def _chol(M, nd):
    L = [[None] * (i + 1) for i in range(nd)]
    for j in range(nd):
        s = M[j][j]
        for k2 in range(j):
            s = s - L[j][k2] * L[j][k2]
        dia = _sqrt_floor(s, 1e-12)
        L[j][j] = dia
        inv_d = 1.0 / dia
        for i in range(j + 1, nd):
            s = M[i][j]
            for k2 in range(j):
                s = s - L[i][k2] * L[j][k2]
            L[i][j] = s * inv_d
    return L


def _fwd_sub(L, b):
    y = []
    for i in range(len(b)):
        s = b[i]
        for j in range(i):
            s = s - L[i][j] * y[j]
        y.append(s / L[i][i])
    return y


def _back_sub(L, y):
    nd = len(y)
    x = [None] * nd
    for i in reversed(range(nd)):
        s = y[i]
        for j in range(i + 1, nd):
            s = s - L[j][i] * x[j]
        x[i] = s / L[i][i]
    return x


def _fk(k, nd, q, zero):
    """DOF frames and world axes at joint values ``q`` (list of (B,))."""
    bp = tuple(zero + k[C_BASE_P + i] for i in range(3))
    bq = tuple(zero + k[C_BASE_Q + i] for i in range(4))
    fp, fq, axes = [], [], []
    for d in range(nd):
        o = DOF_OFF + d * DOF_STRIDE
        par = int(k[o + D_PARENT])
        pp, pq = (bp, bq) if par < 0 else (fp[par], fq[par])
        jp = _add(pp, _qrot(pq, k[o + D_PRE_POS:o + D_PRE_POS + 3]))
        jq = _qmul(pq, k[o + D_PRE_QUAT:o + D_PRE_QUAT + 4])
        ax = k[o + D_AXIS:o + D_AXIS + 3]
        if k[o + D_REV]:
            half = 0.5 * q[d]
            s, c = torch.sin(half), torch.cos(half)
            fq.append(_qmul(jq, (ax[0] * s, ax[1] * s, ax[2] * s, c)))
            fp.append(jp)
        else:
            fq.append(jq)
            fp.append(_add(jp, _scale(_qrot(jq, ax), q[d])))
        axes.append(_qrot(fq[d], ax))
    return fp, fq, axes


def _rotmat(q):
    x, y, z, w = q
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def _world_inertia(R, I):
    """R I R^T with a constant row-major 3x3 ``I`` -> symmetric nested rows."""
    RI = [[R[i][0] * I[j] + R[i][1] * I[3 + j] + R[i][2] * I[6 + j]
           for j in range(3)] for i in range(3)]
    Iw = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]
            Iw[j][i] = Iw[i][j]
    return Iw


def _sym_mat_vec(Iw, v):
    return tuple(Iw[i][0] * v[0] + Iw[i][1] * v[1] + Iw[i][2] * v[2] for i in range(3))


class ArtState:
    """One articulation after its dynamics: the constant block ``k`` (K2's
    pack, or one articulation block of K3's) with its DOF count and ancestor
    mask, the Cholesky factor ``L``, the post-step frames and the joint
    velocities ``u`` that the contacts then change."""

    def __init__(self, k, nd, mask, L, frames, u):
        self.k, self.nd, self.mask, self.L, self.u = k, nd, mask, L, u
        self.fp, self.fq, self.axes = frames
        self.dofs = [DOF_OFF + d * DOF_STRIDE for d in range(nd)]

    def jac_cols(self, link, point):
        cols = []
        for i in range(self.nd):
            if self.mask[link][i]:
                cols.append(_cross(self.axes[i], _sub(point, self.fp[i]))
                            if self.k[self.dofs[i] + D_REV] else self.axes[i])
            else:
                cols.append(None)
        return cols

    def jt_dot(self, cols, vec):
        zero = torch.zeros_like(self.u[0])
        return [_dot(cc, vec) if cc is not None else zero for cc in cols]

    def point_vel(self, cols):
        zero = torch.zeros_like(self.u[0])
        v = (zero, zero, zero)
        for i, cc in enumerate(cols):
            if cc is not None:
                v = _add(v, _scale(cc, self.u[i]))
        return v

    def link_pose(self, link):
        return self.fp[link], self.fq[link]


def _sum_sq(ys):
    s = 0
    for y_ in ys:
        s = s + y_ * y_
    return s


def art_dynamics(k, nd, q, qd, targets, efforts, dr=None):
    """One articulation's half of the substep, the Pallas kernels' order:
    drive (PD, or the effort input when ``k[C_DRIVE]`` is 1) and effort
    clamp -> FK -> RNEA bias -> mass matrix -> Cholesky -> semi-implicit
    Euler with limits -> FK at the new q.

    ``k`` is the articulation's constant block as a list, ``q`` .. ``efforts``
    lists of (B,) channels; ``dr`` the K2-dr scales (kps, kds, losh, hish,
    ms, g_eff) or None. Returns ``(tau, q_new, ArtState)``."""
    lay = layout(nd)
    mask = [[k[lay["mask"] + l * nd + i] != 0.0 for i in range(nd)] for l in range(nd)]
    dofs = [DOF_OFF + d * DOF_STRIDE for d in range(nd)]
    dt = k[C_DT]
    zero = torch.zeros_like(q[0])
    g_eff = dr["g_eff"] if dr else (k[C_GX], k[C_GY], k[C_GZ])
    effort_drive = k[C_DRIVE] != 0.0

    # drive + effort clamp
    tau = []
    for d, o in enumerate(dofs):
        if effort_drive:
            t = efforts[d]
        else:
            kp, kd = k[o + D_KP], k[o + D_KD]
            if dr:
                kp, kd = kp * dr["kps"][d], kd * dr["kds"][d]
            t = kp * (targets[d] - q[d]) - kd * qd[d] + efforts[d]
        tau.append(torch.clamp(t, -k[o + D_EFFORT], k[o + D_EFFORT]))

    fp, fq, axes = _fk(k, nd, q, zero)
    bp = tuple(zero + k[C_BASE_P + i] for i in range(3))

    # velocity / bias propagation (RNEA with qdd = 0, world frame)
    w_l, wd_l, ao_l = [], [], []
    for d, o in enumerate(dofs):
        par = int(k[o + D_PARENT])
        if par < 0:
            w_p = wd_p = ao_p = (zero, zero, zero)
            o_p = bp
        else:
            w_p, wd_p, ao_p, o_p = w_l[par], wd_l[par], ao_l[par], fp[par]
        r = _sub(fp[d], o_p)
        ao_d = _add(ao_p, _add(_cross(wd_p, r), _cross(w_p, _cross(w_p, r))))
        if k[o + D_REV]:
            w_d = _add(w_p, _scale(axes[d], qd[d]))
            wd_d = _add(wd_p, _scale(_cross(w_p, axes[d]), qd[d]))
        else:
            w_d, wd_d = w_p, wd_p
            ao_d = _add(ao_d, _scale(_cross(w_p, axes[d]), 2.0 * qd[d]))
        w_l.append(w_d)
        wd_l.append(wd_d)
        ao_l.append(ao_d)

    # per link: world COM/inertia, wrench, Jacobian columns; accumulate the
    # bias and the mass matrix link by link (each entry sums over links in
    # ascending order, as the Pallas kernel does)
    ms = dr["ms"] if dr else None
    acc_rhs = [zero] * nd
    M = [[zero] * (i + 1) for i in range(nd)]
    for l, o in enumerate(dofs):
        com = _add(fp[l], _qrot(fq[l], k[o + D_COM:o + D_COM + 3]))
        Iw = _world_inertia(_rotmat(fq[l]), k[o + D_INERTIA:o + D_INERTIA + 9])
        rc = _sub(com, fp[l])
        a_com = _add(ao_l[l], _add(_cross(wd_l[l], rc),
                                   _cross(w_l[l], _cross(w_l[l], rc))))
        m = k[o + D_MASS]
        f = _scale((a_com[0] - g_eff[0], a_com[1] - g_eff[1], a_com[2] - g_eff[2]),
                   m * ms if dr else m)
        n = _add(_sym_mat_vec(Iw, wd_l[l]), _cross(w_l[l], _sym_mat_vec(Iw, w_l[l])))
        if dr:
            n = _scale(n, ms)
        J = [None] * nd
        for i in range(nd):
            if mask[l][i]:
                J[i] = (_cross(axes[i], _sub(com, fp[i]))
                        if k[dofs[i] + D_REV] else axes[i])
        for i in range(nd):
            if not mask[l][i]:
                continue
            rev_i = k[dofs[i] + D_REV]
            if rev_i:
                acc_rhs[i] = acc_rhs[i] + _dot(axes[i], n)
            acc_rhs[i] = acc_rhs[i] + _dot(J[i], f)
            for j in range(i + 1):
                if not mask[l][j]:
                    continue
                if rev_i and k[dofs[j] + D_REV]:
                    M[i][j] = M[i][j] + _dot(axes[i], _sym_mat_vec(Iw, axes[j]))
                M[i][j] = M[i][j] + m * _dot(J[i], J[j])
    rhs = [tau[i] - acc_rhs[i] for i in range(nd)]
    if dr:   # M x ms before the armature
        M = [[M[i][j] * ms for j in range(i + 1)] for i in range(nd)]
    for i, o in enumerate(dofs):
        M[i][i] = M[i][i] + k[o + D_ARMATURE]
    L = _chol(M, nd)
    qdd = _back_sub(L, _fwd_sub(L, rhs))

    # semi-implicit Euler, velocity clamp, joint limits
    q_new, u = [], []
    for d, o in enumerate(dofs):
        v = qd[d] + dt * qdd[d]
        if k[o + D_MAXVEL] > 0.0:
            v = torch.clamp(v, -k[o + D_MAXVEL], k[o + D_MAXVEL])
        p = q[d] + dt * v
        lo, hi = k[o + D_LO], k[o + D_HI]
        if dr:
            lo, hi = lo + dr["losh"][d], hi + dr["hish"][d]
        at_lo, at_hi = p < lo, p > hi
        p = torch.clamp(p, lo, hi)
        v = torch.where(at_lo, torch.clamp(v, min=0.0), v)
        v = torch.where(at_hi, torch.clamp(v, max=0.0), v)
        q_new.append(p)
        u.append(v)
    return tau, q_new, ArtState(k, nd, mask, L, _fk(k, nd, q_new, zero), u)


def ball_flight(kb, pos, vel, omg, g_eff):
    """Gravity, velocity damping and the optional aerodynamics of one ball
    (``kb``: its constant block) over one substep, before its contacts."""
    dt = kb[C_DT]
    vel = tuple(vel[i] + g_eff[i] * dt for i in range(3))
    vel = _scale(vel, kb[C_LIN_DAMP])
    omg = _scale(omg, kb[C_ANG_DAMP])
    if kb[C_KD_AERO] > 0.0:
        vel = _sub(vel, _scale(vel, dt * kb[C_KD_AERO] * _sqrt_floor(_dot(vel, vel), 1e-18)))
    if kb[C_KM_AERO] > 0.0:
        vel = _add(vel, _scale(_cross(omg, vel), dt * kb[C_KM_AERO]))
    return pos, vel, omg


def ball_plane(kb, pos, vel, omg):
    """The ground plane z = 0 (the swept minimum along a plane is monotone)
    -> (pos, vel, omg, dv)."""
    zero = torch.zeros_like(pos[2])
    dist0 = pos[2] - kb[C_RB]
    dist = torch.minimum(dist0, dist0 + vel[2] * kb[C_DT])
    vel, omg, push, dv = _resolve_static(kb, vel, omg, dist, (zero, zero, zero + 1.0),
                                         kb[C_PLANE_E], kb[C_PLANE_MU], dist0)
    return _add(pos, push), vel, omg, dv


def ball_static(kb, kg, e, mu, pos, vel, omg):
    """One ball against one static geom (entry ``kg``: kind, pose, size),
    2 sweep samples, combined materials ``e``, ``mu`` -> (pos, vel, omg, dv,
    n), n the contact normal."""
    kind, R = int(kg[G_KIND]), kg[G_ROT:G_ROT + 9]
    size = kg[G_SIZE:G_SIZE + 3]
    rb = kb[C_RB]
    c0 = _mat_t(R, _sub(pos, kg[G_POS:G_POS + 3]))
    dv_l = _mat_t(R, _scale(vel, kb[C_DT_HALF]))
    d0, n0 = _sphere_geom(kind, size, c0, rb)
    dist, n_l = _sweep(kind, size, rb, c0, d0, n0, dv_l, 2)
    n = _mat(R, n_l)
    vel, omg, push, dv = _resolve_static(kb, vel, omg, dist, n, e, mu, d0)
    return _add(pos, push), vel, omg, dv, n


def static_moment(kb, n, dv):
    """The moment about the ball's centre of a static contact (normal ``n``)
    that changed its velocity by ``dv``: lever -r n, impulse dv / inv_m."""
    return _scale(_cross(n, dv), kb[C_TQ_STATIC])


def ball_art(art: ArtState, kb, kg, e_art, mu_art, pos, vel, omg, torque=False):
    """One ball against one articulated geom (entry ``kg``) of ``art``: swept
    CCD along the relative motion, gated restitution, spin friction, the
    joint-space reaction through the factor (changes ``art.u``) -> (pos, vel,
    omg, P), P the impulse on the ball. With ``torque`` also the contact's
    moments: on the ball about its centre (lever -r n) and on the geom body
    about its frame origin (lever from the body origin to the contact
    point)."""
    rb, inv_mb = kb[C_RB], kb[C_INV_MB]
    kind, link = int(kg[A_KIND]), int(kg[A_LINK])
    size = kg[A_SIZE:A_SIZE + 3]
    lp, lq = art.link_pose(link)
    gp = _add(lp, _qrot(lq, kg[A_OFF_POS:A_OFF_POS + 3]))
    gq = _qmul(lq, kg[A_OFF_QUAT:A_OFF_QUAT + 4])
    gqi = _conj(gq)
    c0 = _qrot(gqi, _sub(pos, gp))
    d_now, n_now_l = _sphere_geom(kind, size, c0, rb)
    n_now = _qrot(gq, n_now_l)
    cp = _sub(pos, _scale(n_now, rb))
    cols = art.jac_cols(link, cp)
    v_rel = _sub(vel, art.point_vel(cols))
    dv_l = _qrot(gqi, _scale(v_rel, kb[C_DT_QUARTER]))
    dist, n_l = _sweep(kind, size, rb, c0, d_now, n_now_l, dv_l, 4)
    n = _qrot(gq, n_l)
    vn = _dot(v_rel, n)
    active = (dist < 0.0) & (vn < 0.0)
    e_eff = torch.where(torch.abs(vn) > kb[C_BOUNCE], e_art, 0.0)
    yn = _fwd_sub(art.L, art.jt_dot(cols, n))
    w_n = inv_mb + _sum_sq(yn)
    Pn = torch.where(active, -(1.0 + e_eff) * vn / w_n, 0.0)
    slip = (_sub(v_rel, _scale(_cross(omg, n), rb)) if kb[C_KAPPA] > 0 else v_rel)
    vt = _sub(slip, _scale(n, _dot(slip, n)))
    vt_n = _sqrt_floor(_dot(vt, vt), 1e-18)
    t_hat = _scale(vt, 1.0 / vt_n)
    yt = _fwd_sub(art.L, art.jt_dot(cols, t_hat))
    w_t = kb[C_WT0] + _sum_sq(yt)
    Pt = torch.where(active, torch.minimum(mu_art * Pn, vt_n / w_t), 0.0)
    P = _sub(_scale(n, Pn), _scale(t_hat, Pt))
    vel = _add(vel, _scale(P, inv_mb))
    omg = _add(omg, _scale(_cross(n, t_hat), kb[C_KAPPA_INVMB_OVER_RB] * Pt))
    du = _back_sub(art.L, [yn[i] * (-Pn) + yt[i] * Pt for i in range(art.nd)])
    art.u = [art.u[i] + du[i] for i in range(art.nd)]
    pos = _add(pos, _scale(n, torch.where(active, torch.clamp(-d_now, min=0.0), 0.0)))
    if not torque:
        return pos, vel, omg, P
    borg = _add(lp, _qrot(lq, kg[A_BODY_OFF:A_BODY_OFF + 3]))
    return (pos, vel, omg, P, _scale(_cross(n_now, P), -rb),
            _cross(_sub(cp, borg), _scale(P, -1.0)))


def art_static(art: ArtState, kp, kg, ks, torque=False):
    """One articulated geom (entry ``kg``) of ``art`` against one true static
    (entry ``ks``), pair entry ``kp``: Baumgarte impulse on the generalized
    velocity with exact support and the 2 mm resting band (changes
    ``art.u``) -> the impulse on the geom body, and with ``torque`` also its
    moment about the body's frame origin."""
    k = art.k
    link, rbound = int(kg[A_LINK]), kg[A_RBOUND]
    lp, lq = art.link_pose(link)
    center = _add(lp, _qrot(lq, kg[A_OFF_POS:A_OFF_POS + 3]))
    R = ks[G_ROT:G_ROT + 9]
    c_local = _mat_t(R, _sub(center, ks[G_POS:G_POS + 3]))
    dist, n_local = _sphere_geom(int(ks[G_KIND]), ks[G_SIZE:G_SIZE + 3], c_local, rbound)
    n = _mat(R, n_local)
    if kp[P_EXACT]:
        gqg = _qmul(lq, kg[A_OFF_QUAT:A_OFF_QUAT + 4])
        n_g = _qrot(_conj(gqg), n)
        gs = kg[A_SIZE:A_SIZE + 3]
        if int(kg[A_KIND]) == U.GEOM_CYLINDER:
            na = torch.abs(n_g[2])
            sup = na * gs[1] + _sqrt_floor(1.0 - na * na, 0.0) * gs[0]
        else:
            sup = (torch.abs(n_g[0]) * gs[0] + torch.abs(n_g[1]) * gs[1]
                   + torch.abs(n_g[2]) * gs[2])
        dist = dist + rbound - sup
        point = _sub(center, _scale(n, sup))
    else:
        point = _sub(center, _scale(n, rbound))
    cols = art.jac_cols(link, point)
    v_point = art.point_vel(cols)
    vn = _dot(v_point, n)
    active = (dist < 0.0) & (vn < 0.1)
    bias = torch.clamp(k[C_BIAS_K] * torch.clamp(-dist - 0.005, min=0.0),
                       max=k[C_MAX_DEPEN])
    e_eff = torch.where(torch.abs(vn) > k[C_BOUNCE], kp[P_E], 0.0)
    yn = _fwd_sub(art.L, art.jt_dot(cols, n))
    w_n = _sum_sq(yn)
    Pn = torch.where(active, (-(1.0 + e_eff) * torch.clamp(vn, max=0.0) + bias)
                     / torch.clamp(w_n, min=1e-9), 0.0)
    vt = _sub(v_point, _scale(n, vn))
    vt_n = _sqrt_floor(_dot(vt, vt), 1e-18)
    t_hat = _scale(vt, 1.0 / vt_n)
    yt = _fwd_sub(art.L, art.jt_dot(cols, t_hat))
    w_t = _sum_sq(yt)
    Pt = torch.where(active, torch.minimum(kp[P_MU] * Pn,
                                           vt_n / torch.clamp(w_t, min=1e-9)), 0.0)
    s_r = torch.where(torch.abs(vn) > k[C_BOUNCE], 1.0,
                      torch.clamp(-dist / RESTING_SMOOTH_BAND, 0.0, 1.0))
    Pn = Pn * s_r
    Pt = Pt * s_r
    du = _back_sub(art.L, [yn[i] * Pn - yt[i] * Pt for i in range(art.nd)])
    art.u = [art.u[i] + du[i] for i in range(art.nd)]
    P = _sub(_scale(n, Pn), _scale(t_hat, Pt))
    if not torque:
        return P
    borg = _add(lp, _qrot(lq, kg[A_BODY_OFF:A_BODY_OFF + 3]))
    return P, _cross(_sub(point, borg), P)


def ball_finish(kb, pos, vel, omg):
    """Velocity caps (PhysX caps the magnitude) and the position update."""
    vel = _scale(vel, torch.clamp(kb[C_MAX_LIN] / _sqrt_floor(_dot(vel, vel), 1e-18), max=1.0))
    omg = _scale(omg, torch.clamp(kb[C_MAX_ANG] / _sqrt_floor(_dot(omg, omg), 1e-18), max=1.0))
    return tuple(pos[i] + vel[i] * kb[C_DT] for i in range(3)), vel, omg


def as_list(consts):
    """A constant pack (numpy or a tensor) as a list of Python floats."""
    return np.asarray(consts.cpu() if torch.is_tensor(consts) else consts,
                      np.float32).tolist()


def stack(xs):
    return torch.stack(list(xs), dim=1)


def fused_substep_reference(consts, q, qd, targets, efforts, ball_pos,
                            ball_vel, ball_omega, dr_chan=None,
                            with_torque=False) -> FusedStepOutputs:
    """Plain PyTorch version of K2 over (B, n) float32 inputs, of K2-dr when
    ``dr_chan`` (B, ``n_dr(nd)``) is given, and with ``with_torque`` of their
    torque-lane builds (K2-tau): the impulses gain each art geom body's
    contact moment and the ball's.

    ``consts`` is the pack of :func:`build_constants` (numpy or a tensor).
    Every per-env value is a (B,) channel; the arithmetic and the order of
    contacts follow the kernel, with ``torch.where`` for its branches.
    """
    k = as_list(consts)
    nd = int(k[C_ND])
    n_static, n_art, n_pair = int(k[C_NSTATIC]), int(k[C_NART]), int(k[C_NPAIR])
    lay = layout(nd)
    g = (k[C_GX], k[C_GY], k[C_GZ])
    dr = None
    if dr_chan is not None:   # the Pallas kernel's kps, kds, losh, hish, ms, g_eff
        dr = dict(kps=[dr_chan[:, d] for d in range(nd)],
                  kds=[dr_chan[:, nd + d] for d in range(nd)],
                  losh=[dr_chan[:, 2 * nd + d] for d in range(nd)],
                  hish=[dr_chan[:, 3 * nd + d] for d in range(nd)],
                  ms=dr_chan[:, 4 * nd],
                  g_eff=tuple(g[i] + dr_chan[:, 4 * nd + 1 + i] for i in range(3)))
        fric_s, rest_s = dr_chan[:, 4 * nd + 4], dr_chan[:, 4 * nd + 5]
    cols = lambda t: [t[:, d] for d in range(t.shape[1])]
    tau, q_new, art = art_dynamics(k, nd, cols(q), cols(qd), cols(targets), cols(efforts), dr)

    # ------------------------------- ball ---------------------------------
    pos, vel, omg = ball_flight(k, cols(ball_pos), cols(ball_vel), cols(ball_omega),
                                dr["g_eff"] if dr else g)
    pos, vel, omg, dv = ball_plane(k, pos, vel, omg)
    imp = _scale(dv, k[C_MB])
    inv_mb = k[C_INV_MB]
    zero = torch.zeros_like(q_new[0])
    if with_torque:
        tqb = static_moment(k, (zero, zero, zero + 1.0), dv)

    # static geoms (table, net, base-welded humanoid geoms)
    for si in range(n_static):
        kg = k[lay["static"] + si * STATIC_STRIDE:lay["static"] + (si + 1) * STATIC_STRIDE]
        e, mu = kg[G_E], kg[G_MU]
        if dr and si >= int(k[C_NTRUE_STATIC]):   # base-welded humanoid geoms
            e = 0.5 * (k[C_E_BALL] + kg[G_E_RAW] * rest_s)
            mu = 0.5 * (k[C_MU_BALL] + kg[G_MU_RAW] * fric_s)
        pos, vel, omg, dv, n = ball_static(k, kg, e, mu, pos, vel, omg)
        imp = tuple(imp[i] + dv[i] / inv_mb for i in range(3))
        if with_torque:
            tqb = _add(tqb, static_moment(k, n, dv))

    # articulated geoms: ball contacts with joint-space reactions
    geom_imp = [(zero, zero, zero)] * n_art
    geom_tq = [(zero, zero, zero)] * n_art
    art_entry = lambda gi: k[lay["art"] + gi * ART_STRIDE:lay["art"] + (gi + 1) * ART_STRIDE]
    for gi in range(n_art):
        kg = art_entry(gi)
        e_art, mu_art = kg[A_E], kg[A_MU]
        if dr:
            e_art = 0.5 * (k[C_E_BALL] + kg[A_E_RAW] * rest_s)
            mu_art = 0.5 * (k[C_MU_BALL] + kg[A_MU_RAW] * fric_s)
        pos, vel, omg, P, *tq = ball_art(art, k, kg, e_art, mu_art, pos, vel, omg,
                                         with_torque)
        imp = _add(imp, P)
        geom_imp[gi] = (-P[0], -P[1], -P[2])
        if with_torque:
            tqb = _add(tqb, tq[0])
            geom_tq[gi] = tq[1]

    # articulation geoms vs the true statics (table slab, net), pairs pruned
    # at build time
    for pi in range(n_pair):
        kp = k[lay["pair"] + pi * PAIR_STRIDE:lay["pair"] + (pi + 1) * PAIR_STRIDE]
        gi, si = int(kp[P_ART]), int(kp[P_STATIC])
        ks = k[lay["static"] + si * STATIC_STRIDE:lay["static"] + (si + 1) * STATIC_STRIDE]
        P = art_static(art, kp, art_entry(gi), ks, with_torque)
        if with_torque:
            P, tq = P
            geom_tq[gi] = _add(geom_tq[gi], tq)
        geom_imp[gi] = _add(geom_imp[gi], P)

    pos, vel, omg = ball_finish(k, pos, vel, omg)
    rows = geom_imp + [imp] + (geom_tq + [tqb] if with_torque else [])
    impulses = torch.stack([stack(r) for r in rows], dim=1)
    return FusedStepOutputs(stack(q_new), stack(art.u), stack(tau), stack(pos),
                            stack(vel), stack(omg), impulses)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_LAYOUT_KEYS = ("dof", "mask", "static", "art", "pair", "total", "max_static", "max_art",
                "max_pairs", "n_dr", "ntrue_static_slot", "static_e_raw", "art_e_raw",
                "art_body_off", "tq_static")


def check_library_layout(lib, nd: int) -> None:
    """Raise unless the C side packs constants as :func:`layout` says."""
    out = (ctypes.c_int * 16)()
    if lib.igt_fused_layout(nd, ctypes.addressof(out), 16) != 0:
        raise RuntimeError(f"fused substep library rejects nd={nd}")
    theirs = dict(zip(_LAYOUT_KEYS, out[:len(_LAYOUT_KEYS)]))
    ours = dict(layout(nd), max_static=MAX_STATIC, max_art=MAX_ART, max_pairs=MAX_PAIRS,
                n_dr=n_dr(nd), ntrue_static_slot=C_NTRUE_STATIC, static_e_raw=G_E_RAW,
                art_e_raw=A_E_RAW, art_body_off=A_BODY_OFF, tq_static=C_TQ_STATIC)
    if theirs != ours:
        raise RuntimeError(f"constant-pack layout mismatch: C {theirs} vs Python {ours}")


def pack_inputs(q, qd, targets, efforts, ball_pos, ball_vel, ball_omega, dr_chan=None):
    """(B, n) inputs -> one (n_in [+ n_dr], B) SoA buffer, channel-major."""
    parts = [q, qd, targets, efforts, ball_pos, ball_vel, ball_omega]
    if dr_chan is not None:
        parts.append(dr_chan)
    return torch.cat(parts, dim=1).t().contiguous()


def unpack_outputs(y, nd: int, ng: int) -> FusedStepOutputs:
    """(n_out, B) SoA buffer -> (B, n) views; the impulse rows, moment rows
    included, are whatever follows the ball state."""
    yt = y.t()
    o = 3 * nd
    return FusedStepOutputs(yt[:, 0:nd], yt[:, nd:2 * nd], yt[:, 2 * nd:o],
                            yt[:, o:o + 3], yt[:, o + 3:o + 6], yt[:, o + 6:o + 9],
                            yt[:, o + 9:].reshape(yt.shape[0], -1, 3))


class FusedSubstep:
    """K2 (or K2-dr, ``with_dr=True``; with ``with_torque=True`` their
    torque-lane builds K2-tau and K2-dr-tau) for one scene: holds the
    constant pack and counts kernel launches.

    ``__call__`` takes the Pallas wrapper's (B, n) float32 inputs, plus the
    (B, ``n_dr``) randomization channel for K2-dr. On CPU tensors it runs
    :func:`fused_substep_reference`; on CUDA tensors it launches
    ``csrc/fused_substep.cu`` on the current stream (building the library at
    first use) and adds one to ``launches``; anything else raises.
    """

    def __init__(self, consts: np.ndarray, with_dr: bool = False, with_torque: bool = False):
        self.consts = np.asarray(consts, np.float32)
        self.nd = int(self.consts[C_ND])
        self.ng = int(self.consts[C_NART])
        self.with_dr = bool(with_dr)
        self.with_torque = bool(with_torque)
        self.launches = 0
        self._dev_consts = {}
        self._lib = None
        self._checked = {}   # id -> the libraries whose layout matched

    def device_consts(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = torch.as_tensor(self.consts, device=device)
        return self._dev_consts[key]

    def n_in(self) -> int:
        """Rows of the packed input the kernel takes."""
        return n_in(self.nd) + (n_dr(self.nd) if self.with_dr else 0)

    def __call__(self, q, qd, targets, efforts, ball_pos, ball_vel,
                 ball_omega, dr_chan=None) -> FusedStepOutputs:
        if (dr_chan is not None) != self.with_dr:
            raise ValueError("fused substep: dr_chan is required by K2-dr and refused by K2")
        ins = (q, qd, targets, efforts, ball_pos, ball_vel, ball_omega)
        B, nd = q.shape[0], self.nd
        widths = (nd, nd, nd, nd, 3, 3, 3)
        if self.with_dr:
            ins, widths = ins + (dr_chan,), widths + (n_dr(nd),)
        for t, w in zip(ins, widths):
            if t.dtype != torch.float32 or t.dim() != 2 or tuple(t.shape) != (B, w):
                raise ValueError(f"fused substep: expected float32 ({B}, {w}), got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != q.device:
                raise ValueError("fused substep: inputs on different devices")
        if q.device.type == "cpu":
            return fused_substep_reference(self.consts, *ins, with_torque=self.with_torque)
        if q.device.type != "cuda":
            raise ValueError(f"fused substep: no kernel for device {q.device}")
        return self.launch(pack_inputs(*ins))

    def launch(self, x: torch.Tensor) -> FusedStepOutputs:
        """Launch the kernel on a packed (n_in [+ n_dr], B) CUDA buffer."""
        y = torch.empty((n_out(self.nd, self.ng, self.with_torque), x.shape[1]),
                        dtype=torch.float32, device=x.device)
        self.launcher(x, y)()
        return unpack_outputs(y, self.nd, self.ng)

    def launcher(self, x: torch.Tensor, y: torch.Tensor, lib=None):
        """The kernel's launch on a packed (n_in [+ n_dr], B) CUDA buffer
        ``x`` into the (n_out, B) CUDA buffer ``y``, both checked here, once:
        each call of the returned function launches on the stream current now
        and adds one to ``launches``. ``lib``: another build of the library
        (a parent tree's, a probe's copy), checked against this pack's layout;
        this package's by default, built at first use."""
        from isaacgym_tpu_torch.ops import _build
        nd, ng = self.nd, self.ng
        if nd != KERNEL_ND:
            raise NotImplementedError(f"fused substep kernel is built for "
                                      f"{KERNEL_ND} DOFs, scene has {nd}")
        for t, rows in ((x, self.n_in()), (y, n_out(nd, ng, self.with_torque))):
            if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
                    or t.shape[0] != rows or t.shape[1] != x.shape[1] or x.shape[1] < 1
                    or not t.is_contiguous()):
                raise ValueError(f"fused substep: expected a contiguous float32 CUDA "
                                 f"({rows}, B) buffer, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        if lib is None:
            if self._lib is None:
                self._lib = _build.cuda_library("fused_substep")
            lib = self._lib
        if id(lib) not in self._checked:
            check_library_layout(lib, nd)
            self._checked[id(lib)] = lib
        args = (self.device_consts(x.device).data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1],
                nd, ng)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if self.with_torque:
            fn, args = lib.igt_fused_substep_tau_launch, args + (int(self.with_dr), stream)
        else:
            fn = lib.igt_fused_substep_dr_launch if self.with_dr else lib.igt_fused_substep_launch
            args = args + (stream,)

        def run():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"fused substep launch failed: cudaError {err}")
            self.launches += 1
        return run
