"""K3, the fused substep of K fixed-base articulations and M balls (the
two-humanoid C8 scene): wrapper, plain version and the constant pack.

One launch computes the whole substep of every articulation and every ball
of an env, as ``isaacgym_tpu/ops/pallas_dynamics.py:1477``
(``build_fused_substep_multi``; K3 with ``with_torque=False``, K3-tau with
``with_torque=True``) does, in its order:

  1. per articulation, in list order: PD drive (or the effort input under
     effort drive), FK, mass matrix, RNEA bias, Cholesky, semi-implicit
     Euler with limits, FK at the new q (``:1552-1715``);
  2. per ball: gravity, damping, aerodynamics, the plane, every static geom,
     then every articulated geom of every articulation in list order, each
     reaction going into that articulation's DOF block (``:1717-1967``);
  3. ball-ball pairs (``:1969-2040``);
  4. the balls' velocity caps and integration;
  5. articulated geoms against the true statics, with exact support and the
     2 mm resting band (``:2047-2140``).

Each phase is the K2 helper of ``ops/fused_substep.py`` (``art_dynamics``,
``ball_flight``, ``ball_plane``, ``ball_static``, ``ball_art``,
``art_static``, ``ball_finish``) applied to the articulation's or the ball's
own constant block, so K2 and K3 share their arithmetic, in the plain
version as in CUDA (``csrc/art_warp.cuh``, ``csrc/fused_substep.cuh``).

The constant pack (``build_multi_constants``) is one float32 buffer: a
header of the scene-wide slots, one block per articulation laid out as a
whole K2 pack up to its static list (``fused_substep.layout``: header with
the base pose and drive mode, DOF table, ancestor mask), one K2-style header
block per ball, then the static geoms, the articulated geoms and the
art-vs-static pairs. Static and articulated entries carry the material
combined with each ball; articulated geoms are grouped by articulation and
each articulation block records its geoms' and pairs' ranges. The CUDA
kernel (``csrc/fused_substep_multi.cu``) reports its layout and the wrapper
checks it.

Outputs follow the Pallas wrapper: q, qd, tau (B, sum nd); ball pos, vel,
omega (B, NB, 3); impulses (B, ng + 2 NB, 3) as [one row per articulated
geom body | each ball's plane and static total | each ball's total reaction
from articulated geoms]; K3-tau appends [each articulated geom body's contact
moment about its frame origin | each ball's contact moment about its centre]
-> (B, 2 ng + 3 NB, 3) (``:2144-2171``). The moments of the ball pair are
-r_i (n x P) on each ball, as the JAX package's ball-pair block takes them.
``FusedSubstepMulti`` runs the plain version on CPU tensors and the kernel on
CUDA tensors, counting launches. At <26, 2, 2> (``TREE_CAP``) the kernel
runs each articulation as the subtrees of its base (``tree_blocks``), each
block's mass matrix and factor apart, its tables sized for ``TREE_CAP``
factor entries; a tree that needs more takes the non-kernel step
(``tree_refusal``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.ops.fused_substep import FusedStepOutputs, stack

#: (DOF count per articulation, articulations, balls) the kernel is built for:
#: C8, the two-arm, two-ball check scene, and C11
KERNEL_SHAPES = ((7, 2, 1), (3, 2, 2), (26, 2, 2))
#: the shapes whose kernel runs each articulation's tree as its base subtrees,
#: block by block (``csrc/tree_warp.cuh``), and the factor entries (sum over
#: the blocks of n (n + 1) / 2) its tables hold an articulation: TREE_CAP in
#: ``csrc/fused_substep_multi.cuh``
TREE_CAP = {(26, 2, 2): 128}
MAX_BALLS = 2
MAX_STATIC = 24
MAX_ART = 16
MAX_PAIRS = 32

HEAD = 64
# scene-wide header slots past K2's (C_ND .. C_NTRUE_STATIC are K2's)
H_K, H_NB = 40, 41
# the ball pair's combined restitution and friction, its normal and
# tangential inverse masses, and its four CCD sample times dt kk / 4
H_BB_E, H_BB_MU, H_BB_WN, H_BB_WT, H_BB_T = 42, 43, 44, 45, 46
# articulation block slots past K2's: the ranges of its geoms and pairs
C_GEOM_LO, C_GEOM_HI, C_PAIR_LO, C_PAIR_HI = 40, 41, 42, 43
BALL_STRIDE = 48
STATIC_STRIDE = 24
G_EB, G_MUB = 20, 21           # + 2 bi: combined with ball bi
ART_STRIDE = 28
A_EB, A_MUB = 20, 21           # + 2 bi (K2's entry slots, body origin included, before)
A_ART = 24


def multi_layout(nd: int, K: int) -> dict:
    """Offsets of the K3 pack's blocks for K articulations of ``nd`` DOFs."""
    art_stride = F.layout(nd)["static"]
    ball = HEAD + K * art_stride
    static = ball + MAX_BALLS * BALL_STRIDE
    art = static + MAX_STATIC * STATIC_STRIDE
    pair = art + MAX_ART * ART_STRIDE
    return dict(art0=HEAD, art_stride=art_stride, ball=ball, static=static, art=art,
                pair=pair, total=pair + MAX_PAIRS * F.PAIR_STRIDE)


def n_in(nd_tot: int, nb: int) -> int:
    """Input channels: q, qd, targets, efforts, ball pos/vel/omega."""
    return 4 * nd_tot + 9 * nb


def n_out(nd_tot: int, nb: int, ng: int, with_torque: bool = False) -> int:
    """Output channels: q, qd, tau, ball pos/vel/omega, impulse rows, and
    with the torque lanes the moment rows."""
    return 3 * nd_tot + 9 * nb + 3 * (ng + 2 * nb) + (3 * (ng + nb) if with_torque else 0)


def art_pairs(arts: list, art_geoms: list, true_statics: list, art_static: bool = True,
              reach_prune: bool = True):
    """The art-vs-static pairs the build-time broadphase keeps, articulation
    by articulation (``F.static_pairs``, under the switches ``art_static``
    and ``reach_prune``), and each articulation's ranges of geoms and pairs
    -> ``(pairs, geom_lo, geom_hi, pair_lo, pair_hi)``."""
    arts_of = [int(g["art"]) for g in art_geoms]
    if arts_of != sorted(arts_of):
        raise ValueError("fused multi substep: articulated geoms must be grouped by "
                         "articulation, in order")
    geom_lo = [sum(x < a for x in arts_of) for a in range(len(arts))]
    geom_hi = [sum(x <= a for x in arts_of) for a in range(len(arts))]
    pairs, pair_lo, pair_hi = [], [], []
    for a, spec in enumerate(arts):
        pair_lo.append(len(pairs))
        pairs += F.static_pairs(spec["model"], spec["base_pos"],
                                art_geoms[geom_lo[a]:geom_hi[a]], true_statics, geom_lo[a],
                                art_static=art_static, reach_prune=reach_prune)
        pair_hi.append(len(pairs))
    return pairs, geom_lo, geom_hi, pair_lo, pair_hi


def tree_blocks(mask) -> list:
    """The blocks ``csrc/tree_warp.cuh`` splits a fixed-base tree into, from
    its (nd, nd) ancestor mask (``mask[l, i]`` nonzero where DOF i moves link
    l): each subtree of the base as its DOFs in ascending order, a DOF with no
    other ancestor starting one."""
    mask = np.asarray(mask) != 0
    blocks, of = [], {}
    for d in range(mask.shape[0]):
        anc = np.flatnonzero(mask[d, :d])
        of[d] = of[int(anc[0])] if anc.size else len(blocks)
        if not anc.size:
            blocks.append([])
        blocks[of[d]].append(d)
    return blocks


def tree_refusal(shape, masks):
    """Why the CUDA kernel at ``shape`` (nd, K, NB) cannot hold articulations
    of these ancestor masks, or None: at a tree-blocked shape, a tree whose
    blocks' factors need more than ``TREE_CAP`` entries."""
    cap = TREE_CAP.get(tuple(shape))
    if cap is None:
        return None
    for a, mask in enumerate(masks):
        need = sum(len(b) * (len(b) + 1) // 2 for b in tree_blocks(mask))
        if need > cap:
            return (f"fused multi substep: articulation {a}'s tree blocks need {need} factor "
                    f"entries, the kernel at {tuple(shape)} holds {cap}")
    return None


def pack_masks(consts) -> list:
    """Each articulation's (nd, nd) ancestor mask in a K3 pack."""
    c = np.asarray(consts)
    nd, K = int(c[F.C_ND]), int(c[H_K])
    lay, m = multi_layout(nd, K), F.layout(nd)["mask"]
    return [c[o + m:o + m + nd * nd].reshape(nd, nd)
            for o in (lay["art0"] + a * lay["art_stride"] for a in range(K))]


def pack_refusal(arts: list, n_balls: int, static_geoms: list, art_geoms: list,
                 n_true_static: int = None, art_static: bool = True, reach_prune: bool = True):
    """Why the K3 pack cannot hold the scene (the arguments of
    :func:`build_multi_constants`), or None: articulations of unequal DOF
    counts, a ball count outside 1 .. ``MAX_BALLS``, or more geoms or pairs
    than the maxima. The JAX package's K3 takes the first two; the port steps
    such scenes on the non-kernel path."""
    nds = [a["model"].tree.n_dof for a in arts]
    if len(set(nds)) != 1:
        return f"fused multi substep: articulations of unequal DOF counts {nds}"
    if not 1 <= n_balls <= MAX_BALLS:
        return f"fused multi substep: {n_balls} balls (1 to {MAX_BALLS})"
    if n_true_static is None:
        n_true_static = len(static_geoms)
    pairs = art_pairs(arts, art_geoms, static_geoms[:n_true_static], art_static,
                      reach_prune)[0]
    return F.over_maxima(len(static_geoms), len(art_geoms), len(pairs),
                         (MAX_STATIC, MAX_ART, MAX_PAIRS))


def build_multi_constants(arts: list, balls: list, static_geoms: list, art_geoms: list,
                          gravity, dt_s: float, *, bounce_threshold: float = 0.2,
                          n_true_static: int = None, max_depenetration: float = 10.0,
                          exact_support: bool = False, art_static: bool = True,
                          reach_prune: bool = True) -> np.ndarray:
    """Pack the scene's constants into one float32 array.

    Arguments are those of ``build_fused_substep_multi``: ``arts`` dicts of
    model, base_pos, base_quat, kp, kd, drive_mode (DOF channels concatenated
    in list order); ``balls`` the ball dicts of ``build_constants``;
    ``art_geoms`` entries carry the ``art`` index of their articulation.
    """
    why = pack_refusal(arts, len(balls), static_geoms, art_geoms, n_true_static, art_static,
                       reach_prune)
    if why:
        raise NotImplementedError(why)
    nd, K, NB = arts[0]["model"].tree.n_dof, len(arts), len(balls)
    for a in arts:
        F.check_supported(a["model"])
    if n_true_static is None:
        n_true_static = len(static_geoms)
    pairs, geom_lo, geom_hi, pair_lo, pair_hi = art_pairs(arts, art_geoms,
                                                          static_geoms[:n_true_static],
                                                          art_static, reach_prune)
    lay = multi_layout(nd, K)
    c = np.zeros(lay["total"], np.float64)
    scene = (nd, dt_s, gravity, bounce_threshold, max_depenetration, len(static_geoms),
             len(art_geoms), len(pairs), n_true_static)
    F.pack_header(c, *scene)
    c[H_K], c[H_NB] = K, NB
    for a, spec in enumerate(arts):
        o = lay["art0"] + a * lay["art_stride"]
        blk = c[o:o + lay["art_stride"]]
        F.pack_header(blk, *scene)
        F.pack_articulation(blk, spec["model"], spec["base_pos"], spec["base_quat"],
                            spec["kp"], spec["kd"], int(spec.get("drive_mode", 0)))
        blk[C_GEOM_LO], blk[C_GEOM_HI] = geom_lo[a], geom_hi[a]
        blk[C_PAIR_LO], blk[C_PAIR_HI] = pair_lo[a], pair_hi[a]
    for bi, bc in enumerate(balls):
        o = lay["ball"] + bi * BALL_STRIDE
        F.pack_header(c[o:o + BALL_STRIDE], *scene)
        F.pack_ball(c[o:o + BALL_STRIDE], bc, dt_s)
    if NB == 2:
        A, Bb = balls
        inv = [1.0 / float(b["mass"]) for b in balls]
        kap = [float(b.get("kappa", 0.0)) for b in balls]
        c[H_BB_E] = 0.5 * (float(A["restitution"]) + float(Bb["restitution"]))
        c[H_BB_MU] = 0.5 * (float(A["friction"]) + float(Bb["friction"]))
        c[H_BB_WN] = inv[0] + inv[1]
        c[H_BB_WT] = (1.0 + kap[0]) * inv[0] + (1.0 + kap[1]) * inv[1]
        c[H_BB_T:H_BB_T + 4] = [dt_s * kk / 4 for kk in range(1, 5)]
    for si, g in enumerate(static_geoms):
        o = lay["static"] + si * STATIC_STRIDE
        F.pack_static_geom(c[o:o + STATIC_STRIDE], g)
        for bi, bc in enumerate(balls):
            c[o + G_EB + 2 * bi] = 0.5 * (float(bc["restitution"]) + float(g["e"]))
            c[o + G_MUB + 2 * bi] = 0.5 * (float(bc["friction"]) + float(g["mu"]))
    for gi, g in enumerate(art_geoms):
        o = lay["art"] + gi * ART_STRIDE
        F.pack_art_geom(c[o:o + ART_STRIDE], g)
        c[o + A_ART] = int(g["art"])
        for bi, bc in enumerate(balls):
            c[o + A_EB + 2 * bi] = 0.5 * (float(bc["restitution"]) + float(g["e"]))
            c[o + A_MUB + 2 * bi] = 0.5 * (float(bc["friction"]) + float(g["mu"]))
    for pi, (gi, si) in enumerate(pairs):
        o = lay["pair"] + pi * F.PAIR_STRIDE
        F.pack_pair(c[o:o + F.PAIR_STRIDE], gi, si, art_geoms[gi], static_geoms[si],
                    exact_support)
    return c.astype(np.float32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _ball_pair(k, A, Bb):
    """Two balls (``kb``, pos, vel, omg, s_imp and moment lists, the moment
    None without the torque lanes) against each other: the swept
    sphere-sphere impulse with spin (``:1969-2040``)."""
    kA, kB = A[0], Bb[0]
    d = F._sub(A[1], Bb[1])
    dn = F._sqrt_floor(F._dot(d, d), 1e-18)
    n = F._scale(d, 1.0 / dn)
    v_rel = F._sub(A[2], Bb[2])
    dist = dn
    for kk in range(4):
        dk = F._add(d, F._scale(v_rel, k[H_BB_T + kk]))
        dist = torch.minimum(dist, F._sqrt_floor(F._dot(dk, dk), 1e-18))
    dist_now = dn - kA[F.C_RB] - kB[F.C_RB]
    dist = dist - kA[F.C_RB] - kB[F.C_RB]
    vn = F._dot(v_rel, n)
    active = (dist < 0.0) & (vn < 0.0)
    e_eff = torch.where(torch.abs(vn) > k[F.C_BOUNCE], k[H_BB_E], 0.0)
    Pn = torch.where(active, -(1.0 + e_eff) * vn / k[H_BB_WN], 0.0)
    slip = v_rel
    if kA[F.C_KAPPA] > 0 or kB[F.C_KAPPA] > 0:
        zero = torch.zeros_like(vn)
        spin = lambda kb, omg: (F._scale(F._cross(omg, n), kb[F.C_RB])
                                if kb[F.C_KAPPA] > 0 else (zero, zero, zero))
        slip = F._sub(v_rel, F._add(spin(kA, A[3]), spin(kB, Bb[3])))
    vt = F._sub(slip, F._scale(n, F._dot(slip, n)))
    vt_n = F._sqrt_floor(F._dot(vt, vt), 1e-18)
    t_hat = F._scale(vt, 1.0 / vt_n)
    Pt = torch.where(active, torch.minimum(k[H_BB_MU] * Pn, vt_n / k[H_BB_WT]), 0.0)
    P = F._sub(F._scale(n, Pn), F._scale(t_hat, Pt))
    dwdir = F._cross(n, t_hat)
    A[2] = F._add(A[2], F._scale(P, kA[F.C_INV_MB]))
    Bb[2] = F._sub(Bb[2], F._scale(P, kB[F.C_INV_MB]))
    A[3] = F._add(A[3], F._scale(dwdir, kA[F.C_KAPPA_INVMB_OVER_RB] * Pt))
    Bb[3] = F._add(Bb[3], F._scale(dwdir, kB[F.C_KAPPA_INVMB_OVER_RB] * Pt))
    push = torch.where(active, torch.clamp(-dist_now, min=0.0), 0.0)
    A[1] = F._add(A[1], F._scale(n, 0.5 * push))
    Bb[1] = F._sub(Bb[1], F._scale(n, 0.5 * push))
    A[4] = F._add(A[4], P)
    Bb[4] = F._sub(Bb[4], P)
    if A[5] is not None:
        nxP = F._cross(n, P)
        A[5] = F._sub(A[5], F._scale(nxP, kA[F.C_RB]))
        Bb[5] = F._sub(Bb[5], F._scale(nxP, kB[F.C_RB]))


def fused_substep_multi_reference(consts, q, qd, targets, efforts, ball_pos, ball_vel,
                                  ball_omega, with_torque=False) -> FusedStepOutputs:
    """Plain PyTorch version of K3 (of K3-tau with ``with_torque``): q ..
    efforts (B, sum nd), balls (B, NB, 3).

    ``consts`` is the pack of :func:`build_multi_constants`; every per-env
    value is a (B,) channel and the order of contacts is the kernel's."""
    k = F.as_list(consts)
    nd, K, NB = int(k[F.C_ND]), int(k[H_K]), int(k[H_NB])
    n_static, n_art = int(k[F.C_NSTATIC]), int(k[F.C_NART])
    lay = multi_layout(nd, K)
    block = lambda o, n: k[o:o + n]
    cols = lambda t, a: [t[:, a * nd + d] for d in range(nd)]
    taus, q_news, arts = [], [], []
    for a in range(K):
        ka = block(lay["art0"] + a * lay["art_stride"], lay["art_stride"])
        tau, q_new, art = F.art_dynamics(ka, nd, cols(q, a), cols(qd, a), cols(targets, a),
                                         cols(efforts, a))
        taus += tau
        q_news += q_new
        arts.append(art)
    zero = torch.zeros_like(q_news[0])
    geom_imp = [(zero, zero, zero)] * n_art
    geom_tq = [(zero, zero, zero)] * n_art
    static = lambda si: block(lay["static"] + si * STATIC_STRIDE, STATIC_STRIDE)
    art_entry = lambda gi: block(lay["art"] + gi * ART_STRIDE, ART_STRIDE)

    balls, b_art_rows = [], []
    for bi in range(NB):
        kb = block(lay["ball"] + bi * BALL_STRIDE, BALL_STRIDE)
        ch = lambda t: [t[:, bi, i] for i in range(3)]
        pos, vel, omg = F.ball_flight(kb, ch(ball_pos), ch(ball_vel), ch(ball_omega),
                                      (kb[F.C_GX], kb[F.C_GY], kb[F.C_GZ]))
        pos, vel, omg, dv = F.ball_plane(kb, pos, vel, omg)
        s_imp = F._scale(dv, kb[F.C_MB])
        b_tq = F.static_moment(kb, (zero, zero, zero + 1.0), dv) if with_torque else None
        for si in range(n_static):
            kg = static(si)
            pos, vel, omg, dv, n = F.ball_static(kb, kg, kg[G_EB + 2 * bi],
                                                 kg[G_MUB + 2 * bi], pos, vel, omg)
            s_imp = tuple(s_imp[i] + dv[i] / kb[F.C_INV_MB] for i in range(3))
            if with_torque:
                b_tq = F._add(b_tq, F.static_moment(kb, n, dv))
        b_art = (zero, zero, zero)
        for art in arts:
            for gi in range(int(art.k[C_GEOM_LO]), int(art.k[C_GEOM_HI])):
                kg = art_entry(gi)
                pos, vel, omg, P, *tq = F.ball_art(art, kb, kg, kg[A_EB + 2 * bi],
                                                   kg[A_MUB + 2 * bi], pos, vel, omg,
                                                   with_torque)
                geom_imp[gi] = F._sub(geom_imp[gi], P)
                b_art = F._add(b_art, P)
                if with_torque:
                    b_tq = F._add(b_tq, tq[0])
                    geom_tq[gi] = F._add(geom_tq[gi], tq[1])
        balls.append([kb, pos, vel, omg, s_imp, b_tq])
        b_art_rows.append(b_art)

    for i in range(NB):
        for j in range(i + 1, NB):
            _ball_pair(k, balls[i], balls[j])

    outs = [F.ball_finish(kb, pos, vel, omg) for kb, pos, vel, omg, *_ in balls]

    for art in arts:
        for pi in range(int(art.k[C_PAIR_LO]), int(art.k[C_PAIR_HI])):
            kp = block(lay["pair"] + pi * F.PAIR_STRIDE, F.PAIR_STRIDE)
            gi = int(kp[F.P_ART])
            P = F.art_static(art, kp, art_entry(gi), static(int(kp[F.P_STATIC])), with_torque)
            if with_torque:
                P, tq = P
                geom_tq[gi] = F._add(geom_tq[gi], tq)
            geom_imp[gi] = F._add(geom_imp[gi], P)

    ball_arr = lambda j: torch.stack([stack(o[j]) for o in outs], dim=1)
    rows = geom_imp + [b[4] for b in balls] + b_art_rows
    if with_torque:
        rows += geom_tq + [b[5] for b in balls]
    return FusedStepOutputs(stack(q_news), stack(u for art in arts for u in art.u),
                            stack(taus), ball_arr(0), ball_arr(1), ball_arr(2),
                            torch.stack([stack(r) for r in rows], dim=1))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_LAYOUT_KEYS = ("head", "art_stride", "ball", "ball_stride", "static", "static_stride",
                "art", "art_stride_geom", "pair", "total", "max_balls", "max_static",
                "max_art", "max_pairs", "h_k", "h_bb_t", "c_drive", "c_geom_lo",
                "g_eb", "a_art", "a_eb")


def check_library_layout(lib, nd: int, K: int) -> None:
    """Raise unless the C side packs K3's constants as :func:`multi_layout`
    says."""
    out = (ctypes.c_int * 32)()
    if lib.igt_multi_layout(nd, K, ctypes.addressof(out), 32) != 0:
        raise RuntimeError(f"fused multi substep library rejects nd={nd}, K={K}")
    theirs = dict(zip(_LAYOUT_KEYS, out[:len(_LAYOUT_KEYS)]))
    lay = multi_layout(nd, K)
    ours = dict(head=HEAD, art_stride=lay["art_stride"], ball=lay["ball"],
                ball_stride=BALL_STRIDE, static=lay["static"], static_stride=STATIC_STRIDE,
                art=lay["art"], art_stride_geom=ART_STRIDE, pair=lay["pair"],
                total=lay["total"], max_balls=MAX_BALLS, max_static=MAX_STATIC,
                max_art=MAX_ART, max_pairs=MAX_PAIRS, h_k=H_K, h_bb_t=H_BB_T,
                c_drive=F.C_DRIVE, c_geom_lo=C_GEOM_LO, g_eb=G_EB, a_art=A_ART, a_eb=A_EB)
    if theirs != ours:
        raise RuntimeError(f"multi constant-pack layout mismatch: C {theirs} vs Python {ours}")


def pack_inputs(q, qd, targets, efforts, ball_pos, ball_vel, ball_omega):
    """(B, n) and (B, NB, 3) inputs -> one (n_in, B) buffer, channel-major."""
    B = q.shape[0]
    balls = [t.reshape(B, -1) for t in (ball_pos, ball_vel, ball_omega)]
    return torch.cat([q, qd, targets, efforts] + balls, dim=1).t().contiguous()


def unpack_outputs(y, nd_tot: int, nb: int, ng: int) -> FusedStepOutputs:
    """(n_out, B) buffer -> (B, n) and (B, NB, 3) views."""
    yt = y.t()
    B, o = yt.shape[0], 3 * nd_tot
    ball = lambda j: yt[:, o + 3 * nb * j:o + 3 * nb * (j + 1)].reshape(B, nb, 3)
    return FusedStepOutputs(yt[:, 0:nd_tot], yt[:, nd_tot:2 * nd_tot], yt[:, 2 * nd_tot:o],
                            ball(0), ball(1), ball(2),
                            yt[:, o + 9 * nb:].reshape(B, -1, 3))


class FusedSubstepMulti:
    """K3 (K3-tau with ``with_torque=True``) for one scene: holds the
    constant pack and counts kernel launches.

    ``__call__`` takes the Pallas wrapper's inputs: q, qd, targets, efforts
    (B, sum nd) and ball pos, vel, omega (B, NB, 3), float32. On CPU tensors
    it runs :func:`fused_substep_multi_reference`; on CUDA tensors it
    launches ``csrc/fused_substep_multi.cu`` on the current stream (building
    the library at first use) and adds one to ``launches``; anything else
    raises.
    """

    def __init__(self, consts: np.ndarray, with_torque: bool = False):
        self.consts = np.asarray(consts, np.float32)
        self.with_torque = bool(with_torque)
        self.nd = int(self.consts[F.C_ND])
        self.K = int(self.consts[H_K])
        self.nb = int(self.consts[H_NB])
        self.ng = int(self.consts[F.C_NART])
        self.nd_tot = self.nd * self.K
        self.launches = 0
        self._dev_consts = {}
        self._lib = None
        self._checked = {}   # id -> the libraries whose layout matched

    def device_consts(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = torch.as_tensor(self.consts, device=device)
        return self._dev_consts[key]

    def __call__(self, q, qd, targets, efforts, ball_pos, ball_vel,
                 ball_omega) -> FusedStepOutputs:
        B = q.shape[0]
        for t in (q, qd, targets, efforts):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, self.nd_tot):
                raise ValueError(f"fused multi substep: expected float32 ({B}, "
                                 f"{self.nd_tot}), got {t.dtype} {tuple(t.shape)}")
        for t in (ball_pos, ball_vel, ball_omega):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, self.nb, 3):
                raise ValueError(f"fused multi substep: expected float32 ({B}, {self.nb}, "
                                 f"3), got {t.dtype} {tuple(t.shape)}")
        ins = (q, qd, targets, efforts, ball_pos, ball_vel, ball_omega)
        if any(t.device != q.device for t in ins):
            raise ValueError("fused multi substep: inputs on different devices")
        if q.device.type == "cpu":
            return fused_substep_multi_reference(self.consts, *ins,
                                                 with_torque=self.with_torque)
        if q.device.type != "cuda":
            raise ValueError(f"fused multi substep: no kernel for device {q.device}")
        return self.launch(pack_inputs(*ins))

    def launch(self, x: torch.Tensor) -> FusedStepOutputs:
        """Launch the kernel on a packed (n_in, B) CUDA buffer."""
        y = torch.empty((n_out(self.nd_tot, self.nb, self.ng, self.with_torque), x.shape[1]),
                        dtype=torch.float32, device=x.device)
        self.launcher(x, y)()
        return unpack_outputs(y, self.nd_tot, self.nb, self.ng)

    def launcher(self, x: torch.Tensor, y: torch.Tensor, lib=None):
        """The kernel's launch on a packed (n_in, B) CUDA buffer ``x`` into
        the (n_out, B) CUDA buffer ``y``, both checked here, once: each call
        of the returned function launches on the stream current now and adds
        one to ``launches``. ``lib``: another build of the library (a parent
        tree's, a probe's copy), checked against this pack's layout; this
        package's by default, built at first use."""
        from isaacgym_tpu_torch.ops import _build
        shape = (self.nd, self.K, self.nb)
        if shape not in KERNEL_SHAPES:
            raise NotImplementedError(f"fused multi substep kernel is built for (DOFs per "
                                      f"articulation, articulations, balls) in "
                                      f"{KERNEL_SHAPES}, scene has {shape}")
        why = tree_refusal(shape, pack_masks(self.consts))
        if why:
            raise NotImplementedError(why)
        for t, rows in ((x, n_in(self.nd_tot, self.nb)),
                        (y, n_out(self.nd_tot, self.nb, self.ng, self.with_torque))):
            if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
                    or t.shape[0] != rows or t.shape[1] != x.shape[1] or x.shape[1] < 1
                    or not t.is_contiguous()):
                raise ValueError(f"fused multi substep: expected a contiguous float32 CUDA "
                                 f"({rows}, B) buffer, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        if lib is None:
            if self._lib is None:
                self._lib = _build.cuda_library("fused_substep_multi")
            lib = self._lib
        if id(lib) not in self._checked:
            check_library_layout(lib, self.nd, self.K)
            self._checked[id(lib)] = lib
        fn = (lib.igt_fused_substep_multi_tau_launch if self.with_torque
              else lib.igt_fused_substep_multi_launch)
        args = (self.device_consts(x.device).data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1],
                self.nd, self.K, self.nb, self.ng, torch.cuda.current_stream(x.device).cuda_stream)

        def run():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"fused multi substep launch failed: cudaError {err}")
            self.launches += 1
        return run
