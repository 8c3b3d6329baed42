// The dynamics of K fixed-base articulations side by side in one warp, and
// the pieces of a contact's joint-space reaction, in warp phases (warp.cuh).
// K3 and K3-tau run their two arms with it (fused_substep_multi.cuh); K1
// (arm_step.cuh, four envs to a warp) and K2's builds
// (fused_substep_warp.cuh, two) run several envs to a warp with it, one arm
// each.
//
// Articulation a takes the HW = 32 / K lanes a HW .. a HW + HW - 1 (16 each
// at K = 2). Every articulation runs the same phases on its own constant
// block and its own rows of x and y (the Io policy: ArmRows for K3's arms of
// one env, EnvCols for K1's and K2's envs, each its own column), so one
// __syncwarp serves them all:
//   - drive with the effort clamp (and each revolute DOF's sin and cos of
//     q / 2), Euler with the limits (and the same at the new q): one lane per
//     DOF;
//   - FK and the velocity and bias propagation: one lane per articulation
//     walks its DOFs in index order, a DOF's parent frame and rates in
//     registers when the parent is the DOF just formed. C8's arms and the
//     check scene's are chains: one phase per depth (K4's fk_levels) gives
//     them no parallelism and costs a sync and a reload per depth, and
//     splitting each DOF's terms off onto lanes between serial sums was
//     slower still (PERF.md);
//   - each link's world COM, inertia, force and moment: one lane per link;
//   - every link's active columns (its ancestors) J_li and I_l axw_i: one
//     lane per (link, column) pair, in one phase;
//   - each entry of M sums over its links in ascending l on a lane of its
//     own, a diagonal entry's lane also its DOF's bias over the same links;
//   - the Cholesky factor with its forward and back solve: with
//     SERIAL_FACTOR (K1, K2) one lane per articulation runs it (factor_solve):
//     a 7 x 7 factor is a chain of short serial steps, which phases of a lane
//     per row lengthen with their seven syncs and shared-memory round trips
//     (PERF.md). Without it (K3, whose 64-register cap makes the serial factor
//     slower) the left-looking Cholesky runs one phase per column j, row
//     i > j on its own lane with its serial k-sum, which also subtracts L_ij^2
//     from the row's diagonal and carries the forward solve's column j (its
//     terms in ascending j, as a forward substitution takes them); the owner
//     of row j + 1 then takes that pivot's root and y_(j+1); then the back
//     solve on one lane per articulation;
//   - a contact: its Jacobian columns one per lane, the two directions'
//     forward solves column by column in the same phases, the sums (the
//     point's velocity, |y|^2) and the back solve on one lane.
// K2-dr's randomization (WITH_DR) is read per articulation where the
// one-thread body took it: the kp and kd scales in the drive, the mass scale
// and gravity offset in each link's force and moment and on M before the
// armature, the limit shifts in Euler. Every value is formed by the
// operations of the one-thread-per-env bodies these phases replaced (K1's,
// K2's, K3's) in the same order, so the outputs are the same bits, with one
// saving: those bodies formed I_l axw_j again for every entry of M, these
// phases once per column.
// K3 at <26, 2, 2> runs tree_warp.cuh's blocked form of these phases, on the
// same per-DOF steps (dof_drive, fk_dof, link_terms_fixed, dof_euler).
#pragma once

#include "fused_substep.cuh"
#include "warp.cuh"

namespace igt {

// ------------------------------------------------------------ shared state --
// One articulation's state, through the whole substep: the packed M (then its
// factor), u (qd before the step, then after it and after each contact), q
// and the clamped drive, sin and cos of each revolute DOF's q / 2 (the FK's
// rotation, formed on the DOF's lane before the FK's chain needs it), the
// frames.
template <class T, int ND>
struct ArmState {
  T L[ND * (ND + 1) / 2];
  T u[ND], q[ND], tau[ND], sn[ND], cs[ND];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
};

// Its dynamics' scratch: dead once the post-step frames are formed.
template <class T, int ND>
struct ArmDyn {
  T rhs[ND], y[ND], qdd[ND], dinv[ND];   // tau - bias, then L^-1 of it; qdd; 1 / L_jj
  V3<T> w[ND], wd[ND], ao[ND];     // per DOF frame: angular velocity and the bias rates
  V3<T> com[ND], f[ND], nn[ND];    // per link: world COM, m (a_com - g), I wd + w x I w
  T Iw[ND][6];                     // per link: world inertia (xx xy xz yy yz zz)
  V3<T> J[ND][ND], Ia[ND][ND];     // per link l and active column i: J_li, and I_l axw_i
  unsigned cbits[ND];              // per link: its active columns (its ancestors), a bit each
  unsigned char na[ND], idx[ND][ND];   // and as a list
};

// One contact on the articulation: its point, the normal and tangent, the
// scalars its impulse needs, whether it acts, the point's Jacobian columns
// and each times u_i, J^T n and J^T t and their forward solves with squares,
// the back solve's right-hand side (yn an + yt at, or yn an - yt at with
// ``minus``) and its solution.
template <class T, int ND>
struct ArmContact {
  V3<T> pt, n, t_hat;
  T vn, vt_n, e_eff, bias, an, at;
  int act, minus;
  V3<T> Jc[ND], cu[ND];
  unsigned char on[ND];
  T bn[ND], bt[ND], yn[ND], yt[ND], sqn[ND], sqt[ND], jv[ND], du[ND];
};

// The dynamics' scratch of K articulations.
template <class T, int ND, int K>
struct ArmsDyn {
  ArmDyn<T, ND> arm[K];
};

// A phase over the K articulations side by side: f(a, s) on lane a HW + s.
template <int K, class F>
IGT_HD void each_arm(const Lanes& w, F f) {
  static_assert(K >= 1 && WARP % K == 0, "the articulations split the warp evenly");
  constexpr int HW = WARP / K;
  each(w, [&](int lane) { f(lane / HW, lane % HW); });
}

// ------------------------------------------------------------------ rows --
// Where articulation a's rows lie in the channel-major x and y (``sB`` the
// batch stride): in(blk, a, d) and out(blk, a, d, v) its DOF d's row of
// block blk (q, qd, targets, efforts in; q, qd, tau out), base(a, c, ...)
// its base pose, and (EnvCols, read only by WITH_DR builds) dr(a, k) its
// env's K2-dr channel k.
//
// ArmRows: K3's arms, all of env b: arm a's DOF d is row blk nd_tot + a ND +
// d of column b; the base pose is the arm's block's (C_BASE_P, C_BASE_Q).
template <int ND>
struct ArmRows {
  const float* x;
  float* y;
  int b;
  size_t sB;
  int nd_tot;
  IGT_HD float in(int blk, int a, int d) const {
    return x[(size_t)(blk * nd_tot + a * ND + d) * sB + b];
  }
  template <class T>
  IGT_HD void out(int blk, int a, int d, T v) const {
    y[(size_t)(blk * nd_tot + a * ND + d) * sB + b] = to_f(v);
  }
  template <class T>
  IGT_HD void base(int, const float* c, V3<T>& bp, Q4<T>& bq) const {
    bp = cv3<T>(c + C_BASE_P);
    bq = cq4<T>(c + C_BASE_Q);
  }
};

// EnvCols: K1's and K2's envs, G to a warp: group a is env b0 + a, its DOF d
// row blk ND + d of its own column; its DR channel k (K2-dr) row dr0 + k;
// its base pose the pack's, or with BASE_IN_X (K1) rows 4 ND .. 4 ND + 6 of
// its column. A group past the last env (b0 + a >= B: the last warp of an
// odd B) runs env B - 1 again and writes nothing, so every phase still has
// all 32 lanes.
template <int ND, int G, bool BASE_IN_X = false>
struct EnvCols {
  const float* x;
  float* y;
  int b0, B;
  size_t sB;
  int dr0;
  IGT_HD int col(int a) const { return b0 + a < B ? b0 + a : B - 1; }
  IGT_HD bool owns(int a) const { return b0 + a < B; }
  IGT_HD float get(int ch, int a) const { return x[(size_t)ch * sB + col(a)]; }
  template <class T>
  IGT_HD void put(int ch, int a, T v) const {
    if (owns(a)) y[(size_t)ch * sB + col(a)] = to_f(v);
  }
  IGT_HD float in(int blk, int a, int d) const { return get(blk * ND + d, a); }
  template <class T>
  IGT_HD void out(int blk, int a, int d, T v) const { put(blk * ND + d, a, v); }
  IGT_HD float dr(int a, int k) const { return ldc(x + (size_t)(dr0 + k) * sB + col(a)); }
  template <class T>
  IGT_HD void base(int a, const float* c, V3<T>& bp, Q4<T>& bq) const {
    if constexpr (BASE_IN_X) {
      const int r = 4 * ND;
      bp = v3<T>(T(get(r, a)), T(get(r + 1, a)), T(get(r + 2, a)));
      bq.x = T(get(r + 3, a)); bq.y = T(get(r + 4, a));
      bq.z = T(get(r + 5, a)); bq.w = T(get(r + 6, a));
    } else {
      bp = cv3<T>(c + C_BASE_P);
      bq = cq4<T>(c + C_BASE_Q);
    }
  }
};

// DOF d's parent as the FK takes it: a parent index below d, else
// the base (-1).
IGT_HD int dof_parent(const float* c, int d) {
  const int p = (int)ldc(c + DOF_OFF + d * DOF_STRIDE + D_PARENT);
  return p >= 0 && p < d ? p : -1;
}

IGT_HD bool dof_rev(const float* c, int d) { return ldc(c + DOF_OFF + d * DOF_STRIDE + D_REV) != 0.0f; }

// --------------------------------------------------------------- dynamics --
// sin and cos of revolute DOF d's q / 2, for its FK rotation.
template <class T, int ND, class Ar>
IGT_HD void dof_half_angle(const float* c, Ar& ar, int d) {
  if (!dof_rev(c, d)) return;
  const T half = T(0.5f) * ar.q[d];
  ar.sn[d] = sin_(half);
  ar.cs[d] = cos_(half);
}

// The FK walk's carry: the frame and rates of the DOF just formed.
template <class T>
struct FkCarry {
  V3<T> p, w, wd, ao;
  Q4<T> q;
};

template <class T>
IGT_HD FkCarry<T> fk_start(V3<T> bp, Q4<T> bq) {
  const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  FkCarry<T> k;
  k.p = bp; k.q = bq; k.w = zero3; k.wd = zero3; k.ao = zero3;
  return k;
}

// DOF d's frame and world axis at ar.q from the base pose (bp, bq) (sin and
// cos from dof_half_angle); with ``vel`` also its velocity and bias rates
// (qdd = 0). Its parent's frame and rates come from the carry ``k`` when the
// parent is ``last``, the DOF just formed, else from the block (or the base
// pose, at rest); d's own go into the carry.
template <class T, class Ar, class Dy>
IGT_HD void fk_dof(const float* c, int d, int last, V3<T> bp, Q4<T> bq, Ar& ar, Dy& dy, bool vel,
                   FkCarry<T>& k) {
  const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  const float* dc = c + DOF_OFF + d * DOF_STRIDE;
  const int par = dof_parent(c, d);
  V3<T> pp = bp, w_p = zero3, wd_p = zero3, ao_p = zero3;
  Q4<T> pq = bq;
  if (par >= 0 && par == last) {
    pp = k.p; pq = k.q; w_p = k.w; wd_p = k.wd; ao_p = k.ao;
  } else if (par >= 0) {
    pp = ar.fp[par]; pq = ar.fq[par];
    if (vel) { w_p = dy.w[par]; wd_p = dy.wd[par]; ao_p = dy.ao[par]; }
  }
  const V3<T> jp = add(pp, qrot(pq, cv3<T>(dc + D_PRE_POS)));
  const Q4<T> jq = qmul(pq, cq4<T>(dc + D_PRE_QUAT));
  const V3<T> ax = cv3<T>(dc + D_AXIS);
  Q4<T> fq;
  V3<T> fp;
  const bool rev = ldc(dc + D_REV) != 0.0f;
  if (rev) {
    const T s = ar.sn[d];
    Q4<T> r; r.x = ax.x * s; r.y = ax.y * s; r.z = ax.z * s; r.w = ar.cs[d];
    fq = qmul(jq, r);
    fp = jp;
  } else {
    fq = jq;
    fp = add(jp, scale(qrot(jq, ax), ar.q[d]));
  }
  const V3<T> axw = qrot(fq, ax);
  ar.fq[d] = fq;
  ar.fp[d] = fp;
  ar.axw[d] = axw;
  k.p = fp;
  k.q = fq;
  if (!vel) return;
  const T qd = ar.u[d];
  const V3<T> r = sub(fp, pp);
  V3<T> ao_d = add(ao_p, add(cross(wd_p, r), cross(w_p, cross(w_p, r))));
  if (rev) {
    k.w = add(w_p, scale(axw, qd));
    k.wd = add(wd_p, scale(cross(w_p, axw), qd));
  } else {
    k.w = w_p;
    k.wd = wd_p;
    ao_d = add(ao_d, scale(cross(w_p, axw), T(2.0f) * qd));
  }
  k.ao = ao_d;
  dy.w[d] = k.w;
  dy.wd[d] = k.wd;
  dy.ao[d] = k.ao;
}

// The articulation's DOF frames and world axes (fk_dof), DOF by DOF in index
// order on one lane, a DOF's parent frame and rates in registers when the
// parent is the DOF just formed (every DOF of a chain). C8's arms, the
// flagship's and the check scene's are chains, where one phase per depth of
// the tree (K4's fk_levels) has no parallelism to offer and costs a sync and
// a reload per depth. (C11's 26-DOF trees walk a lane per base subtree,
// tree_warp.cuh.)
template <class T, int ND, class Ar, class Dy>
IGT_HD void fk_walk(const float* c, V3<T> bp, Q4<T> bq, Ar& ar, Dy& dy, bool vel) {
  FkCarry<T> k = fk_start(bp, bq);
  for (int d = 0; d < ND; ++d) fk_dof<T>(c, d, d - 1, bp, bq, ar, dy, vel, k);
}

// Link l's world COM, inertia, force and moment; with WITH_DR the force
// (a_com - g - g_offset) m ms and the moment times ms, articulation a's mass
// scale ms and gravity offset from io.
template <class T, int ND, bool WITH_DR, class Io, class Ar, class Dy>
IGT_HD void link_terms_fixed(const float* c, const Ar& ar, Dy& dy, int l, const Io& io, int a) {
  const float* lc = c + DOF_OFF + l * DOF_STRIDE;
  const Q4<T> qq = ar.fq[l];
  const V3<T> com = add(ar.fp[l], qrot(qq, cv3<T>(lc + D_COM)));
  T R[3][3];
  R[0][0] = T(1.0f) - T(2.0f) * (qq.y * qq.y + qq.z * qq.z);
  R[0][1] = T(2.0f) * (qq.x * qq.y - qq.w * qq.z);
  R[0][2] = T(2.0f) * (qq.x * qq.z + qq.w * qq.y);
  R[1][0] = T(2.0f) * (qq.x * qq.y + qq.w * qq.z);
  R[1][1] = T(1.0f) - T(2.0f) * (qq.x * qq.x + qq.z * qq.z);
  R[1][2] = T(2.0f) * (qq.y * qq.z - qq.w * qq.x);
  R[2][0] = T(2.0f) * (qq.x * qq.z - qq.w * qq.y);
  R[2][1] = T(2.0f) * (qq.y * qq.z + qq.w * qq.x);
  R[2][2] = T(1.0f) - T(2.0f) * (qq.x * qq.x + qq.y * qq.y);
  const float* I = lc + D_INERTIA;
  T RI[3][3], Iw[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      RI[i][j] = R[i][0] * T(ldc(I + j)) + R[i][1] * T(ldc(I + 3 + j)) + R[i][2] * T(ldc(I + 6 + j));
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
      Iw[j][i] = Iw[i][j];
    }
  const V3<T> wl = dy.w[l], wdl = dy.wd[l];
  const V3<T> rc = sub(com, ar.fp[l]);
  const V3<T> a_com = add(dy.ao[l], add(cross(wdl, rc), cross(wl, cross(wl, rc))));
  const T m = T(ldc(lc + D_MASS));
  const V3<T> Iwd = v3<T>(Iw[0][0] * wdl.x + Iw[0][1] * wdl.y + Iw[0][2] * wdl.z,
                          Iw[1][0] * wdl.x + Iw[1][1] * wdl.y + Iw[1][2] * wdl.z,
                          Iw[2][0] * wdl.x + Iw[2][1] * wdl.y + Iw[2][2] * wdl.z);
  const V3<T> Iww = v3<T>(Iw[0][0] * wl.x + Iw[0][1] * wl.y + Iw[0][2] * wl.z,
                          Iw[1][0] * wl.x + Iw[1][1] * wl.y + Iw[1][2] * wl.z,
                          Iw[2][0] * wl.x + Iw[2][1] * wl.y + Iw[2][2] * wl.z);
  dy.com[l] = com;
  if constexpr (WITH_DR) {
    const T ms = T(io.dr(a, 4 * ND));
    dy.f[l] = scale(v3<T>(a_com.x - (T(ldc(c + C_GX)) + T(io.dr(a, 4 * ND + 1))),
                          a_com.y - (T(ldc(c + C_GY)) + T(io.dr(a, 4 * ND + 2))),
                          a_com.z - (T(ldc(c + C_GZ)) + T(io.dr(a, 4 * ND + 3)))),
                    m * ms);
    dy.nn[l] = scale(add(Iwd, cross(wl, Iww)), ms);   // gyroscopic term x ms
  } else {
    dy.f[l] = scale(v3<T>(a_com.x - T(ldc(c + C_GX)), a_com.y - T(ldc(c + C_GY)),
                          a_com.z - T(ldc(c + C_GZ))), m);
    dy.nn[l] = add(Iwd, cross(wl, Iww));
  }
  T* iw = dy.Iw[l];
  iw[0] = Iw[0][0]; iw[1] = Iw[0][1]; iw[2] = Iw[0][2];
  iw[3] = Iw[1][1]; iw[4] = Iw[1][2]; iw[5] = Iw[2][2];
}

// DOF d's drive (PD, or with ``effort_drive``, the block's C_DRIVE, the
// effort input) with the effort clamp, its q and u before the step and its
// half angle; with WITH_DR the kp and kd scales of articulation a's env (io).
template <class T, int ND, bool WITH_DR, class Io, class Ar>
IGT_HD void dof_drive(const float* c, const Io& io, int a, Ar& ar, int d, bool effort_drive) {
  const float* dc = c + DOF_OFF + d * DOF_STRIDE;
  const T q = T(io.in(0, a, d)), qd = T(io.in(1, a, d));
  T t;
  if (effort_drive) {
    t = T(io.in(3, a, d));
  } else {
    T kp = T(ldc(dc + D_KP)), kd = T(ldc(dc + D_KD));
    if constexpr (WITH_DR) {   // DR rows d and ND + d: the kp and kd scales
      kp = kp * T(io.dr(a, d));
      kd = kd * T(io.dr(a, ND + d));
    }
    t = kp * (T(io.in(2, a, d)) - q) - kd * qd + T(io.in(3, a, d));
  }
  const T eff = T(ldc(dc + D_EFFORT));
  ar.tau[d] = clip_(t, -eff, eff);
  ar.q[d] = q;
  ar.u[d] = qd;
  dof_half_angle<T, ND>(c, ar, d);
}

// DOF d's semi-implicit Euler step of dt from qdd, with the velocity clamp
// and the joint limits (WITH_DR: shifted by articulation a's env's
// randomization), its new half angle, and its q and tau out.
template <class T, int ND, bool WITH_DR, class Io, class Ar>
IGT_HD void dof_euler(const float* c, const Io& io, int a, Ar& ar, int d, T dt, T qdd) {
  const float* dc = c + DOF_OFF + d * DOF_STRIDE;
  T v = ar.u[d] + dt * qdd;
  const float mv = ldc(dc + D_MAXVEL);
  if (mv > 0.0f) v = clip_(v, T(-mv), T(mv));
  T p = ar.q[d] + dt * v;
  T lo = T(ldc(dc + D_LO)), hi = T(ldc(dc + D_HI));
  if constexpr (WITH_DR) {   // DR rows 2 ND + d and 3 ND + d: the limit shifts
    lo = lo + T(io.dr(a, 2 * ND + d));
    hi = hi + T(io.dr(a, 3 * ND + d));
  }
  const bool at_lo = p < lo, at_hi = p > hi;
  p = clip_(p, lo, hi);
  if (at_lo) v = max_(v, T(0.0f));
  if (at_hi) v = min_(v, T(0.0f));
  ar.q[d] = p;
  ar.u[d] = v;
  dof_half_angle<T, ND>(c, ar, d);
  io.out(0, a, d, p);
  io.out(2, a, d, ar.tau[d]);
}

// The packed lower factor L of M in place (left-looking Cholesky: each sum in
// ascending k), y = L^-1 rhs and x = L^-T y.
template <class T, int ND>
IGT_HD void factor_solve(T* L, const T* rhs, T* y, T* x) {
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    T* Lj = L + tri(j);
    T s = Lj[j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - Lj[k] * Lj[k];
    const T dia = sqrt_floor(s, 1e-12f);
    Lj[j] = dia;
    const T inv_d = T(1.0f) / dia;
#pragma unroll
    for (int i = j + 1; i < ND; ++i) {
      T* Li = L + tri(i);
      T s2 = Li[j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - Li[k] * Lj[k];
      Li[j] = s2 * inv_d;
    }
  }
  fwd_sub<T, ND>(L, rhs, y);
  back_sub<T, ND>(L, y, x);
}

// Link l's inertia times a.
template <class T, class Dy>
IGT_HD V3<T> inertia_times(const Dy& dy, int l, V3<T> a) {
  const T* iw = dy.Iw[l];
  return v3<T>(iw[0] * a.x + iw[1] * a.y + iw[2] * a.z, iw[1] * a.x + iw[3] * a.y + iw[4] * a.z,
               iw[2] * a.x + iw[4] * a.y + iw[5] * a.z);
}

// The K articulations' dynamics: drive (PD, or the effort input when the
// block's C_DRIVE is 1) with the effort clamp -> FK -> RNEA bias -> mass
// matrix -> Cholesky -> semi-implicit Euler with limits -> FK at the new q.
// ``art(a)``: articulation a's constant block. ``io`` (ArmRows, EnvCols):
// where its DOFs' rows of x and y lie, its base pose and (WITH_DR) its env's
// randomization. Reads q, qd, targets and efforts; writes q and tau. Leaves
// in sh.arm[a] the packed lower factor, the joint velocities and the
// post-step frames.
//
// The bias and M sum over the links in ascending l, as the one-thread bodies
// did: every link's active columns J_li and I_l axw_i (which those formed
// again for each entry) in one phase, then each entry of M and of the bias
// sums its links on a lane of its own.
template <class T, int ND, int K, bool WITH_DR = false, bool SERIAL_FACTOR = false, class Art,
          class Io, class Sh>
IGT_HD void arms_dynamics(Art art, const Io& io, Sh& sh, const Lanes& w) {
  constexpr int HW = WARP / K;

  // drive; u before the step; each link's active columns
  each_arm<K>(w, [=, &sh](int a, int s) {
    const float* c = art(a);
    auto& ar = sh.arm[a];
    const bool effort_drive = ldc(c + C_DRIVE) != 0.0f;
    for (int d = s; d < ND; d += HW) dof_drive<T, ND, WITH_DR>(c, io, a, ar, d, effort_drive);
    const float* mask = c + mask_off(ND);
    auto& dy = sh.s.dyn.arm[a];
    for (int l = s; l < ND; l += HW) {
      unsigned bits = 0;
      int na = 0;
      for (int i = 0; i < ND; ++i) {
        if (ldc(mask + l * ND + i) == 0.0f) continue;
        bits |= 1u << i;
        dy.idx[l][na++] = (unsigned char)i;
      }
      dy.cbits[l] = bits;
      dy.na[l] = (unsigned char)na;
    }
  });

  // FK with the velocity and bias propagation, one lane per articulation
  each_arm<K>(w, [=, &sh](int a, int s) {
    if (s != 0) return;
    V3<T> bp;
    Q4<T> bq;
    io.base(a, art(a), bp, bq);
    fk_walk<T, ND>(art(a), bp, bq, sh.arm[a], sh.s.dyn.arm[a], true);
  });

  // per link: world COM, inertia, force and moment
  each_arm<K>(w, [=, &sh](int a, int s) {
    for (int l = s; l < ND; l += HW)
      link_terms_fixed<T, ND, WITH_DR>(art(a), sh.arm[a], sh.s.dyn.arm[a], l, io, a);
  });

  // every link's active columns
  each_arm<K>(w, [=, &sh](int a, int s) {
    const float* c = art(a);
    const auto& ar = sh.arm[a];
    auto& dy = sh.s.dyn.arm[a];
    int n = 0;
    for (int l = 0; l < ND; ++l) n += dy.na[l];
    for (int p = s; p < n; p += HW) {
      int l = 0, k = p;   // pair p: link l's k-th active column
      while (k >= dy.na[l]) k -= dy.na[l++];
      const int i = dy.idx[l][k];
      const bool rev = dof_rev(c, i);
      dy.J[l][i] = rev ? cross(ar.axw[i], sub(dy.com[l], ar.fp[i])) : ar.axw[i];
      if (rev) dy.Ia[l][i] = inertia_times<T>(dy, l, ar.axw[i]);
    }
  });

  // each entry of M sums over its links in ascending l, a lane each; a
  // diagonal entry's lane also sums the bias of its DOF over the same links,
  // then adds the armature
  each_arm<K>(w, [=, &sh](int a, int s) {
    const float* c = art(a);
    auto& ar = sh.arm[a];
    auto& dy = sh.s.dyn.arm[a];
#pragma unroll
    for (int pass = 0; pass * HW < tri(ND); ++pass) {
      const int t = pass * HW + s;
      if (t >= tri(ND)) continue;
      int i, j;
      tri_entry(t, i, j);
      const bool rev_i = dof_rev(c, i), revs = rev_i && dof_rev(c, j), diag = i == j;
      const V3<T> axi = ar.axw[i];
      T Mij = T(0.0f), acc = T(0.0f);
      // the pass's first row, a link below which has none of its columns
      // (a DOF's ancestors come before it)
#pragma unroll
      for (int l = tri_row(pass * HW); l < ND; ++l) {
        const unsigned cb = dy.cbits[l];
        if (!((cb >> i & 1u) && (cb >> j & 1u))) continue;
        if (diag) {
          if (rev_i) acc = acc + dot(axi, dy.nn[l]);
          acc = acc + dot(dy.J[l][i], dy.f[l]);
        }
        if (revs) Mij = Mij + dot(axi, dy.Ia[l][j]);
        Mij = Mij + T(ldc(c + DOF_OFF + l * DOF_STRIDE + D_MASS)) * dot(dy.J[l][i], dy.J[l][j]);
      }
      if constexpr (WITH_DR) Mij = Mij * T(io.dr(a, 4 * ND));   // M x ms, before the armature
      if (diag) {
        Mij = Mij + T(ldc(c + DOF_OFF + i * DOF_STRIDE + D_ARMATURE));
        dy.rhs[i] = ar.tau[i] - acc;
      }
      ar.L[tri(i) + j] = Mij;
    }
  });
  if constexpr (SERIAL_FACTOR) {
    // the factor, the forward and the back solve for qdd on one lane per
    // articulation (factor_solve)
    each_arm<K>(w, [=, &sh](int a, int s) {
      if (s != 0) return;
      auto& dy = sh.s.dyn.arm[a];
      factor_solve<T, ND>(sh.arm[a].L, dy.rhs, dy.y, dy.qdd);
    });
  } else {
    // row 0's pivot and y_0
    each_arm<K>(w, [=, &sh](int a, int s) {
      if (s != 0) return;
      auto& ar = sh.arm[a];
      auto& dy = sh.s.dyn.arm[a];
      chol_pivot(ar.L, dy.dinv, 0);
      dy.y[0] = dy.rhs[0] / ar.L[0];
    });
    // Cholesky in place (left-looking) with the forward solve: phase j forms
    // column j below the diagonal, each row i also subtracting L_ij^2 from its
    // diagonal and L_ij y_j from its rhs (so both take their terms in
    // ascending j, as the one-row sums would); the owner of row j + 1 then
    // forms that pivot and y_(j+1)
    for (int j = 0; j < ND - 1; ++j) {
      each_arm<K>(w, [=, &sh](int a, int s) {
        auto& ar = sh.arm[a];
        auto& dy = sh.s.dyn.arm[a];
        const T* Lj = ar.L + tri(j);
        for (int i = s; i < ND; i += HW) {
          if (i <= j) continue;
          T* Li = ar.L + tri(i);
          T s2 = Li[j];
          for (int k = 0; k < j; ++k) s2 = s2 - Li[k] * Lj[k];
          const T lij = s2 * dy.dinv[j];
          Li[j] = lij;
          Li[i] = Li[i] - lij * lij;
          dy.rhs[i] = dy.rhs[i] - lij * dy.y[j];
          if (i != j + 1) continue;
          chol_pivot(ar.L, dy.dinv, i);
          dy.y[i] = dy.rhs[i] / Li[i];
        }
      });
    }
    // qdd = L^-T y, one lane per articulation
    each_arm<K>(w, [=, &sh](int a, int s) {
      if (s == 0) back_sub<T, ND>(sh.arm[a].L, sh.s.dyn.arm[a].y, sh.s.dyn.arm[a].qdd);
    });
  }

  // semi-implicit Euler, velocity clamp, joint limits
  each_arm<K>(w, [=, &sh](int a, int s) {
    const float* c = art(a);
    auto& ar = sh.arm[a];
    const T dt = T(ldc(c + C_DT));
    for (int d = s; d < ND; d += HW)
      dof_euler<T, ND, WITH_DR>(c, io, a, ar, d, dt, sh.s.dyn.arm[a].qdd[d]);
  });
  // FK at the new q
  each_arm<K>(w, [=, &sh](int a, int s) {
    if (s != 0) return;
    V3<T> bp;
    Q4<T> bq;
    io.base(a, art(a), bp, bq);
    fk_walk<T, ND>(art(a), bp, bq, sh.arm[a], sh.s.dyn.arm[a], false);
  });
}

// --------------------------------------------------------------- contacts --
// The Jacobian columns of world point ``pt`` on ``link`` (jac_col: only the
// link's ancestors move it), and each column times u_i: column i on lane s
// of the articulation's HW.
template <class T, int ND, int HW>
IGT_HD void contact_cols(const float* ca, const ArmState<T, ND>& ar, ArmContact<T, ND>& ct,
                         V3<T> pt, int link, int s) {
  const float* mask = ca + mask_off(ND);
  for (int i = s; i < ND; i += HW) {
    bool on;
    const V3<T> col = jac_col<T, ND>(ca, mask, link, i, pt, ar.fp, ar.axw, on);
    ct.Jc[i] = col;
    ct.on[i] = on;
    if (on) ct.cu[i] = scale(col, ar.u[i]);
  }
}

// The point's velocity, sum of the active columns times u_i in ascending i.
template <class T, int ND>
IGT_HD V3<T> point_velocity(const ArmContact<T, ND>& ct) {
  V3<T> v = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  for (int i = 0; i < ND; ++i)
    if (ct.on[i]) v = add(v, ct.cu[i]);
  return v;
}

// yn = L^-1 J^T n and yt = L^-1 J^T t_hat with their squares, for every
// articulation whose contact acts: column by column, row i on lane i of the
// articulation's lanes subtracting in ascending j, as a forward substitution
// does.
template <class T, int ND, int K, class Sh>
IGT_HD void contact_solve(Sh& sh, const Lanes& w) {
  constexpr int HW = WARP / K;
  each_arm<K>(w, [=, &sh](int a, int s) {
    auto& ct = sh.s.ct.arm[a];
    if (!ct.act) return;
    for (int i = s; i < ND; i += HW) {
      ct.bn[i] = ct.on[i] ? dot(ct.Jc[i], ct.n) : T(0.0f);
      ct.bt[i] = ct.on[i] ? dot(ct.Jc[i], ct.t_hat) : T(0.0f);
    }
    if (s == 0) {
      const T* L = sh.arm[a].L;
      ct.yn[0] = ct.bn[0] / L[0];
      ct.sqn[0] = ct.yn[0] * ct.yn[0];
      ct.yt[0] = ct.bt[0] / L[0];
      ct.sqt[0] = ct.yt[0] * ct.yt[0];
    }
  });
  for (int j = 0; j < ND - 1; ++j) {
    each_arm<K>(w, [=, &sh](int a, int s) {
      auto& ct = sh.s.ct.arm[a];
      if (!ct.act) return;
      const T* L = sh.arm[a].L;
      for (int i = s; i < ND; i += HW) {
        if (i <= j) continue;
        const T lij = L[tri(i) + j];
        ct.bn[i] = ct.bn[i] - lij * ct.yn[j];
        ct.bt[i] = ct.bt[i] - lij * ct.yt[j];
        if (i != j + 1) continue;
        const T lii = L[tri(i) + i];
        ct.yn[i] = ct.bn[i] / lii;
        ct.sqn[i] = ct.yn[i] * ct.yn[i];
        ct.yt[i] = ct.bt[i] / lii;
        ct.sqt[i] = ct.yt[i] * ct.yt[i];
      }
    });
  }
}

// u += L^-T (yn an + yt at), or L^-T (yn an - yt at) with ``minus``, for
// every articulation whose contact acts: one lane each, back_sub's order.
template <class T, int ND, int K, class Sh>
IGT_HD void contact_back(Sh& sh, const Lanes& w) {
  each_arm<K>(w, [=, &sh](int a, int s) {
    auto& ct = sh.s.ct.arm[a];
    if (!ct.act || s != 0) return;
    auto& ar = sh.arm[a];
    const T an = ct.an, at = ct.at;
    for (int i = 0; i < ND; ++i)
      ct.jv[i] = ct.minus ? ct.yn[i] * an - ct.yt[i] * at : ct.yn[i] * an + ct.yt[i] * at;
    back_sub<T, ND>(ar.L, ct.jv, ct.du);
    for (int i = 0; i < ND; ++i) ar.u[i] = ar.u[i] + ct.du[i];
  });
}

// ---------------------------------------------------- a ball's contacts --
// Shared by K2 (fused_substep_warp.cuh) and K3 (fused_substep_multi.cuh).

// A ball through the contact phase: its state, its plane and static impulse,
// its articulated geoms' reaction and (WITH_TORQUE) its moment.
template <class T>
struct BallState {
  V3<T> pos, vel, omg, s_imp, b_art, tq;
};

// The test of a ball against one articulated geom, split over lanes (the
// ball-vs-art contact's arithmetic up to its test): the geometry (the ball in
// the geom's frame, its depth and normal there and in the world, the contact
// point), the point's Jacobian columns and each times u, the relative
// velocity, the four sweep samples and each one's sphere test, the swept
// normal and the normal velocity.
constexpr int SWEEP_ART = 4;   // the ball-vs-art contact's sweep samples
template <class T, int ND>
struct ArtTest {
  V3<T> c0, n_now_l, n_now, cp, v_rel, n;
  Q4<T> gq;
  T d_now, vn;
  V3<T> Jc[ND], cu[ND];
  unsigned char on[ND];
  V3<T> ck[SWEEP_ART], nk[SWEEP_ART];
  T dk[SWEEP_ART];
  int near;   // not culled (apart): the test runs
};

// The radius of a sphere about a geom's centre that holds the geom (kind,
// half sizes s): its radius, a box's half diagonal, a cylinder's corner.
template <class T>
IGT_HD T hull_radius(int kind, const float* s) {
  const T a = T(ldc(s)), b = T(ldc(s + 1)), c = T(ldc(s + 2));
  if (kind == GEOM_SPHERE) return a;
  if (kind == GEOM_BOX) return sqrt_(a * a + b * b + c * c);
  return sqrt_(a * a + b * b);
}

// Whether two bodies whose centres are ``gap`` apart, within radii ra and rb
// of them, stay apart while one moves ``reach`` further: the distance tests
// of the contacts below are 1-Lipschitz and at least the centre distance less
// the hull radii, so no sample of such a pair can penetrate. The margin (1
// cm and 0.1 %) dwarfs the float32 rounding of both sides, so a cull only
// skips tests that cannot act.
template <class T>
IGT_HD bool apart(T gap, T ra, T rb, T reach) {
  const T need = ra + rb + reach;
  return gap - need > T(0.01f) + T(1e-3f) * (gap + need);
}

// The frame of ``link`` as the ball-vs-art and art-vs-static contacts take it: the link's
// post-step frame, or for a link outside the articulation the origin with
// the base's orientation.
template <class T, int ND, class Ar>
IGT_HD void link_frame(const float* ca, const Ar& ar, int link, V3<T>& lp, Q4<T>& lq) {
  if (link >= 0 && link < ND) {
    lp = ar.fp[link];
    lq = ar.fq[link];
    return;
  }
  lp = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  lq = cq4<T>(ca + C_BASE_Q);
}

// Pair entry pr (art geom g of the articulation with block ca, true static
// sg): the art-vs-static contact's narrowphase of the geom's bounding sphere, with exact
// support of a cylinder or box along the normal where the pair says so: the
// contact point, normal and depth.
template <class T, int ND, class Ar>
IGT_HD void pair_narrowphase(const float* ca, const Ar& ar, const float* pr, const float* g,
                             const float* sg, V3<T>& point, V3<T>& n, T& dist) {
  const T rbound = T(ldc(g + A_RBOUND));
  V3<T> lp;
  Q4<T> lq;
  link_frame<T, ND>(ca, ar, (int)ldc(g + A_LINK), lp, lq);
  const V3<T> center = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
  const float* R = sg + G_ROT;
  const V3<T> c_local = mat_t(R, sub(center, cv3<T>(sg + G_POS)));
  V3<T> n_local;
  sphere_geom((int)ldc(sg + G_KIND), sg + G_SIZE, c_local, rbound, dist, n_local);
  n = mat(R, n_local);
  if (ldc(pr + P_EXACT) != 0.0f) {
    const V3<T> n_g = qrot(conj(qmul(lq, cq4<T>(g + A_OFF_QUAT))), n);
    const float* gs = g + A_SIZE;
    T sup;
    if ((int)ldc(g + A_KIND) == GEOM_CYLINDER) {
      const T na = abs_(n_g.z);
      sup = na * T(ldc(gs + 1)) + sqrt_floor(T(1.0f) - na * na, 0.0f) * T(ldc(gs));
    } else {
      sup = abs_(n_g.x) * T(ldc(gs)) + abs_(n_g.y) * T(ldc(gs + 1))
            + abs_(n_g.z) * T(ldc(gs + 2));
    }
    dist = dist + rbound - sup;
    point = sub(center, scale(n, sup));
  } else {
    point = sub(center, scale(n, rbound));
  }
}

}  // namespace igt
