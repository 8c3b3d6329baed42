// K4, the fused physics substep of one floating-base humanoid with one ball
// (the 27-DOF whole-body C10 scene), and its torque-lane build K4-tau: the
// per-env body, run by one warp.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:2225
// (build_fused_substep_floating; K4 with with_torque=False, K4-tau with
// with_torque=True, the compile-time WITH_TORQUE), in its order:
// PD or effort drive with the effort clamp -> FK from the runtime base pose
// -> velocity and bias propagation with the base composite link (link ND,
// moved only by the six base columns) -> per link its world COM, inertia,
// wrench and Jacobian columns over u = [omega, v, qdot] (NV = ND + 6),
// accumulated into the RNEA bias and the packed mass matrix -> NV x NV
// Cholesky and the solve -> semi-implicit Euler: the base's angular and
// linear velocity clamps, the DOF velocity clamp, joint limits, the base
// quaternion q += dt/2 [omega, 0] q normalized -> FK at the new pose -> the
// ball's flight, the plane and the static geoms (K2's phase functions) ->
// the ball against every articulated geom, its reaction through the factor
// into the whole generalized velocity (a paddle strike kicks the base) ->
// every articulated geom against the true statics (Baumgarte with exact
// support and K2's 2 mm resting band) -> every articulated geom's bounding
// sphere against the ground (the feet) -> the ball's caps and integration.
//
// K4-tau (WITH_TORQUE) also writes the force sensors' moment rows after the
// impulse rows (pallas_dynamics.py:2652-2658, :2693-2696, :2762-2767,
// :2834-2837, :2879-2884): each articulated geom body's contact moment about
// its frame origin (the link's post-step origin plus its rotated body_off,
// A_BODY_OFF) from the ball's reactions and the art-vs-static impulses, and
// the ball's moment about its centre from the plane, the statics and the
// articulation; the articulated geoms' ground contacts stay unrecorded, as
// in the JAX package. It is built only for scenes that register a force
// sensor; WITH_TORQUE = false compiles to K4 unchanged. Its moment
// accumulators add 3 (FL_MAX_ART + 1) floats to the env's shared block.
//
// One warp per env (the phases of warp.cuh, shared with K3). The body is a
// sequence of phases: each() runs a share of the work on every lane and
// then syncs the warp, one() runs lane 0 alone.
// State passes from phase to phase only through the env's block of shared
// memory (FloatShared: the packed M and its factor, u, the frames, the
// per-link terms and active columns, a contact's Jacobian columns and
// solves); no lane reads in a phase what another lane writes in it. Code
// between phases runs on every lane and only reads the block (a contact's
// flag, the next pair's point); a phase that overwrites what such code read
// with no phase in between starts with sync() (the refill of the pairs'
// chunk, where the chunk's last pair did not act). The same
// header is compiled two ways: inside the __global__ wrapper of
// fused_substep_floating.cu (nvcc, sm_90a: each thread runs its own lane,
// the block a __shared__ struct) and inside the host loop of
// fused_substep_host.cpp (g++: one thread runs the 32 lanes of each phase in
// turn, forward or in reverse, the block a local struct), which the CPU
// tests hold against the plain PyTorch version and which counts the
// operations this data needs. Scene constants are read at run time from one
// float32 buffer (layout below, mirrored by
// isaacgym_tpu_torch/ops/fused_substep_floating.py); only the DOF count ND
// is a compile-time parameter.
//
// How the lanes share the work:
//   - drive, Euler, outputs: one lane per generalized coordinate or channel;
//   - FK and the velocity propagation: one lane per DOF, one phase per depth
//     of the kinematic tree (10 at C10's G1);
//   - each link's world COM, inertia, force and moment: one lane per link;
//   - bias and mass matrix, link by link in ascending l: one lane per active
//     column (the six base columns and the link's ancestors, at most 16 of
//     33 for the G1), then the link's na (na + 1) / 2 entries of the packed
//     M split over the lanes; the entries of link l - 1 and the columns of
//     link l share a phase, the columns double-buffered;
//   - the left-looking Cholesky: one phase per column j, row i > j on lane
//     i mod 32 with its serial k-sum, which also subtracts L_ij^2 from the
//     row's diagonal (its terms in ascending j, as a k-sum at the end would
//     take them); the owner of row j + 1 then takes that pivot's root;
//   - a lane walks its rows from the highest down: at NV = 33 lane 0 holds
//     rows 0 and 32, and row 32 then runs in the phase's one pass with the
//     other lanes' rows, not in a second pass of its own;
//   - the triangular solves: column-oriented, one phase per column (forward
//     in ascending j, back in descending j), both of a contact's directions
//     in the same phases;
//   - a contact: its geometry on one lane, one Jacobian column per lane, the
//     sums over its 33 columns (the point's velocity, |y|^2) on one lane in
//     ascending order;
//   - the narrowphase of every art-vs-static pair and every ground test, one
//     lane each, before the contacts that need it in turn: it reads only the
//     post-step frames.
// Every value is formed by the same operations in the same order as in the
// one-thread-per-env body this design replaced, so the outputs are the same
// bits and the counted operations (the bound's) are the same: lanes split
// work and never repeat it, and code outside the phases runs once on the
// host.
//
// What bounds it on an H100: the latency of each warp's chain of phases. An
// env does about 7.6e4 FP32 operations (at C10 on random-action states) in a
// few hundred dependent phases: the tree's depth twice, each link's columns
// and entries, the Cholesky's 33 columns, each solve's 33 steps, each
// contact's one-lane geometry and sums. At C10's 2048 envs, four envs to a
// block (an 11 KB shared block each), all 512 blocks are resident on the 132
// SMs at once, four blocks and 16 warps to an SM; at 528 envs (one block,
// four warps, to an SM) a launch takes nearly as long, so the SMs'
// instruction throughput is not the limit, each warp's chain is: a lane's work that the
// others wait for (a second row, a pivot's serial sum) adds to it in full.
// No spills; the 32-byte stack frame is sinf/cosf's argument-reduction
// scratch, used only for |x| > 1e5. Blocked solves, the k-sums' loads
// grouped and the contact helpers called instead of inlined did not
// shorten the chain (PERF.md).
#pragma once

#include <type_traits>

#include "fused_substep.cuh"
#include "warp.cuh"

namespace igt {

// ---------------------------------------------------------------- layout --
// K2's header slots (0 .. 40), then K4's; K2's DOF table and ancestor mask;
// the base composite link's block; static, articulated and pair entries with
// K2's slots (an articulated entry's A_LINK is -1 for a base-welded geom).
constexpr int FL_MAX_STATIC = 16;
constexpr int FL_MAX_ART = 16;
constexpr int FL_MAX_PAIRS = 64;
constexpr int FL_BASE_STRIDE = 16;
enum : int { C_BASE_MAX_ANG = 41, C_BASE_MAX_LIN = 42, C_E_GND = 43, C_MU_GND = 44,
             C_ART_STATIC = 45 };
enum : int { B_MASS = 0, B_COM = 1, B_INERTIA = 4 };

IGT_HD constexpr int fl_base_off(int nd) { return mask_off(nd) + nd * nd; }
IGT_HD constexpr int fl_static_off(int nd) { return fl_base_off(nd) + FL_BASE_STRIDE; }
IGT_HD constexpr int fl_art_off(int nd) { return fl_static_off(nd) + FL_MAX_STATIC * STATIC_STRIDE; }
IGT_HD constexpr int fl_pair_off(int nd) { return fl_art_off(nd) + FL_MAX_ART * ART_STRIDE; }
IGT_HD constexpr int fl_total(int nd) { return fl_pair_off(nd) + FL_MAX_PAIRS * PAIR_STRIDE; }
// inputs: q, qd, targets, efforts (nd each), base pos, quat, linvel, angvel,
// ball pos, vel, omega; outputs: q, qd, tau, the base's and the ball's
// state (22 rows), then ng + 1 impulse rows, and with the torque lanes ng + 1
// moment rows
IGT_HD constexpr int fl_n_in(int nd) { return 4 * nd + 22; }
IGT_HD constexpr int fl_n_out(int nd, int ng, bool with_torque = false) {
  return 3 * nd + 22 + 3 * (ng + 1) * (with_torque ? 2 : 1);
}

// Fills ``out`` with the layout in the order of fused_substep_floating.py's
// _LAYOUT_KEYS, so the Python side can check it.
inline int fill_floating_layout(int nd, int* out, int n) {
  if (n < 14 || nd < 1) return 1;
  const int v[14] = {DOF_OFF, mask_off(nd), fl_base_off(nd), fl_static_off(nd), fl_art_off(nd),
                     fl_pair_off(nd), fl_total(nd), FL_MAX_STATIC, FL_MAX_ART, FL_MAX_PAIRS,
                     C_BASE_MAX_ANG, C_ART_STATIC, fl_n_in(nd), fl_n_out(nd, 1)};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// ---------------------------------------------------------- shared block --
// The dynamics' scratch: dead once the post-step frames are formed.
template <class T, int ND>
struct FloatDyn {
  static constexpr int NV = ND + 6, NL = ND + 1;
  T rhs[NV], acc[NV], udot[NV], dinv[NV];   // tau - bias; the bias; u-dot; 1 / L_jj
  V3<T> w[ND], wd[ND], ao[ND];    // per DOF frame: angular velocity and the bias rates
  // per link (the base composite at ND): world COM, COM - base origin,
  // m (a_com - g), I wd + w x I w, and the world inertia (xx xy xz yy yz zz)
  V3<T> com[NL], rb[NL], f[NL], nn[NL];
  T Iw[NL][6];
  unsigned char na[NL], idx[NL][NV];   // per link: its active columns
  V3<T> Ja[2][NV], Jl[2][NV], IJa[2][NV];   // one link's active columns, double-buffered
};

// The contacts' scratch.
template <class T, int ND, bool WITH_TORQUE>
struct FloatContact {
  static constexpr int NV = ND + 6;
  V3<T> pos, vel, omg, imp, tqb;   // the ball, the impulse on it and its moment
  V3<T> geom_imp[FL_MAX_ART], geom_tq[WITH_TORQUE ? FL_MAX_ART : 1];
  V3<T> gp[FL_MAX_ART];            // each art geom's pose, for the ball
  Q4<T> gq[FL_MAX_ART];
  V3<T> gnd_pt[FL_MAX_ART];        // its bounding sphere's lowest point, and its height
  T gnd_dist[FL_MAX_ART];
  V3<T> pr_pt[WARP], pr_n[WARP];   // a chunk of pairs: contact point, normal, depth
  T pr_dist[WARP];
  // one contact
  V3<T> c0, n_now_l, n_now, pt, n, t_hat;
  T d_now, vn, e_eff, vt_n, bias, an, at;
  int act;
  V3<T> cols[NV], cu[NV];          // the point's Jacobian columns, and each times u_k
  T bn[NV], bt[NV], yn[NV], yt[NV], sqn[NV], sqt[NV];   // J^T n, J^T t; L^-1 of them; squares
};

// One env's block: the packed M (then its factor), u, the frames and the
// base pose (before the step, then after), and the scratch.
template <class T, int ND, bool WITH_TORQUE>
struct FloatShared {
  static constexpr int NV = ND + 6;
  T L[NV * (NV + 1) / 2];
  T u[NV];
  T q[ND];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
  V3<T> bp;
  Q4<T> bq;
  int depth[ND];   // each DOF's depth in the tree
  Overlay<FloatDyn<T, ND>, FloatContact<T, ND, WITH_TORQUE>,
          std::is_trivially_default_constructible<T>::value> s;
};

// ------------------------------------------------------------ kinematics --
// DOF d's frame and world axis from its parent's (or the base's).
template <class T, class Sh>
IGT_HD void fk_dof(const float* c, Sh& sh, int d) {
  const float* dc = c + DOF_OFF + d * DOF_STRIDE;
  const int par = (int)ldc(dc + D_PARENT);
  const V3<T> pp = par < 0 ? sh.bp : sh.fp[par];
  const Q4<T> pq = par < 0 ? sh.bq : sh.fq[par];
  V3<T> jp = add(pp, qrot(pq, cv3<T>(dc + D_PRE_POS)));
  Q4<T> jq = qmul(pq, cq4<T>(dc + D_PRE_QUAT));
  V3<T> ax = cv3<T>(dc + D_AXIS);
  Q4<T> fq;
  V3<T> fp;
  if (ldc(dc + D_REV) != 0.0f) {
    T half = T(0.5f) * sh.q[d];
    T s = sin_(half), co = cos_(half);
    Q4<T> r; r.x = ax.x * s; r.y = ax.y * s; r.z = ax.z * s; r.w = co;
    fq = qmul(jq, r);
    fp = jp;
  } else {
    fq = jq;
    fp = add(jp, scale(qrot(jq, ax), sh.q[d]));
  }
  sh.fq[d] = fq;
  sh.fp[d] = fp;
  sh.axw[d] = qrot(fq, ax);
}

// The largest depth of the tree (sh.depth is set).
template <int ND, class Sh>
IGT_HD int max_depth(const Sh& sh) {
  int m = 0;
  for (int d = 0; d < ND; ++d) m = sh.depth[d] > m ? sh.depth[d] : m;
  return m;
}

// The world pose of articulated geom entry g (its link frame, or the base).
template <class T, class Sh>
IGT_HD void geom_pose(const Sh& sh, const float* g, V3<T>& gp, Q4<T>& gq) {
  const int link = (int)ldc(g + A_LINK);
  const V3<T> lp = link < 0 ? sh.bp : sh.fp[link];
  const Q4<T> lq = link < 0 ? sh.bq : sh.fq[link];
  gp = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
  gq = qmul(lq, cq4<T>(g + A_OFF_QUAT));
}

// The world position of entry g's body frame origin, the point its moments
// are taken about (borg_of, pallas_dynamics.py:2660-2664).
template <class T, class Sh>
IGT_HD V3<T> body_origin(const Sh& sh, const float* g) {
  const int link = (int)ldc(g + A_LINK);
  const V3<T> lp = link < 0 ? sh.bp : sh.fp[link];
  const Q4<T> lq = link < 0 ? sh.bq : sh.fq[link];
  return add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)));
}

// FK of every DOF frame, one phase per depth; with ``vel`` also the velocity
// and bias propagation (u-dot = 0) from the base (omega, 0, 0).
template <class T, int ND, class Sh>
IGT_HD void fk_levels(const float* c, Sh& sh, const Lanes& w, bool vel) {
  auto& dy = sh.s.dyn;
  const int levels = max_depth<ND>(sh);
  for (int lev = 0; lev <= levels; ++lev) {
    each(w, [=, &sh, &dy](int lane) {
      const T zero = T(0.0f);
      const V3<T> zero3 = v3<T>(zero, zero, zero);
      for (int d = lane; d < ND; d += WARP) {
        if (sh.depth[d] != lev) continue;
        fk_dof<T>(c, sh, d);
        if (!vel) continue;
        const float* dc = c + DOF_OFF + d * DOF_STRIDE;
        const int par = (int)ldc(dc + D_PARENT);
        const V3<T> w_p = par < 0 ? v3<T>(sh.u[0], sh.u[1], sh.u[2]) : dy.w[par];
        const V3<T> wd_p = par < 0 ? zero3 : dy.wd[par];
        const V3<T> ao_p = par < 0 ? zero3 : dy.ao[par];
        const V3<T> o_p = par < 0 ? sh.bp : sh.fp[par];
        const V3<T> axw = sh.axw[d];
        const T qd = sh.u[6 + d];
        V3<T> r = sub(sh.fp[d], o_p);
        V3<T> ao_d = add(ao_p, add(cross(wd_p, r), cross(w_p, cross(w_p, r))));
        if (ldc(dc + D_REV) != 0.0f) {
          dy.w[d] = add(w_p, scale(axw, qd));
          dy.wd[d] = add(wd_p, scale(cross(w_p, axw), qd));
        } else {
          dy.w[d] = w_p;
          dy.wd[d] = wd_p;
          ao_d = add(ao_d, scale(cross(w_p, axw), T(2.0f) * qd));
        }
        dy.ao[d] = ao_d;
      }
    });
  }
}

// -------------------------------------------------------- triangular solves --
// y = L^-1 b column by column: once y_j is known the lanes of the rows i > j
// (row i on lane i mod 32) subtract L_ij y_j, so each row subtracts in
// ascending j as a row-oriented forward substitution does, and the owner of
// row j + 1 then divides. ``pro(lane)`` first forms b's rows on their own
// lanes. b is consumed. TWO: a second right-hand side b2 -> y2 in the same
// phases; SQ: the owner of row i also writes y_i^2 (and y2_i^2).
template <class T, int NV, bool TWO, bool SQ, class P>
IGT_HD void fwd_cols(const Lanes& w, const T* L, T* b, T* y, T* sq, T* b2, T* y2, T* sq2,
                     P pro) {
  each(w, [=](int lane) {
    pro(lane);
    if (lane == 0) {
      y[0] = b[0] / L[0];
      if constexpr (SQ) sq[0] = y[0] * y[0];
      if constexpr (TWO) {
        y2[0] = b2[0] / L[0];
        if constexpr (SQ) sq2[0] = y2[0] * y2[0];
      }
    }
  });
  for (int j = 0; j < NV - 1; ++j) {
    each(w, [=](int lane) {
      for (int i = top_index(lane, NV); i > j; i -= WARP) {
        const T lij = L[tri(i) + j];
        b[i] = b[i] - lij * y[j];
        if constexpr (TWO) b2[i] = b2[i] - lij * y2[j];
        if (i != j + 1) continue;
        const T lii = L[tri(i) + i];
        y[i] = b[i] / lii;
        if constexpr (SQ) sq[i] = y[i] * y[i];
        if constexpr (TWO) {
          y2[i] = b2[i] / lii;
          if constexpr (SQ) sq2[i] = y2[i] * y2[i];
        }
      }
    });
  }
}

// x = L^-T y column by column in descending j: once x_j is known the lanes
// of the rows i < j subtract L_ji x_j (each row over descending j, as a
// row-oriented back substitution), and the owner of row j - 1 then divides.
// ``pro(lane)`` first forms y's rows on their own lanes; y is consumed.
// With ``add_to``, the owner of row i also adds x_i to add_to[i].
template <class T, int NV, class P>
IGT_HD void back_cols(const Lanes& w, const T* L, T* yv, T* x, T* add_to, P pro) {
  each(w, [=](int lane) {
    pro(lane);
    if (lane == (NV - 1) % WARP) {
      x[NV - 1] = yv[NV - 1] / L[tri(NV - 1) + NV - 1];
      if (add_to) add_to[NV - 1] = add_to[NV - 1] + x[NV - 1];
    }
  });
  for (int j = NV - 1; j > 0; --j) {
    each(w, [=](int lane) {
      for (int i = lane; i < j; i += WARP) {
        yv[i] = yv[i] - L[tri(j) + i] * x[j];
        if (i != j - 1) continue;
        x[i] = yv[i] / L[tri(i) + i];
        if (add_to) add_to[i] = add_to[i] + x[i];
      }
    });
  }
}

// --------------------------------------------------------------- dynamics --
// Link l's world COM, inertia, force and moment (the base composite at ND).
template <class T, int ND, class Sh>
IGT_HD void link_terms(const float* c, Sh& sh, int l) {
  auto& dy = sh.s.dyn;
  const T zero = T(0.0f);
  const V3<T> zero3 = v3<T>(zero, zero, zero);
  const bool is_base = l == ND;
  const float* lc = is_base ? c + fl_base_off(ND) : c + DOF_OFF + l * DOF_STRIDE;
  const float* lcom = is_base ? lc + B_COM : lc + D_COM;
  const float* I = is_base ? lc + B_INERTIA : lc + D_INERTIA;
  const T m = T(ldc(is_base ? lc + B_MASS : lc + D_MASS));
  const V3<T> org = is_base ? sh.bp : sh.fp[l];
  const Q4<T> qq = is_base ? sh.bq : sh.fq[l];
  const V3<T> wl = is_base ? v3<T>(sh.u[0], sh.u[1], sh.u[2]) : dy.w[l];
  const V3<T> wdl = is_base ? zero3 : dy.wd[l];
  const V3<T> aol = is_base ? zero3 : dy.ao[l];
  const V3<T> g = v3<T>(T(ldc(c + C_GX)), T(ldc(c + C_GY)), T(ldc(c + C_GZ)));
  V3<T> com = add(org, qrot(qq, cv3<T>(lcom)));
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
  T RI[3][3], Iw[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      RI[i][j] = R[i][0] * T(ldc(I + j)) + R[i][1] * T(ldc(I + 3 + j)) + R[i][2] * T(ldc(I + 6 + j));
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
      Iw[j][i] = Iw[i][j];
    }
  V3<T> rc = sub(com, org);
  V3<T> a_com = add(aol, add(cross(wdl, rc), cross(wl, cross(wl, rc))));
  V3<T> Iwd = v3<T>(Iw[0][0] * wdl.x + Iw[0][1] * wdl.y + Iw[0][2] * wdl.z,
                    Iw[1][0] * wdl.x + Iw[1][1] * wdl.y + Iw[1][2] * wdl.z,
                    Iw[2][0] * wdl.x + Iw[2][1] * wdl.y + Iw[2][2] * wdl.z);
  V3<T> Iww = v3<T>(Iw[0][0] * wl.x + Iw[0][1] * wl.y + Iw[0][2] * wl.z,
                    Iw[1][0] * wl.x + Iw[1][1] * wl.y + Iw[1][2] * wl.z,
                    Iw[2][0] * wl.x + Iw[2][1] * wl.y + Iw[2][2] * wl.z);
  dy.com[l] = com;
  dy.rb[l] = sub(com, sh.bp);
  dy.f[l] = scale(sub(a_com, g), m);
  dy.nn[l] = add(Iwd, cross(wl, Iww));
  T* iw = dy.Iw[l];
  iw[0] = Iw[0][0]; iw[1] = Iw[0][1]; iw[2] = Iw[0][2];
  iw[3] = Iw[1][1]; iw[4] = Iw[1][2]; iw[5] = Iw[2][2];
}

// Active column k of link l (index sh.s.dyn.idx[l][k]) into buffer ``buf``:
// its angular and linear parts and the world inertia times the angular
// part; its bias term joins acc.
template <class T, int ND, class Sh>
IGT_HD void link_column(const float* c, Sh& sh, int l, int k, int buf) {
  auto& dy = sh.s.dyn;
  const T z = T(0.0f), o = T(1.0f);
  const int col = dy.idx[l][k];
  V3<T> Ja, Jl;
  if (col < 3) {
    const V3<T> e = v3<T>(col == 0 ? o : z, col == 1 ? o : z, col == 2 ? o : z);
    Ja = e;
    Jl = cross(e, dy.rb[l]);
  } else if (col < 6) {
    Ja = v3<T>(z, z, z);
    Jl = v3<T>(col == 3 ? o : z, col == 4 ? o : z, col == 5 ? o : z);
  } else {
    const int d = col - 6;
    if (ldc(c + DOF_OFF + d * DOF_STRIDE + D_REV) != 0.0f) {
      Ja = sh.axw[d];
      Jl = cross(sh.axw[d], sub(dy.com[l], sh.fp[d]));
    } else {
      Ja = v3<T>(z, z, z);
      Jl = sh.axw[d];
    }
  }
  dy.acc[col] = dy.acc[col] + (dot(Ja, dy.nn[l]) + dot(Jl, dy.f[l]));
  const T* iw = dy.Iw[l];
  dy.Ja[buf][k] = Ja;
  dy.Jl[buf][k] = Jl;
  dy.IJa[buf][k] = v3<T>(iw[0] * Ja.x + iw[1] * Ja.y + iw[2] * Ja.z,
                         iw[1] * Ja.x + iw[3] * Ja.y + iw[4] * Ja.z,
                         iw[2] * Ja.x + iw[4] * Ja.y + iw[5] * Ja.z);
}

// Drive -> FK -> bias and mass matrix over [omega, v, qdot] -> Cholesky ->
// Euler with the clamps, limits and base integration -> FK at the new pose.
// Writes q and tau (rows 0 .. and 2 ND ..) and the base pose (3 ND ..).
template <class T, int ND, class Sh>
IGT_HD void floating_dynamics(const float* __restrict__ c, const float* __restrict__ x,
                              float* __restrict__ y, int b, size_t sB, Sh& sh,
                              const Lanes& w) {
  constexpr int NV = ND + 6, NL = ND + 1;
  auto& dy = sh.s.dyn;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  const bool effort_drive = ldc(c + C_DRIVE) != 0.0f;
  const int ib = 4 * ND;

  // drive; u, M and the bias before the step; each link's active columns
  // (the base's six, then its ancestors) and each DOF's depth
  each(w, [=, &sh, &dy](int lane) {
    const float* mask = c + mask_off(ND);
    for (int k = top_index(lane, NV); k >= 0; k -= WARP) {
      dy.acc[k] = T(0.0f);
      if (k < 6) {   // u = [omega, v, ...]: the inputs' angvel, then linvel
        dy.rhs[k] = T(0.0f);
        sh.u[k] = IGT_IN(k < 3 ? ib + 10 + k : ib + 4 + k);
        continue;
      }
      const int d = k - 6;
      const float* dc = c + DOF_OFF + d * DOF_STRIDE;
      const T q = IGT_IN(d), qd = IGT_IN(ND + d);
      T t = effort_drive ? IGT_IN(3 * ND + d)
          : T(ldc(dc + D_KP)) * (IGT_IN(2 * ND + d) - q) - T(ldc(dc + D_KD)) * qd
                + IGT_IN(3 * ND + d);
      const T eff = T(ldc(dc + D_EFFORT));
      t = clip_(t, -eff, eff);
      dy.rhs[k] = t;
      sh.q[d] = q;
      sh.u[k] = qd;
      IGT_OUT(2 * ND + d, t);
      int dep = 0;
      for (int p = (int)ldc(dc + D_PARENT); p >= 0; p = (int)ldc(c + DOF_OFF + p * DOF_STRIDE + D_PARENT))
        ++dep;
      sh.depth[d] = dep;
    }
    for (int i = lane; i < tri(NV); i += WARP) sh.L[i] = T(0.0f);
    for (int l = lane; l < NL; l += WARP) {
      int na = 0;
      for (int k = 0; k < 6; ++k) dy.idx[l][na++] = (unsigned char)k;
      if (l < ND)
        for (int d = 0; d < ND; ++d)
          if (ldc(mask + l * ND + d) != 0.0f) dy.idx[l][na++] = (unsigned char)(6 + d);
      dy.na[l] = (unsigned char)na;
    }
    if (lane == 0) {
      sh.bp = v3<T>(IGT_IN(ib), IGT_IN(ib + 1), IGT_IN(ib + 2));
      Q4<T> bq;
      bq.x = IGT_IN(ib + 3); bq.y = IGT_IN(ib + 4); bq.z = IGT_IN(ib + 5); bq.w = IGT_IN(ib + 6);
      sh.bq = bq;
    }
  });

  fk_levels<T, ND>(c, sh, w, true);

  // per link (DOF links, then the base composite at ND): world COM,
  // inertia, force and moment
  each(w, [=, &sh](int lane) {
    for (int l = lane; l < NL; l += WARP) link_terms<T, ND>(c, sh, l);
  });

  // the bias and the mass matrix accumulate link by link (ascending l per
  // entry): phase l forms link l's active columns and adds link l - 1's
  // entries M[idx k1][idx k2] (k1 >= k2, the na (na + 1) / 2 of them split
  // over the lanes)
  for (int l = 0; l <= NL; ++l) {
    each(w, [=, &sh, &dy](int lane) {
      if (l > 0) {
        const int lp = l - 1, buf = lp & 1, na = dy.na[lp];
        const float* lc = lp == ND ? c + fl_base_off(ND) : c + DOF_OFF + lp * DOF_STRIDE;
        const T m = T(ldc(lp == ND ? lc + B_MASS : lc + D_MASS));
        for (int t = lane; t < tri(na); t += WARP) {
          int k1, k2;
          tri_entry(t, k1, k2);
          T& Mij = sh.L[tri(dy.idx[lp][k1]) + dy.idx[lp][k2]];
          Mij = Mij + (dot(dy.Ja[buf][k1], dy.IJa[buf][k2])
                       + m * dot(dy.Jl[buf][k1], dy.Jl[buf][k2]));
        }
      }
      if (l < NL)
        for (int k = lane; k < dy.na[l]; k += WARP) link_column<T, ND>(c, sh, l, k, l & 1);
    });
  }

  // rhs = tau_gen - bias; armature on the DOF diagonal; column 0's diagonal
  each(w, [=, &sh, &dy](int lane) {
    for (int i = top_index(lane, NV); i >= 0; i -= WARP) {
      dy.rhs[i] = dy.rhs[i] - dy.acc[i];
      if (i >= 6)
        sh.L[tri(i) + i] = sh.L[tri(i) + i]
            + T(ldc(c + DOF_OFF + (i - 6) * DOF_STRIDE + D_ARMATURE));
    }
    if (lane == 0) chol_pivot(sh.L, dy.dinv, 0);
  });
  // Cholesky in place (left-looking): phase j forms column j below the
  // diagonal, each row i also subtracting L_ij^2 from its diagonal (so the
  // diagonal's terms go in ascending j, as its k-sum would), and the owner
  // of row j + 1 then forms that pivot
  for (int j = 0; j < NV - 1; ++j) {
    each(w, [=, &sh, &dy](int lane) {
      const T* Lj = sh.L + tri(j);
      for (int i = top_index(lane, NV); i > j; i -= WARP) {
        T* Li = sh.L + tri(i);
        T s2 = Li[j];
        for (int k = 0; k < j; ++k) s2 = s2 - Li[k] * Lj[k];
        const T lij = s2 * dy.dinv[j];
        Li[j] = lij;
        Li[i] = Li[i] - lij * lij;
        if (i == j + 1) chol_pivot(sh.L, dy.dinv, i);
      }
    });
  }
  fwd_cols<T, NV, false, false>(w, sh.L, dy.rhs, dy.acc, (T*)nullptr, (T*)nullptr,
                                (T*)nullptr, (T*)nullptr, [](int) {});
  back_cols<T, NV>(w, sh.L, dy.acc, dy.udot, (T*)nullptr, [](int) {});

  // semi-implicit Euler: base velocity clamps, DOF clamp and limits
  each(w, [=, &sh, &dy](int lane) {
    const T dt = T(ldc(c + C_DT));
    const T zero = T(0.0f);
    for (int k = top_index(lane, NV); k >= 0; k -= WARP) {
      if (k < 6) {
        const float mx = ldc(c + (k < 3 ? C_BASE_MAX_ANG : C_BASE_MAX_LIN));
        const T v = sh.u[k] + dt * dy.udot[k];
        sh.u[k] = mx > 0.0f ? clip_(v, T(-mx), T(mx)) : v;
        continue;
      }
      const int d = k - 6;
      const float* dc = c + DOF_OFF + d * DOF_STRIDE;
      T v = sh.u[k] + dt * dy.udot[k];
      const float mv = ldc(dc + D_MAXVEL);
      if (mv > 0.0f) v = clip_(v, T(-mv), T(mv));
      T p = sh.q[d] + dt * v;
      const T lo = T(ldc(dc + D_LO)), hi = T(ldc(dc + D_HI));
      const bool at_lo = p < lo, at_hi = p > hi;
      p = clip_(p, lo, hi);
      if (at_lo) v = max_(v, zero);
      if (at_hi) v = min_(v, zero);
      sh.q[d] = p;
      sh.u[k] = v;
      IGT_OUT(d, p);
    }
  });
  one(w, [=, &sh]() {
    const T dt = T(ldc(c + C_DT));
    const V3<T> bp = sh.bp;
    const Q4<T> bq = sh.bq;
    const V3<T> bp2 = v3<T>(bp.x + sh.u[3] * dt, bp.y + sh.u[4] * dt, bp.z + sh.u[5] * dt);
    Q4<T> wq;
    wq.x = sh.u[0]; wq.y = sh.u[1]; wq.z = sh.u[2]; wq.w = T(0.0f);
    const Q4<T> dq = qmul(wq, bq);
    const T hdt = T(0.5f * ldc(c + C_DT));
    Q4<T> bq2;
    bq2.x = bq.x + hdt * dq.x; bq2.y = bq.y + hdt * dq.y;
    bq2.z = bq.z + hdt * dq.z; bq2.w = bq.w + hdt * dq.w;
    const T nq = sqrt_floor(bq2.x * bq2.x + bq2.y * bq2.y + bq2.z * bq2.z + bq2.w * bq2.w, 1e-12f);
    bq2.x = bq2.x / nq; bq2.y = bq2.y / nq; bq2.z = bq2.z / nq; bq2.w = bq2.w / nq;
    sh.bp = bp2;
    sh.bq = bq2;
    IGT_OUT(3 * ND, bp2.x); IGT_OUT(3 * ND + 1, bp2.y); IGT_OUT(3 * ND + 2, bp2.z);
    IGT_OUT(3 * ND + 3, bq2.x); IGT_OUT(3 * ND + 4, bq2.y);
    IGT_OUT(3 * ND + 5, bq2.z); IGT_OUT(3 * ND + 6, bq2.w);
  });
  fk_levels<T, ND>(c, sh, w, false);
#undef IGT_IN
#undef IGT_OUT
}

// ---------------------------------------------------------------- contacts --
// The Jacobian columns over u of world point p on ``link`` (-1: the base),
// and each column times u_k: the base's six on lane 0 (with r = p - bp),
// DOF i's on lane i mod 32.
template <class T, int ND, class Sh>
IGT_HD void point_cols(const float* c, Sh& sh, const Lanes& w, V3<T> p, int link) {
  auto& ct = sh.s.ct;
  each(w, [=, &sh, &ct](int lane) {
    const T z = T(0.0f), o = T(1.0f);
    if (lane == 0) {
      const V3<T> r = sub(p, sh.bp);
      ct.cols[0] = v3<T>(z, -r.z, r.y);
      ct.cols[1] = v3<T>(r.z, z, -r.x);
      ct.cols[2] = v3<T>(-r.y, r.x, z);
      ct.cols[3] = v3<T>(o, z, z);
      ct.cols[4] = v3<T>(z, o, z);
      ct.cols[5] = v3<T>(z, z, o);
      for (int k = 0; k < 6; ++k) ct.cu[k] = scale(ct.cols[k], sh.u[k]);
    }
    const float* mask = c + mask_off(ND);
    for (int i = lane; i < ND; i += WARP) {
      V3<T> col;
      if (link < 0 || ldc(mask + link * ND + i) == 0.0f) {
        col = v3<T>(z, z, z);
      } else if (ldc(c + DOF_OFF + i * DOF_STRIDE + D_REV) != 0.0f) {
        col = cross(sh.axw[i], sub(p, sh.fp[i]));
      } else {
        col = sh.axw[i];
      }
      ct.cols[6 + i] = col;
      ct.cu[6 + i] = scale(col, sh.u[6 + i]);
    }
  });
}

// sum_k cols[k] u[k] from the products, ascending k: the point's velocity
template <class T, int NV>
IGT_HD V3<T> sum_cols(const V3<T>* cu) {
  V3<T> v = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  for (int k = 0; k < NV; ++k) v = add(v, cu[k]);
  return v;
}

// yn = L^-1 J^T n and yt = L^-1 J^T t_hat (ct.n, ct.t_hat), with squares
template <class T, int ND, class Sh>
IGT_HD void solve_dirs(Sh& sh, const Lanes& w) {
  constexpr int NV = ND + 6;
  auto& ct = sh.s.ct;
  fwd_cols<T, NV, true, true>(w, sh.L, ct.bn, ct.yn, ct.sqn, ct.bt, ct.yt, ct.sqt,
                              [=, &ct](int lane) {
    const V3<T> n = ct.n, t = ct.t_hat;
    for (int k = top_index(lane, NV); k >= 0; k -= WARP) {
      ct.bn[k] = dot(ct.cols[k], n);
      ct.bt[k] = dot(ct.cols[k], t);
    }
  });
}

// u += L^-T (yn an + yt at)
template <class T, int ND, class Sh>
IGT_HD void apply_impulse(Sh& sh, const Lanes& w) {
  constexpr int NV = ND + 6;
  auto& ct = sh.s.ct;
  back_cols<T, NV>(w, sh.L, ct.bn, ct.bt, sh.u, [=, &ct](int lane) {
    const T an = ct.an, at = ct.at;
    for (int k = top_index(lane, NV); k >= 0; k -= WARP) ct.bn[k] = ct.yn[k] * an + ct.yt[k] * at;
  });
}

// The ball against articulated geom entry gi: swept CCD along the relative
// motion, gated restitution, spin friction, the reaction through the factor
// into the whole generalized velocity. With WITH_TORQUE the contact's
// moments are added: about the ball's centre (lever -r n_now) to tqb, and
// about the geom body's frame origin (lever to the contact point) to
// geom_tq[gi]. The impulse joins imp, its reaction geom_imp[gi].
template <class T, int ND, bool WITH_TORQUE, class Sh>
IGT_HD void ball_art_floating(const float* c, int gi, Sh& sh, const Lanes& w) {
  constexpr int NV = ND + 6;
  auto& ct = sh.s.ct;
  const float* g = c + fl_art_off(ND) + gi * ART_STRIDE;
  one(w, [=, &sh, &ct]() {
    const T rb = T(ldc(c + C_RB));
    const Q4<T> gqi = conj(ct.gq[gi]);
    const V3<T> c0 = qrot(gqi, sub(ct.pos, ct.gp[gi]));
    T d_now;
    V3<T> n_now_l;
    sphere_geom((int)ldc(g + A_KIND), g + A_SIZE, c0, rb, d_now, n_now_l);
    const V3<T> n_now = qrot(ct.gq[gi], n_now_l);
    ct.c0 = c0;
    ct.d_now = d_now;
    ct.n_now_l = n_now_l;
    ct.n_now = n_now;
    ct.pt = sub(ct.pos, scale(n_now, rb));
  });
  point_cols<T, ND>(c, sh, w, ct.pt, (int)ldc(g + A_LINK));
  one(w, [=, &sh, &ct]() {
    const T rb = T(ldc(c + C_RB));
    const Q4<T> gq = ct.gq[gi];
    const V3<T> v_rel = sub(ct.vel, sum_cols<T, NV>(ct.cu));
    const V3<T> dv_l = qrot(conj(gq), scale(v_rel, T(ldc(c + C_DT_QUARTER))));
    T dist = ct.d_now;
    V3<T> n_l = ct.n_now_l;
    sweep((int)ldc(g + A_KIND), g + A_SIZE, rb, ct.c0, dv_l, 4, dist, n_l);
    const V3<T> n = qrot(gq, n_l);
    const T vn = dot(v_rel, n);
    ct.act = (dist < T(0.0f)) && (vn < T(0.0f));
    if (!ct.act) return;   // inactive: no impulse
    ct.e_eff = sel(abs_(vn) > T(ldc(c + C_BOUNCE)), T(ldc(g + A_E)), T(0.0f));
    const V3<T> slip = ldc(c + C_KAPPA) > 0.0f ? sub(v_rel, scale(cross(ct.omg, n), rb)) : v_rel;
    const V3<T> vt = sub(slip, scale(n, dot(slip, n)));
    ct.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
    ct.t_hat = scale(vt, T(1.0f) / ct.vt_n);
    ct.n = n;
    ct.vn = vn;
  });
  if (!ct.act) return;
  solve_dirs<T, ND>(sh, w);
  one(w, [=, &sh, &ct]() {
    const T rb = T(ldc(c + C_RB)), inv_mb = T(ldc(c + C_INV_MB));
    const T Pn = -(T(1.0f) + ct.e_eff) * ct.vn / (inv_mb + sum_sq<T, NV>(ct.sqn));
    const T w_t = T(ldc(c + C_WT0)) + sum_sq<T, NV>(ct.sqt);
    const T Pt = min_(T(ldc(g + A_MU)) * Pn, ct.vt_n / w_t);
    const V3<T> n = ct.n, t_hat = ct.t_hat;
    const V3<T> P = sub(scale(n, Pn), scale(t_hat, Pt));
    ct.vel = add(ct.vel, scale(P, inv_mb));
    ct.omg = add(ct.omg, scale(cross(n, t_hat), T(ldc(c + C_KAPPA_INVMB_OVER_RB)) * Pt));
    ct.an = -Pn;
    ct.at = Pt;
    ct.pos = add(ct.pos, scale(n, max_(-ct.d_now, T(0.0f))));
    if constexpr (WITH_TORQUE) {
      ct.tqb = add(ct.tqb, scale(cross(ct.n_now, P), -rb));
      ct.geom_tq[gi] = add(ct.geom_tq[gi],
                           cross(sub(ct.pt, body_origin<T>(sh, g)), scale(P, T(-1.0f))));
    }
    ct.imp = add(ct.imp, P);
    ct.geom_imp[gi] = v3<T>(-P.x, -P.y, -P.z);
  });
  apply_impulse<T, ND>(sh, w);
}

// A Baumgarte impulse at ``point`` of ``link`` along ``n`` at penetration
// ``dist`` (art-vs-static and art-vs-ground), with K2's 2 mm resting band.
// If it acts, lane 0 calls ``record(P)`` with the impulse on the geom's body.
template <class T, int ND, class Sh, class R>
IGT_HD void baumgarte_floating(const float* c, Sh& sh, const Lanes& w, int link, V3<T> point,
                               V3<T> n, T dist, T e, T mu, R record) {
  constexpr int NV = ND + 6;
  auto& ct = sh.s.ct;
  if (!(dist < T(0.0f))) return;
  point_cols<T, ND>(c, sh, w, point, link);
  one(w, [=, &ct]() {
    const V3<T> v_point = sum_cols<T, NV>(ct.cu);
    const T vn = dot(v_point, n);
    ct.act = vn < T(0.1f);
    if (!ct.act) return;   // inactive: no impulse
    const T bounce = T(ldc(c + C_BOUNCE));
    ct.bias = min_(T(ldc(c + C_BIAS_K)) * max_(-dist - T(0.005f), T(0.0f)),
                   T(ldc(c + C_MAX_DEPEN)));
    ct.e_eff = sel(abs_(vn) > bounce, e, T(0.0f));
    const V3<T> vt = sub(v_point, scale(n, vn));
    ct.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
    ct.t_hat = scale(vt, T(1.0f) / ct.vt_n);
    ct.n = n;
    ct.vn = vn;
  });
  if (!ct.act) return;
  solve_dirs<T, ND>(sh, w);
  one(w, [=, &ct]() {
    const T bounce = T(ldc(c + C_BOUNCE));
    T Pn = (-(T(1.0f) + ct.e_eff) * min_(ct.vn, T(0.0f)) + ct.bias)
        / max_(sum_sq<T, NV>(ct.sqn), T(1e-9f));
    T Pt = min_(mu * Pn, ct.vt_n / max_(sum_sq<T, NV>(ct.sqt), T(1e-9f)));
    // resting-contact band: ramp the impulse over the first 2 mm
    const T s_r = sel(abs_(ct.vn) > bounce, T(1.0f), clip_(-dist / T(0.002f), T(0.0f), T(1.0f)));
    Pn = Pn * s_r;
    Pt = Pt * s_r;
    ct.an = Pn;
    ct.at = -Pt;
    record(sub(scale(n, Pn), scale(ct.t_hat, Pt)));
  });
  apply_impulse<T, ND>(sh, w);
}

// Articulated geom entry g against true static sg, pair entry pr: the
// bounding sphere's narrowphase (exact support of a cylinder or box along
// the normal where the pair says so): the contact point, normal and depth.
template <class T, class Sh>
IGT_HD void pair_narrowphase(const float* pr, const float* g, const float* sg, const Sh& sh,
                             V3<T>& point, V3<T>& n, T& dist) {
  const T rbound = T(ldc(g + A_RBOUND));
  V3<T> center;
  Q4<T> gq;
  geom_pose<T>(sh, g, center, gq);
  const float* R = sg + G_ROT;
  const V3<T> c_local = mat_t(R, sub(center, cv3<T>(sg + G_POS)));
  V3<T> n_local;
  sphere_geom((int)ldc(sg + G_KIND), sg + G_SIZE, c_local, rbound, dist, n_local);
  n = mat(R, n_local);
  if (ldc(pr + P_EXACT) != 0.0f) {
    const V3<T> n_g = qrot(conj(gq), n);
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

// ------------------------------------------------------------- the body --
// One env's K4 substep, run by the warp ``w`` with the env's block ``sh``.
// x: (fl_n_in(ND), B) inputs, y: (fl_n_out(ND, ng, WITH_TORQUE), B)
// outputs, both channel-major; env b reads and writes column b.
template <class T, int ND, bool WITH_TORQUE = false>
IGT_HD void fused_substep_floating_env(const float* __restrict__ c, const float* __restrict__ x,
                                       float* __restrict__ y, int b, int B,
                                       FloatShared<T, ND, WITH_TORQUE>& sh, const Lanes& w) {
  const size_t sB = (size_t)B;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  floating_dynamics<T, ND>(c, x, y, b, sB, sh, w);
  auto& ct = sh.s.ct;
  const int n_art = (int)ldc(c + C_NART);
  const int n_pair = (int)ldc(c + C_NPAIR);

  // the ball's flight, plane and statics (the last lane); each articulated
  // geom's pose and ground test (one lane each); the narrowphase of the
  // first WARP pairs (one lane each); all read only the post-step frames
  auto pairs = [=, &sh, &ct](int lane, int p0) {
    const int pi = p0 + lane;
    if (pi >= n_pair) return;
    const float* pr = c + fl_pair_off(ND) + pi * PAIR_STRIDE;
    pair_narrowphase<T>(pr, c + fl_art_off(ND) + (int)ldc(pr + P_ART) * ART_STRIDE,
                        c + fl_static_off(ND) + (int)ldc(pr + P_STATIC) * STATIC_STRIDE, sh,
                        ct.pr_pt[lane], ct.pr_n[lane], ct.pr_dist[lane]);
  };
  each(w, [=, &sh, &ct](int lane) {
    if (lane == WARP - 1) {
      const int ib = 4 * ND + 13;
      V3<T> pos = v3<T>(IGT_IN(ib), IGT_IN(ib + 1), IGT_IN(ib + 2));
      V3<T> vel = v3<T>(IGT_IN(ib + 3), IGT_IN(ib + 4), IGT_IN(ib + 5));
      V3<T> omg = v3<T>(IGT_IN(ib + 6), IGT_IN(ib + 7), IGT_IN(ib + 8));
      const T inv_mb = T(ldc(c + C_INV_MB));
      ball_flight(c, T(ldc(c + C_GX)), T(ldc(c + C_GY)), T(ldc(c + C_GZ)), vel, omg);
      const V3<T> dv0 = ball_plane(c, pos, vel, omg);
      V3<T> imp = scale(dv0, T(ldc(c + C_MB)));
      V3<T> tqb;
      if constexpr (WITH_TORQUE) tqb = static_moment(c, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);
      const int n_static = (int)ldc(c + C_NSTATIC);
      for (int si = 0; si < n_static; ++si) {
        const float* g = c + fl_static_off(ND) + si * STATIC_STRIDE;
        V3<T> dv = ball_static(c, g, T(ldc(g + G_E)), T(ldc(g + G_MU)), pos, vel, omg,
                               WITH_TORQUE ? &tqb : nullptr);
        imp = v3<T>(imp.x + dv.x / inv_mb, imp.y + dv.y / inv_mb, imp.z + dv.z / inv_mb);
      }
      ct.pos = pos;
      ct.vel = vel;
      ct.omg = omg;
      ct.imp = imp;
      if constexpr (WITH_TORQUE) ct.tqb = tqb;
    }
    for (int gi = lane; gi < n_art; gi += WARP) {
      const float* g = c + fl_art_off(ND) + gi * ART_STRIDE;
      geom_pose<T>(sh, g, ct.gp[gi], ct.gq[gi]);
      V3<T> center;
      Q4<T> gq;
      geom_pose<T>(sh, g, center, gq);
      const T radius = T(ldc(g + A_RBOUND));
      ct.gnd_pt[gi] = v3<T>(center.x, center.y, center.z - radius);
      ct.gnd_dist[gi] = center.z - radius;
      ct.geom_imp[gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
      if constexpr (WITH_TORQUE) ct.geom_tq[gi] = ct.geom_imp[gi];
    }
    pairs(lane, 0);
  });

  // articulated geoms: ball contacts with whole-body reactions
  for (int gi = 0; gi < n_art; ++gi) ball_art_floating<T, ND, WITH_TORQUE>(c, gi, sh, w);

  // articulated geoms vs the true statics (table slab, net), every pair
  for (int p0 = 0; p0 < n_pair; p0 += WARP) {
    if (p0 > 0) {
      sync(w);   // every lane has read the last chunk's last pair
      each(w, [=](int lane) { pairs(lane, p0); });
    }
    for (int pi = p0; pi < n_pair && pi < p0 + WARP; ++pi) {
      const float* pr = c + fl_pair_off(ND) + pi * PAIR_STRIDE;
      const int gi = (int)ldc(pr + P_ART);
      const float* g = c + fl_art_off(ND) + gi * ART_STRIDE;
      const V3<T> point = ct.pr_pt[pi - p0];
      baumgarte_floating<T, ND>(c, sh, w, (int)ldc(g + A_LINK), point, ct.pr_n[pi - p0],
                                ct.pr_dist[pi - p0], T(ldc(pr + P_E)), T(ldc(pr + P_MU)),
                                [=, &sh, &ct](V3<T> P) {
        ct.geom_imp[gi] = add(ct.geom_imp[gi], P);
        if constexpr (WITH_TORQUE)
          ct.geom_tq[gi] = add(ct.geom_tq[gi], cross(sub(point, body_origin<T>(sh, g)), P));
      });
    }
  }

  // articulated geoms' bounding spheres vs the ground (unrecorded, as on
  // the JAX package's paths)
  const T e_gnd = T(ldc(c + C_E_GND)), mu_gnd = T(ldc(c + C_MU_GND));
  const V3<T> up = v3<T>(T(0.0f), T(0.0f), T(1.0f));
  for (int gi = 0; gi < n_art; ++gi)
    baumgarte_floating<T, ND>(c, sh, w, (int)ldc(c + fl_art_off(ND) + gi * ART_STRIDE + A_LINK),
                              ct.gnd_pt[gi], up, ct.gnd_dist[gi], e_gnd, mu_gnd, [](V3<T>) {});

  // outputs: qd and the base's velocities, impulse rows (and moment rows),
  // the capped ball
  each(w, [=, &sh, &ct](int lane) {
    const int ob = 3 * ND, io = 3 * ND + 22, it = io + 3 * (n_art + 1);
    for (int k = lane; k < ND + 6; k += WARP) {   // u = [omega, v, qdot]
      const int ch = k >= 6 ? ND + k - 6 : k >= 3 ? ob + 7 + k - 3 : ob + 10 + k;
      IGT_OUT(ch, sh.u[k]);
    }
    for (int gi = lane; gi <= n_art; gi += WARP) {
      const V3<T> p = gi < n_art ? ct.geom_imp[gi] : ct.imp;
      IGT_OUT(io + 3 * gi, p.x); IGT_OUT(io + 3 * gi + 1, p.y); IGT_OUT(io + 3 * gi + 2, p.z);
      if constexpr (WITH_TORQUE) {
        const V3<T> tq = gi < n_art ? ct.geom_tq[gi] : ct.tqb;
        IGT_OUT(it + 3 * gi, tq.x); IGT_OUT(it + 3 * gi + 1, tq.y); IGT_OUT(it + 3 * gi + 2, tq.z);
      }
    }
    if (lane == WARP - 1) {
      V3<T> pos = ct.pos, vel = ct.vel, omg = ct.omg;
      ball_finish(c, pos, vel, omg);
      IGT_OUT(ob + 13, pos.x); IGT_OUT(ob + 14, pos.y); IGT_OUT(ob + 15, pos.z);
      IGT_OUT(ob + 16, vel.x); IGT_OUT(ob + 17, vel.y); IGT_OUT(ob + 18, vel.z);
      IGT_OUT(ob + 19, omg.x); IGT_OUT(ob + 20, omg.y); IGT_OUT(ob + 21, omg.z);
    }
  });
#undef IGT_IN
#undef IGT_OUT
}

}  // namespace igt
