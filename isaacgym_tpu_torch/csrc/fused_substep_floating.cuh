// K4, the fused physics substep of one floating-base humanoid with one ball
// (the 27-DOF whole-body C10 scene), and its torque-lane build K4-tau: the
// per-env body.
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
// accumulators add 3 FL_MAX_ART floats to the thread's local memory.
//
// The same header is compiled two ways, as K2's: inside the __global__
// wrapper of fused_substep_floating.cu (one thread per env, nvcc, sm_90a)
// and inside the host loop of fused_substep_host.cpp (g++), which the CPU
// tests hold against the plain PyTorch version and which counts the
// operations this data needs. Scene constants are read at run time from
// one float32 buffer (layout below, mirrored by
// isaacgym_tpu_torch/ops/fused_substep_floating.py); only the DOF count ND
// is a compile-time parameter.
//
// Design for the first port (a simple kernel that is right): one thread per
// env; the packed lower triangle of M (NV (NV + 1) / 2 = 561 floats at ND
// 27), the per-DOF frames and the per-link Jacobian columns live in the
// thread's local memory, and every loop over DOFs, links and matrix rows is
// a runtime loop (#pragma unroll 1), so ptxas compiles one copy of each
// phase instead of a constant-folded body of tens of thousands of
// statements. A contact that is not active returns before its solves, as
// K2's do. Only the active columns of each link (the six base columns and
// its ancestors, about 13 of 33 for the G1) enter the mass matrix.
//
// What bounds it on an H100: latency. One thread per env does about 10^5
// dependent FP32 operations (mostly the mass matrix, the Cholesky and the
// contact solves) and reads and writes 263 floats; at 2048 envs that is 64
// blocks of one warp on 132 SMs, and the threads' local memory (ptxas: a
// 6,464-byte stack each, 13 MB at 2048 envs) fits in the 50 MB L2. Making
// it fast (a warp per env with the matrix in shared memory, more envs per
// SM) is work for a later PR.
#pragma once

#include "fused_substep.cuh"

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

// --------------------------------------------------- runtime-loop solves --
template <class T>
IGT_HD void fwd_sub_rt(const T* L, const T* b, T* y, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const T* Li = L + i * (i + 1) / 2;
    T s = b[i];
#pragma unroll 1
    for (int j = 0; j < i; ++j) s = s - Li[j] * y[j];
    y[i] = s / Li[i];
  }
}

// row i subtracts over j descending, the order of the plain version's
// column-oriented solve
template <class T>
IGT_HD void back_sub_rt(const T* L, const T* y, T* x, int n) {
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll 1
    for (int j = n - 1; j > i; --j) s = s - L[j * (j + 1) / 2 + i] * x[j];
    x[i] = s / L[i * (i + 1) / 2 + i];
  }
}

// FK of every DOF frame from a runtime base pose.
template <class T, int ND>
IGT_HD void fk_floating(const float* c, const T* q, V3<T> bp, Q4<T> bq, V3<T>* fp, Q4<T>* fq,
                        V3<T>* axw) {
#pragma unroll 1
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    const int par = (int)ldc(dc + D_PARENT);
    const V3<T> pp = par < 0 ? bp : fp[par];
    const Q4<T> pq = par < 0 ? bq : fq[par];
    V3<T> jp = add(pp, qrot(pq, cv3<T>(dc + D_PRE_POS)));
    Q4<T> jq = qmul(pq, cq4<T>(dc + D_PRE_QUAT));
    V3<T> ax = cv3<T>(dc + D_AXIS);
    if (ldc(dc + D_REV) != 0.0f) {
      T half = T(0.5f) * q[d];
      T s = sin_(half), co = cos_(half);
      Q4<T> r; r.x = ax.x * s; r.y = ax.y * s; r.z = ax.z * s; r.w = co;
      fq[d] = qmul(jq, r);
      fp[d] = jp;
    } else {
      fq[d] = jq;
      fp[d] = add(jp, scale(qrot(jq, ax), q[d]));
    }
    axw[d] = qrot(fq[d], ax);
  }
}

// The articulation after its dynamics: the packed factor, the generalized
// velocity the contacts change, and the post-step base pose and frames.
template <class T, int ND>
struct FloatArt {
  static constexpr int NV = ND + 6;
  T L[NV * (NV + 1) / 2];
  T u[NV];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
  V3<T> bp;
  Q4<T> bq;
};

// The world pose of articulated geom entry g (its link frame, or the base).
template <class T, int ND>
IGT_HD void geom_pose(const FloatArt<T, ND>& a, const float* g, V3<T>& gp, Q4<T>& gq) {
  const int link = (int)ldc(g + A_LINK);
  const V3<T> lp = link < 0 ? a.bp : a.fp[link];
  const Q4<T> lq = link < 0 ? a.bq : a.fq[link];
  gp = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
  gq = qmul(lq, cq4<T>(g + A_OFF_QUAT));
}

// The world position of entry g's body frame origin, the point its moments
// are taken about (borg_of, pallas_dynamics.py:2660-2664).
template <class T, int ND>
IGT_HD V3<T> body_origin(const FloatArt<T, ND>& a, const float* g) {
  const int link = (int)ldc(g + A_LINK);
  const V3<T> lp = link < 0 ? a.bp : a.fp[link];
  const Q4<T> lq = link < 0 ? a.bq : a.fq[link];
  return add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)));
}

// The NV Jacobian columns of world point p on ``link`` (-1: the base).
template <class T, int ND>
IGT_HD void point_cols(const float* c, const FloatArt<T, ND>& a, int link, V3<T> p,
                       V3<T>* cols) {
  const T z = T(0.0f), one = T(1.0f);
  const V3<T> r = sub(p, a.bp);
  cols[0] = v3<T>(z, -r.z, r.y);
  cols[1] = v3<T>(r.z, z, -r.x);
  cols[2] = v3<T>(-r.y, r.x, z);
  cols[3] = v3<T>(one, z, z);
  cols[4] = v3<T>(z, one, z);
  cols[5] = v3<T>(z, z, one);
  const float* mask = c + mask_off(ND);
#pragma unroll 1
  for (int i = 0; i < ND; ++i) {
    if (link < 0 || ldc(mask + link * ND + i) == 0.0f) {
      cols[6 + i] = v3<T>(z, z, z);
    } else if (ldc(c + DOF_OFF + i * DOF_STRIDE + D_REV) != 0.0f) {
      cols[6 + i] = cross(a.axw[i], sub(p, a.fp[i]));
    } else {
      cols[6 + i] = a.axw[i];
    }
  }
}

// sum_c cols[c] u[c]: the world velocity of the point
template <class T, int NV>
IGT_HD V3<T> cols_dot_u(const V3<T>* cols, const T* u) {
  V3<T> v = v3<T>(T(0.0f), T(0.0f), T(0.0f));
#pragma unroll 1
  for (int k = 0; k < NV; ++k) v = add(v, scale(cols[k], u[k]));
  return v;
}

// y = L^-1 J^T n
template <class T, int NV>
IGT_HD void solve_dir(const T* L, const V3<T>* cols, V3<T> n, T* jv, T* y) {
#pragma unroll 1
  for (int k = 0; k < NV; ++k) jv[k] = dot(cols[k], n);
  fwd_sub_rt<T>(L, jv, y, NV);
}

template <class T, int NV>
IGT_HD T sum_sq(const T* y) {
  T s = T(0.0f);
#pragma unroll 1
  for (int k = 0; k < NV; ++k) s = s + y[k] * y[k];
  return s;
}

// u += L^-T (yn an + yt at)
template <class T, int NV>
IGT_HD void apply_impulse(const T* L, const T* yn, T an, const T* yt, T at, T* jv, T* du,
                          T* u) {
#pragma unroll 1
  for (int k = 0; k < NV; ++k) jv[k] = yn[k] * an + yt[k] * at;
  back_sub_rt<T>(L, jv, du, NV);
#pragma unroll 1
  for (int k = 0; k < NV; ++k) u[k] = u[k] + du[k];
}

// --------------------------------------------------------------- dynamics --
// Drive -> FK -> bias and mass matrix over [omega, v, qdot] -> Cholesky ->
// Euler with the clamps, limits and base integration -> FK at the new pose.
// Writes q and tau (rows 0 .. and 2 ND ..) and the base pose (3 ND ..).
template <class T, int ND>
IGT_HD void floating_dynamics(const float* __restrict__ c, const float* __restrict__ x,
                              float* __restrict__ y, int b, size_t sB, FloatArt<T, ND>& a) {
  constexpr int NV = ND + 6;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  const T dt = T(ldc(c + C_DT));
  const T zero = T(0.0f);
  const V3<T> zero3 = v3<T>(zero, zero, zero);
  const bool effort_drive = ldc(c + C_DRIVE) != 0.0f;
  const int ib = 4 * ND;
  const V3<T> bp = v3<T>(IGT_IN(ib), IGT_IN(ib + 1), IGT_IN(ib + 2));
  Q4<T> bq;
  bq.x = IGT_IN(ib + 3); bq.y = IGT_IN(ib + 4); bq.z = IGT_IN(ib + 5); bq.w = IGT_IN(ib + 6);
  const V3<T> v_base = v3<T>(IGT_IN(ib + 7), IGT_IN(ib + 8), IGT_IN(ib + 9));
  const V3<T> w_base = v3<T>(IGT_IN(ib + 10), IGT_IN(ib + 11), IGT_IN(ib + 12));

  T q[ND], qd[ND], rhs[NV];
#pragma unroll 1
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    q[d] = IGT_IN(d);
    qd[d] = IGT_IN(ND + d);
    T t = effort_drive ? IGT_IN(3 * ND + d)
        : T(ldc(dc + D_KP)) * (IGT_IN(2 * ND + d) - q[d]) - T(ldc(dc + D_KD)) * qd[d]
              + IGT_IN(3 * ND + d);
    const T eff = T(ldc(dc + D_EFFORT));
    t = clip_(t, -eff, eff);
    rhs[6 + d] = t;
    IGT_OUT(2 * ND + d, t);
  }
#pragma unroll 1
  for (int k = 0; k < 6; ++k) rhs[k] = zero;

  V3<T>* fp = a.fp;
  Q4<T>* fq = a.fq;
  V3<T>* axw = a.axw;
  fk_floating<T, ND>(c, q, bp, bq, fp, fq, axw);

  // velocity / bias propagation (u-dot = 0) from the base (omega, 0, 0)
  V3<T> w[ND], wd[ND], ao[ND];
#pragma unroll 1
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    const int par = (int)ldc(dc + D_PARENT);
    const V3<T> w_p = par < 0 ? w_base : w[par];
    const V3<T> wd_p = par < 0 ? zero3 : wd[par];
    const V3<T> ao_p = par < 0 ? zero3 : ao[par];
    const V3<T> o_p = par < 0 ? bp : fp[par];
    V3<T> r = sub(fp[d], o_p);
    V3<T> ao_d = add(ao_p, add(cross(wd_p, r), cross(w_p, cross(w_p, r))));
    if (ldc(dc + D_REV) != 0.0f) {
      w[d] = add(w_p, scale(axw[d], qd[d]));
      wd[d] = add(wd_p, scale(cross(w_p, axw[d]), qd[d]));
    } else {
      w[d] = w_p;
      wd[d] = wd_p;
      ao_d = add(ao_d, scale(cross(w_p, axw[d]), T(2.0f) * qd[d]));
    }
    ao[d] = ao_d;
  }

  // per link (DOF links, then the base composite at ND): world COM and
  // inertia, wrench, the active Jacobian columns; the bias and the mass
  // matrix accumulate link by link (ascending l per entry)
  T* M = a.L;   // factored in place below
  T acc[NV];
#pragma unroll 1
  for (int i = 0; i < NV * (NV + 1) / 2; ++i) M[i] = zero;
#pragma unroll 1
  for (int i = 0; i < NV; ++i) acc[i] = zero;
  const V3<T> g = v3<T>(T(ldc(c + C_GX)), T(ldc(c + C_GY)), T(ldc(c + C_GZ)));
  const float* mask = c + mask_off(ND);
  int idx[NV];
  V3<T> Ja[NV], Jl[NV], IJa[NV];
#pragma unroll 1
  for (int l = 0; l <= ND; ++l) {
    const bool is_base = l == ND;
    const float* lc = is_base ? c + fl_base_off(ND) : c + DOF_OFF + l * DOF_STRIDE;
    const float* lcom = is_base ? lc + B_COM : lc + D_COM;
    const float* I = is_base ? lc + B_INERTIA : lc + D_INERTIA;
    const T m = T(ldc(is_base ? lc + B_MASS : lc + D_MASS));
    const V3<T> org = is_base ? bp : fp[l];
    const Q4<T> qq = is_base ? bq : fq[l];
    const V3<T> wl = is_base ? w_base : w[l];
    const V3<T> wdl = is_base ? zero3 : wd[l];
    const V3<T> aol = is_base ? zero3 : ao[l];
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
    V3<T> f = scale(sub(a_com, g), m);
    V3<T> Iwd = v3<T>(Iw[0][0] * wdl.x + Iw[0][1] * wdl.y + Iw[0][2] * wdl.z,
                      Iw[1][0] * wdl.x + Iw[1][1] * wdl.y + Iw[1][2] * wdl.z,
                      Iw[2][0] * wdl.x + Iw[2][1] * wdl.y + Iw[2][2] * wdl.z);
    V3<T> Iww = v3<T>(Iw[0][0] * wl.x + Iw[0][1] * wl.y + Iw[0][2] * wl.z,
                      Iw[1][0] * wl.x + Iw[1][1] * wl.y + Iw[1][2] * wl.z,
                      Iw[2][0] * wl.x + Iw[2][1] * wl.y + Iw[2][2] * wl.z);
    V3<T> nn = add(Iwd, cross(wl, Iww));

    // active columns: the base's six, then the link's ancestors
    const V3<T> rb = sub(com, bp);
    int na = 0;
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      V3<T> e = v3<T>(T(k == 0 ? 1.0f : 0.0f), T(k == 1 ? 1.0f : 0.0f), T(k == 2 ? 1.0f : 0.0f));
      idx[na] = k; Ja[na] = e; Jl[na] = cross(e, rb); ++na;
    }
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      V3<T> e = v3<T>(T(k == 0 ? 1.0f : 0.0f), T(k == 1 ? 1.0f : 0.0f), T(k == 2 ? 1.0f : 0.0f));
      idx[na] = 3 + k; Ja[na] = zero3; Jl[na] = e; ++na;
    }
    if (!is_base) {
#pragma unroll 1
      for (int d = 0; d < ND; ++d) {
        if (ldc(mask + l * ND + d) == 0.0f) continue;
        idx[na] = 6 + d;
        if (ldc(c + DOF_OFF + d * DOF_STRIDE + D_REV) != 0.0f) {
          Ja[na] = axw[d];
          Jl[na] = cross(axw[d], sub(com, fp[d]));
        } else {
          Ja[na] = zero3;
          Jl[na] = axw[d];
        }
        ++na;
      }
    }
#pragma unroll 1
    for (int k = 0; k < na; ++k) {
      acc[idx[k]] = acc[idx[k]] + (dot(Ja[k], nn) + dot(Jl[k], f));
      const V3<T> v = Ja[k];
      IJa[k] = v3<T>(Iw[0][0] * v.x + Iw[0][1] * v.y + Iw[0][2] * v.z,
                     Iw[1][0] * v.x + Iw[1][1] * v.y + Iw[1][2] * v.z,
                     Iw[2][0] * v.x + Iw[2][1] * v.y + Iw[2][2] * v.z);
    }
#pragma unroll 1
    for (int k1 = 0; k1 < na; ++k1) {
      T* Mrow = M + idx[k1] * (idx[k1] + 1) / 2;
#pragma unroll 1
      for (int k2 = 0; k2 <= k1; ++k2)
        Mrow[idx[k2]] = Mrow[idx[k2]] + (dot(Ja[k1], IJa[k2]) + m * dot(Jl[k1], Jl[k2]));
    }
  }

  // rhs = tau_gen - bias; armature on the DOF diagonal; Cholesky in place
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    rhs[i] = rhs[i] - acc[i];
    if (i >= 6)
      M[i * (i + 1) / 2 + i] = M[i * (i + 1) / 2 + i]
          + T(ldc(c + DOF_OFF + (i - 6) * DOF_STRIDE + D_ARMATURE));
  }
  T* L = a.L;
#pragma unroll 1
  for (int j = 0; j < NV; ++j) {
    T* Lj = L + j * (j + 1) / 2;
    T s = Lj[j];
#pragma unroll 1
    for (int k = 0; k < j; ++k) s = s - Lj[k] * Lj[k];
    T dia = sqrt_floor(s, 1e-12f);
    Lj[j] = dia;
    T inv_d = T(1.0f) / dia;
#pragma unroll 1
    for (int i = j + 1; i < NV; ++i) {
      T* Li = L + i * (i + 1) / 2;
      T s2 = Li[j];
#pragma unroll 1
      for (int k = 0; k < j; ++k) s2 = s2 - Li[k] * Lj[k];
      Li[j] = s2 * inv_d;
    }
  }
  T udot[NV];
  fwd_sub_rt<T>(L, rhs, acc, NV);
  back_sub_rt<T>(L, acc, udot, NV);

  // semi-implicit Euler: base velocity clamps, DOF clamp and limits
  T* u = a.u;
  const float ma = ldc(c + C_BASE_MAX_ANG), ml = ldc(c + C_BASE_MAX_LIN);
  const T wb[3] = {w_base.x, w_base.y, w_base.z};
  const T vb[3] = {v_base.x, v_base.y, v_base.z};
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    T uw = wb[k] + dt * udot[k];
    u[k] = ma > 0.0f ? clip_(uw, T(-ma), T(ma)) : uw;
    T uv = vb[k] + dt * udot[3 + k];
    u[3 + k] = ml > 0.0f ? clip_(uv, T(-ml), T(ml)) : uv;
  }
#pragma unroll 1
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    T v = qd[d] + dt * udot[6 + d];
    const float mv = ldc(dc + D_MAXVEL);
    if (mv > 0.0f) v = clip_(v, T(-mv), T(mv));
    T p = q[d] + dt * v;
    const T lo = T(ldc(dc + D_LO)), hi = T(ldc(dc + D_HI));
    const bool at_lo = p < lo, at_hi = p > hi;
    p = clip_(p, lo, hi);
    if (at_lo) v = max_(v, zero);
    if (at_hi) v = min_(v, zero);
    q[d] = p;
    u[6 + d] = v;
    IGT_OUT(d, p);
  }
  a.bp = v3<T>(bp.x + u[3] * dt, bp.y + u[4] * dt, bp.z + u[5] * dt);
  Q4<T> wq;
  wq.x = u[0]; wq.y = u[1]; wq.z = u[2]; wq.w = zero;
  const Q4<T> dq = qmul(wq, bq);
  const T hdt = T(0.5f * ldc(c + C_DT));
  Q4<T> bq2;
  bq2.x = bq.x + hdt * dq.x; bq2.y = bq.y + hdt * dq.y;
  bq2.z = bq.z + hdt * dq.z; bq2.w = bq.w + hdt * dq.w;
  const T nq = sqrt_floor(bq2.x * bq2.x + bq2.y * bq2.y + bq2.z * bq2.z + bq2.w * bq2.w, 1e-12f);
  bq2.x = bq2.x / nq; bq2.y = bq2.y / nq; bq2.z = bq2.z / nq; bq2.w = bq2.w / nq;
  a.bq = bq2;
  IGT_OUT(3 * ND, a.bp.x); IGT_OUT(3 * ND + 1, a.bp.y); IGT_OUT(3 * ND + 2, a.bp.z);
  IGT_OUT(3 * ND + 3, bq2.x); IGT_OUT(3 * ND + 4, bq2.y);
  IGT_OUT(3 * ND + 5, bq2.z); IGT_OUT(3 * ND + 6, bq2.w);
  fk_floating<T, ND>(c, q, a.bp, a.bq, fp, fq, axw);
#undef IGT_IN
#undef IGT_OUT
}

// ---------------------------------------------------------------- contacts --
// The ball against articulated geom entry g: swept CCD along the relative
// motion, gated restitution, spin friction, the reaction through the factor
// into the whole generalized velocity. Returns whether it acted; P is the
// impulse on the ball. With WITH_TORQUE the contact's moments are added:
// about the ball's centre (lever -r n_now) to ball_tq, and about the geom
// body's frame origin (lever to the contact point) to geom_tq.
template <class T, int ND, bool WITH_TORQUE = false>
IGT_HD bool ball_art_floating(const float* c, const float* g, FloatArt<T, ND>& a, V3<T>& pos,
                              V3<T>& vel, V3<T>& omg, V3<T>& P, V3<T>* ball_tq = nullptr,
                              V3<T>* geom_tq = nullptr) {
  constexpr int NV = ND + 6;
  const T rb = T(ldc(c + C_RB)), inv_mb = T(ldc(c + C_INV_MB));
  const int kind = (int)ldc(g + A_KIND);
  V3<T> gp;
  Q4<T> gq;
  geom_pose<T, ND>(a, g, gp, gq);
  const Q4<T> gqi = conj(gq);
  const V3<T> c0 = qrot(gqi, sub(pos, gp));
  T d_now;
  V3<T> n_now_l;
  sphere_geom(kind, g + A_SIZE, c0, rb, d_now, n_now_l);
  const V3<T> n_now = qrot(gq, n_now_l);
  const V3<T> cp = sub(pos, scale(n_now, rb));
  V3<T> cols[NV];
  point_cols<T, ND>(c, a, (int)ldc(g + A_LINK), cp, cols);
  const V3<T> v_rel = sub(vel, cols_dot_u<T, NV>(cols, a.u));
  const V3<T> dv_l = qrot(gqi, scale(v_rel, T(ldc(c + C_DT_QUARTER))));
  T dist = d_now;
  V3<T> n_l = n_now_l;
  sweep(kind, g + A_SIZE, rb, c0, dv_l, 4, dist, n_l);
  const V3<T> n = qrot(gq, n_l);
  const T vn = dot(v_rel, n);
  if (!((dist < T(0.0f)) && (vn < T(0.0f)))) return false;   // inactive: no impulse
  const T e_eff = sel(abs_(vn) > T(ldc(c + C_BOUNCE)), T(ldc(g + A_E)), T(0.0f));
  T jv[NV], yn[NV], yt[NV], du[NV];
  solve_dir<T, NV>(a.L, cols, n, jv, yn);
  const T Pn = -(T(1.0f) + e_eff) * vn / (inv_mb + sum_sq<T, NV>(yn));
  const V3<T> slip = ldc(c + C_KAPPA) > 0.0f ? sub(v_rel, scale(cross(omg, n), rb)) : v_rel;
  const V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  const T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  const V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
  solve_dir<T, NV>(a.L, cols, t_hat, jv, yt);
  const T w_t = T(ldc(c + C_WT0)) + sum_sq<T, NV>(yt);
  const T Pt = min_(T(ldc(g + A_MU)) * Pn, vt_n / w_t);
  P = sub(scale(n, Pn), scale(t_hat, Pt));
  vel = add(vel, scale(P, inv_mb));
  omg = add(omg, scale(cross(n, t_hat), T(ldc(c + C_KAPPA_INVMB_OVER_RB)) * Pt));
  apply_impulse<T, NV>(a.L, yn, -Pn, yt, Pt, jv, du, a.u);
  pos = add(pos, scale(n, max_(-d_now, T(0.0f))));
  if constexpr (WITH_TORQUE) {
    *ball_tq = add(*ball_tq, scale(cross(n_now, P), -rb));
    *geom_tq = add(*geom_tq, cross(sub(cp, body_origin<T, ND>(a, g)), scale(P, T(-1.0f))));
  }
  return true;
}

// A Baumgarte impulse at ``point`` of ``link`` along ``n`` at penetration
// ``dist`` (art-vs-static and art-vs-ground), with K2's 2 mm resting band.
// Returns whether it acted; P is the impulse on the geom's body.
template <class T, int ND>
IGT_HD bool baumgarte_floating(const float* c, FloatArt<T, ND>& a, int link, V3<T> point,
                               V3<T> n, T dist, T e, T mu, V3<T>& P) {
  constexpr int NV = ND + 6;
  if (!(dist < T(0.0f))) return false;
  V3<T> cols[NV];
  point_cols<T, ND>(c, a, link, point, cols);
  const V3<T> v_point = cols_dot_u<T, NV>(cols, a.u);
  const T vn = dot(v_point, n);
  if (!(vn < T(0.1f))) return false;   // inactive: no impulse
  const T bounce = T(ldc(c + C_BOUNCE));
  const T bias = min_(T(ldc(c + C_BIAS_K)) * max_(-dist - T(0.005f), T(0.0f)),
                      T(ldc(c + C_MAX_DEPEN)));
  const T e_eff = sel(abs_(vn) > bounce, e, T(0.0f));
  T jv[NV], yn[NV], yt[NV], du[NV];
  solve_dir<T, NV>(a.L, cols, n, jv, yn);
  T Pn = (-(T(1.0f) + e_eff) * min_(vn, T(0.0f)) + bias) / max_(sum_sq<T, NV>(yn), T(1e-9f));
  const V3<T> vt = sub(v_point, scale(n, vn));
  const T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  const V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
  solve_dir<T, NV>(a.L, cols, t_hat, jv, yt);
  T Pt = min_(mu * Pn, vt_n / max_(sum_sq<T, NV>(yt), T(1e-9f)));
  // resting-contact band: ramp the impulse over the first 2 mm
  const T s_r = sel(abs_(vn) > bounce, T(1.0f), clip_(-dist / T(0.002f), T(0.0f), T(1.0f)));
  Pn = Pn * s_r;
  Pt = Pt * s_r;
  apply_impulse<T, NV>(a.L, yn, Pn, yt, -Pt, jv, du, a.u);
  P = sub(scale(n, Pn), scale(t_hat, Pt));
  return true;
}

// Articulated geom entry g against true static sg, pair entry pr: the
// bounding sphere's narrowphase (exact support of a cylinder or box along
// the normal where the pair says so), then the Baumgarte impulse. With
// WITH_TORQUE the impulse's moment about the geom body's frame origin is
// added to geom_tq.
template <class T, int ND, bool WITH_TORQUE = false>
IGT_HD bool art_static_floating(const float* c, const float* pr, const float* g,
                                const float* sg, FloatArt<T, ND>& a, V3<T>& P,
                                V3<T>* geom_tq = nullptr) {
  const T rbound = T(ldc(g + A_RBOUND));
  V3<T> center;
  Q4<T> gq;
  geom_pose<T, ND>(a, g, center, gq);
  const float* R = sg + G_ROT;
  const V3<T> c_local = mat_t(R, sub(center, cv3<T>(sg + G_POS)));
  T dist;
  V3<T> n_local;
  sphere_geom((int)ldc(sg + G_KIND), sg + G_SIZE, c_local, rbound, dist, n_local);
  const V3<T> n = mat(R, n_local);
  V3<T> point;
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
  if (!baumgarte_floating<T, ND>(c, a, (int)ldc(g + A_LINK), point, n, dist, T(ldc(pr + P_E)),
                                 T(ldc(pr + P_MU)), P))
    return false;
  if constexpr (WITH_TORQUE)
    *geom_tq = add(*geom_tq, cross(sub(point, body_origin<T, ND>(a, g)), P));
  return true;
}

// ------------------------------------------------------------- the body --
// One env's K4 substep. x: (fl_n_in(ND), B) inputs, y: (fl_n_out(ND, ng,
// WITH_TORQUE), B) outputs, both channel-major; env b reads and writes
// column b.
template <class T, int ND, bool WITH_TORQUE = false>
IGT_HD void fused_substep_floating_env(const float* __restrict__ c, const float* __restrict__ x,
                                       float* __restrict__ y, int b, int B) {
  constexpr int NV = ND + 6;
  const size_t sB = (size_t)B;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  FloatArt<T, ND> a;
  floating_dynamics<T, ND>(c, x, y, b, sB, a);

  // ------------------------------------------------------------- ball --
  const int ib = 4 * ND + 13;
  V3<T> pos = v3<T>(IGT_IN(ib), IGT_IN(ib + 1), IGT_IN(ib + 2));
  V3<T> vel = v3<T>(IGT_IN(ib + 3), IGT_IN(ib + 4), IGT_IN(ib + 5));
  V3<T> omg = v3<T>(IGT_IN(ib + 6), IGT_IN(ib + 7), IGT_IN(ib + 8));
  const T inv_mb = T(ldc(c + C_INV_MB));
  ball_flight(c, T(ldc(c + C_GX)), T(ldc(c + C_GY)), T(ldc(c + C_GZ)), vel, omg);
  const V3<T> dv0 = ball_plane(c, pos, vel, omg);
  V3<T> imp = scale(dv0, T(ldc(c + C_MB)));
  // WITH_TORQUE: the ball's contact moment and each geom body's
  V3<T> tqb, geom_tq[WITH_TORQUE ? FL_MAX_ART : 1];
  if constexpr (WITH_TORQUE) tqb = static_moment(c, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);
  const int n_static = (int)ldc(c + C_NSTATIC);
#pragma unroll 1
  for (int si = 0; si < n_static; ++si) {
    const float* g = c + fl_static_off(ND) + si * STATIC_STRIDE;
    V3<T> dv = ball_static(c, g, T(ldc(g + G_E)), T(ldc(g + G_MU)), pos, vel, omg,
                           WITH_TORQUE ? &tqb : nullptr);
    imp = v3<T>(imp.x + dv.x / inv_mb, imp.y + dv.y / inv_mb, imp.z + dv.z / inv_mb);
  }

  // articulated geoms: ball contacts with whole-body reactions
  const int n_art = (int)ldc(c + C_NART);
  V3<T> geom_imp[FL_MAX_ART];
#pragma unroll 1
  for (int gi = 0; gi < n_art; ++gi) {
    V3<T> P;
    geom_imp[gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    if constexpr (WITH_TORQUE) geom_tq[gi] = geom_imp[gi];
    if (!ball_art_floating<T, ND, WITH_TORQUE>(c, c + fl_art_off(ND) + gi * ART_STRIDE, a, pos,
                                               vel, omg, P, WITH_TORQUE ? &tqb : nullptr,
                                               WITH_TORQUE ? &geom_tq[gi] : nullptr))
      continue;
    imp = add(imp, P);
    geom_imp[gi] = v3<T>(-P.x, -P.y, -P.z);
  }

  // articulated geoms vs the true statics (table slab, net), every pair
  const int n_pair = (int)ldc(c + C_NPAIR);
#pragma unroll 1
  for (int pi = 0; pi < n_pair; ++pi) {
    const float* pr = c + fl_pair_off(ND) + pi * PAIR_STRIDE;
    const int gi = (int)ldc(pr + P_ART);
    V3<T> P;
    if (art_static_floating<T, ND, WITH_TORQUE>(
            c, pr, c + fl_art_off(ND) + gi * ART_STRIDE,
            c + fl_static_off(ND) + (int)ldc(pr + P_STATIC) * STATIC_STRIDE, a, P,
            WITH_TORQUE ? &geom_tq[gi] : nullptr))
      geom_imp[gi] = add(geom_imp[gi], P);
  }

  // articulated geoms' bounding spheres vs the ground (unrecorded, as on
  // the JAX package's paths)
  const T e_gnd = T(ldc(c + C_E_GND)), mu_gnd = T(ldc(c + C_MU_GND));
  const V3<T> up = v3<T>(T(0.0f), T(0.0f), T(1.0f));
#pragma unroll 1
  for (int gi = 0; gi < n_art; ++gi) {
    const float* g = c + fl_art_off(ND) + gi * ART_STRIDE;
    V3<T> center;
    Q4<T> gq;
    geom_pose<T, ND>(a, g, center, gq);
    const T radius = T(ldc(g + A_RBOUND));
    V3<T> P;
    baumgarte_floating<T, ND>(c, a, (int)ldc(g + A_LINK),
                              v3<T>(center.x, center.y, center.z - radius), up,
                              center.z - radius, e_gnd, mu_gnd, P);
  }

  // outputs: qd and the base's velocities, impulse rows, the capped ball
#pragma unroll 1
  for (int d = 0; d < ND; ++d) IGT_OUT(ND + d, a.u[6 + d]);
  const int ob = 3 * ND;
  IGT_OUT(ob + 7, a.u[3]); IGT_OUT(ob + 8, a.u[4]); IGT_OUT(ob + 9, a.u[5]);
  IGT_OUT(ob + 10, a.u[0]); IGT_OUT(ob + 11, a.u[1]); IGT_OUT(ob + 12, a.u[2]);
  const int io = 3 * ND + 22;
#pragma unroll 1
  for (int gi = 0; gi < n_art; ++gi) {
    IGT_OUT(io + 3 * gi, geom_imp[gi].x);
    IGT_OUT(io + 3 * gi + 1, geom_imp[gi].y);
    IGT_OUT(io + 3 * gi + 2, geom_imp[gi].z);
  }
  IGT_OUT(io + 3 * n_art, imp.x);
  IGT_OUT(io + 3 * n_art + 1, imp.y);
  IGT_OUT(io + 3 * n_art + 2, imp.z);
  if constexpr (WITH_TORQUE) {
    // moment rows: one per art geom body, then the ball's
    const int it = io + 3 * (n_art + 1);
#pragma unroll 1
    for (int gi = 0; gi < n_art; ++gi) {
      IGT_OUT(it + 3 * gi, geom_tq[gi].x);
      IGT_OUT(it + 3 * gi + 1, geom_tq[gi].y);
      IGT_OUT(it + 3 * gi + 2, geom_tq[gi].z);
    }
    IGT_OUT(it + 3 * n_art, tqb.x);
    IGT_OUT(it + 3 * n_art + 1, tqb.y);
    IGT_OUT(it + 3 * n_art + 2, tqb.z);
  }
  ball_finish(c, pos, vel, omg);
  IGT_OUT(ob + 13, pos.x); IGT_OUT(ob + 14, pos.y); IGT_OUT(ob + 15, pos.z);
  IGT_OUT(ob + 16, vel.x); IGT_OUT(ob + 17, vel.y); IGT_OUT(ob + 18, vel.z);
  IGT_OUT(ob + 19, omg.x); IGT_OUT(ob + 20, omg.y); IGT_OUT(ob + 21, omg.z);
#undef IGT_IN
#undef IGT_OUT
  (void)NV;
}

}  // namespace igt
