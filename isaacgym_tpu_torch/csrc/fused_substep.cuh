// K2, the fused physics substep of the flagship scene: the per-env body.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:754 (build_fused_substep):
// K2 with with_dr=False, K2-dr with with_dr=True (the compile-time WITH_DR
// below), and their torque-lane builds K2-tau (with_torque=True, the
// compile-time WITH_TORQUE). One call computes one env's
// whole substep: PD -> FK -> world inertias -> mass matrix -> RNEA bias ->
// Cholesky -> semi-implicit Euler with limits -> FK at the new q -> ball
// gravity/damping -> plane, static-geom and articulated-geom contacts (swept
// CCD, gated restitution, spin friction, joint-space reactions through the
// factor) -> art-vs-static narrowphase with exact support and the 2 mm
// resting band -> ball integration.
//
// The same header is compiled two ways: inside the __global__ wrapper of
// fused_substep.cu (one thread per env, nvcc, sm_90a) and inside the host
// loop of fused_substep_host.cpp (g++), which the CPU tests hold against the
// plain PyTorch version and which counts the operations this data needs.
// ``T`` is float in both kernels; the host counter instantiates it with a
// counting type.
//
// Scene constants are read at run time from one float32 buffer (layout
// below, mirrored by isaacgym_tpu_torch/ops/fused_substep.py); only the DOF
// count ND, WITH_DR and WITH_TORQUE are compile-time parameters.
//
// K2-tau (WITH_TORQUE) also writes the force sensors' moment rows after the
// impulse rows: each articulated geom body's contact moment about its frame
// origin (the lever from the body origin, the A_BODY_OFF slots, to the
// contact point; ball contacts and art-vs-static contacts alike), then the
// ball's contact moment about its centre (lever -r n). Built only for scenes
// that register a sensor; WITH_TORQUE = false compiles to K2 unchanged, with
// no moment arithmetic.
//
// K2-dr reads a per-env domain-randomization channel of n_dr(ND) = 4 ND + 6
// rows appended to the packed input, in the JAX package's order (kp scale,
// kd scale, lower shift, upper shift per DOF, then mass scale, gravity
// offset xyz, friction scale, restitution scale). Each value is read where it
// is used, with __ldg on its coalesced row, so the K2-dr body holds no more
// live registers than it must; WITH_DR = false compiles to K2 unchanged. Loops over DOFs are unrolled, so
// per-DOF arrays stay in registers; a runtime parent or link index selects
// among them with a compare per candidate instead of indexing.
//
// What bounds it on an H100: at B = 4096 one thread per env gives 128 warps,
// about one per SM, and a few thousand dependent FP32 operations per thread;
// the bytes (~300 per env) are negligible. So it is latency-bound, far from
// both the FP32 peak and the memory rate. Making it fast (more envs per
// launch, shared-memory staging of the constants, splitting the contact
// phase across lanes, warp specialisation) is work for later PRs.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define IGT_HD __host__ __device__ __forceinline__
#else
#define IGT_HD inline
#endif

namespace igt {

// ---------------------------------------------------------------- layout --
constexpr int MAX_STATIC = 16;
constexpr int MAX_ART = 8;
constexpr int MAX_PAIRS = 32;

enum : int {
  C_ND = 0, C_NSTATIC, C_NART, C_NPAIR, C_DT, C_DT_HALF, C_DT_QUARTER,
  C_GX, C_GY, C_GZ, C_BOUNCE, C_MAX_DEPEN, C_BIAS_K,
  C_BASE_P = 13, C_BASE_Q = 16,
  C_INV_MB = 20, C_MB, C_RB, C_E_BALL, C_MU_BALL, C_PLANE_E, C_PLANE_MU,
  C_MAX_LIN, C_MAX_ANG, C_LIN_DAMP, C_ANG_DAMP, C_KD_AERO, C_KM_AERO,
  C_KAPPA, C_ONE_P_KAPPA, C_KAPPA_OVER_RB, C_WT0, C_KAPPA_INVMB_OVER_RB,
  C_NTRUE_STATIC = 38,
  C_DRIVE = 39,  // 0: PD position drive, 1: effort drive (K3's articulations)
  C_TQ_STATIC = 40   // -r / inv_m: a static contact's moment factor about the ball
};
constexpr int DOF_OFF = 48, DOF_STRIDE = 32;
enum : int {
  D_PARENT = 0, D_REV = 1, D_PRE_POS = 2, D_PRE_QUAT = 5, D_AXIS = 9,
  D_MASS = 12, D_COM = 13, D_INERTIA = 16, D_ARMATURE = 25, D_LO = 26,
  D_HI = 27, D_EFFORT = 28, D_MAXVEL = 29, D_KP = 30, D_KD = 31
};
constexpr int STATIC_STRIDE = 20;
// G_E/G_MU: the ball-combined material; *_RAW: the geom's own, which K2-dr
// scales per env before combining
enum : int {
  G_KIND = 0, G_POS = 1, G_ROT = 4, G_SIZE = 13, G_E = 16, G_MU = 17,
  G_E_RAW = 18, G_MU_RAW = 19
};
constexpr int ART_STRIDE = 20;
enum : int {
  A_KIND = 0, A_LINK = 1, A_OFF_POS = 2, A_OFF_QUAT = 5, A_SIZE = 9,
  A_E = 12, A_MU = 13, A_RBOUND = 14, A_E_RAW = 15, A_MU_RAW = 16,
  A_BODY_OFF = 17   // the geom body's frame origin in its link frame (3 slots)
};
constexpr int PAIR_STRIDE = 8;
enum : int { P_ART = 0, P_STATIC = 1, P_EXACT = 2, P_E = 3, P_MU = 4 };
enum : int { GEOM_SPHERE = 0, GEOM_BOX = 1, GEOM_CYLINDER = 2 };

IGT_HD constexpr int mask_off(int nd) { return DOF_OFF + nd * DOF_STRIDE; }
IGT_HD constexpr int static_off(int nd) { return mask_off(nd) + nd * nd; }
IGT_HD constexpr int art_off(int nd) { return static_off(nd) + MAX_STATIC * STATIC_STRIDE; }
IGT_HD constexpr int pair_off(int nd) { return art_off(nd) + MAX_ART * ART_STRIDE; }
IGT_HD constexpr int total_size(int nd) { return pair_off(nd) + MAX_PAIRS * PAIR_STRIDE; }
IGT_HD constexpr int n_in(int nd) { return 4 * nd + 9; }
IGT_HD constexpr int n_out(int nd, int ng, bool with_torque = false) {
  return 3 * nd + 9 + 3 * (ng + 1) * (with_torque ? 2 : 1);
}
IGT_HD constexpr int n_dr(int nd) { return 4 * nd + 6; }

// Fills ``out`` with the layout (dof, mask, static, art, pair, total,
// max_static, max_art, max_pairs, n_dr, the slots K2-dr reads: true static
// count, raw static restitution, raw art restitution, and those K2-tau
// reads: the art geom's body origin and the static moment factor) so the
// Python side can check it.
inline int fill_layout(int nd, int* out, int n) {
  if (n < 15 || nd < 1) return 1;
  out[0] = DOF_OFF; out[1] = mask_off(nd); out[2] = static_off(nd);
  out[3] = art_off(nd); out[4] = pair_off(nd); out[5] = total_size(nd);
  out[6] = MAX_STATIC; out[7] = MAX_ART; out[8] = MAX_PAIRS;
  out[9] = n_dr(nd); out[10] = C_NTRUE_STATIC; out[11] = G_E_RAW; out[12] = A_E_RAW;
  out[13] = A_BODY_OFF; out[14] = C_TQ_STATIC;
  return 0;
}

// ------------------------------------------------------------ scalar math --
IGT_HD float ldc(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}
IGT_HD float sqrt_(float a) { return sqrtf(a); }
IGT_HD float sin_(float a) { return sinf(a); }
IGT_HD float cos_(float a) { return cosf(a); }
IGT_HD float abs_(float a) { return fabsf(a); }
IGT_HD float min_(float a, float b) { return a < b ? a : b; }
IGT_HD float max_(float a, float b) { return a > b ? a : b; }
IGT_HD float to_f(float a) { return a; }

template <class T> IGT_HD T clip_(T x, T lo, T hi) { return min_(max_(x, lo), hi); }
template <class T> IGT_HD T sel(bool c, T a, T b) { return c ? a : b; }

template <class T> struct V3 { T x, y, z; };
template <class T> struct Q4 { T x, y, z, w; };

template <class T> IGT_HD V3<T> v3(T a, T b, T c) { V3<T> r; r.x = a; r.y = b; r.z = c; return r; }
template <class T> IGT_HD V3<T> cv3(const float* p) { return v3<T>(T(ldc(p)), T(ldc(p + 1)), T(ldc(p + 2))); }
template <class T> IGT_HD Q4<T> cq4(const float* p) {
  Q4<T> r; r.x = T(ldc(p)); r.y = T(ldc(p + 1)); r.z = T(ldc(p + 2)); r.w = T(ldc(p + 3)); return r;
}
template <class T> IGT_HD V3<T> add(V3<T> a, V3<T> b) { return v3<T>(a.x + b.x, a.y + b.y, a.z + b.z); }
template <class T> IGT_HD V3<T> sub(V3<T> a, V3<T> b) { return v3<T>(a.x - b.x, a.y - b.y, a.z - b.z); }
template <class T> IGT_HD V3<T> scale(V3<T> a, T s) { return v3<T>(a.x * s, a.y * s, a.z * s); }
template <class T> IGT_HD T dot(V3<T> a, V3<T> b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
template <class T> IGT_HD V3<T> cross(V3<T> a, V3<T> b) {
  return v3<T>(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
template <class T> IGT_HD V3<T> vsel(bool c, V3<T> a, V3<T> b) {
  return v3<T>(sel(c, a.x, b.x), sel(c, a.y, b.y), sel(c, a.z, b.z));
}
// v + 2w(u x v) + u x (2 u x v), the association of the Pallas _qrot
template <class T> IGT_HD V3<T> qrot(Q4<T> q, V3<T> v) {
  T tx = T(2.0f) * (q.y * v.z - q.z * v.y);
  T ty = T(2.0f) * (q.z * v.x - q.x * v.z);
  T tz = T(2.0f) * (q.x * v.y - q.y * v.x);
  return v3<T>(v.x + q.w * tx + (q.y * tz - q.z * ty),
               v.y + q.w * ty + (q.z * tx - q.x * tz),
               v.z + q.w * tz + (q.x * ty - q.y * tx));
}
// Hamilton product, the association of the Pallas _qmul_s
template <class T> IGT_HD Q4<T> qmul(Q4<T> a, Q4<T> b) {
  Q4<T> r;
  r.x = (a.w * b.x + a.x * b.w) + (a.y * b.z - a.z * b.y);
  r.y = (a.w * b.y + a.y * b.w) + (a.z * b.x - a.x * b.z);
  r.z = (a.w * b.z + a.z * b.w) + (a.x * b.y - a.y * b.x);
  r.w = a.w * b.w - ((a.x * b.x + a.y * b.y) + a.z * b.z);
  return r;
}
template <class T> IGT_HD Q4<T> conj(Q4<T> q) { Q4<T> r; r.x = -q.x; r.y = -q.y; r.z = -q.z; r.w = q.w; return r; }
// constant row-major 3x3 R times v, and R^T times v
template <class T> IGT_HD V3<T> mat(const float* R, V3<T> v) {
  return v3<T>(T(ldc(R + 0)) * v.x + T(ldc(R + 1)) * v.y + T(ldc(R + 2)) * v.z,
               T(ldc(R + 3)) * v.x + T(ldc(R + 4)) * v.y + T(ldc(R + 5)) * v.z,
               T(ldc(R + 6)) * v.x + T(ldc(R + 7)) * v.y + T(ldc(R + 8)) * v.z);
}
template <class T> IGT_HD V3<T> mat_t(const float* R, V3<T> v) {
  return v3<T>(T(ldc(R + 0)) * v.x + T(ldc(R + 3)) * v.y + T(ldc(R + 6)) * v.z,
               T(ldc(R + 1)) * v.x + T(ldc(R + 4)) * v.y + T(ldc(R + 7)) * v.z,
               T(ldc(R + 2)) * v.x + T(ldc(R + 5)) * v.y + T(ldc(R + 8)) * v.z);
}
template <class T> IGT_HD T sqrt_floor(T x, float floor) { return sqrt_(max_(x, T(floor))); }

// ------------------------------------------------------- contact geometry --
// sphere of radius ``rad`` at local point c vs a geom (kind, half sizes s)
template <class T>
IGT_HD void sphere_geom(int kind, const float* s, V3<T> c, T rad, T& dist, V3<T>& n) {
  if (kind == GEOM_SPHERE) {
    T dn = sqrt_floor(dot(c, c), 1e-18f);
    dist = dn - T(ldc(s)) - rad;
    n = scale(c, T(1.0f) / dn);
    return;
  }
  if (kind == GEOM_BOX) {
    const T hx = T(ldc(s)), hy = T(ldc(s + 1)), hz = T(ldc(s + 2));
    V3<T> cl = v3<T>(clip_(c.x, -hx, hx), clip_(c.y, -hy, hy), clip_(c.z, -hz, hz));
    V3<T> d = sub(c, cl);
    T out2 = dot(d, d);
    T out_dist = sqrt_floor(out2, 1e-18f);
    bool outside = out2 > T(1e-12f);
    T g0 = hx - abs_(c.x), g1 = hy - abs_(c.y), g2 = hz - abs_(c.z);
    T sx = sel(c.x >= T(0.0f), T(1.0f), T(-1.0f));
    T sy = sel(c.y >= T(0.0f), T(1.0f), T(-1.0f));
    T sz = sel(c.z >= T(0.0f), T(1.0f), T(-1.0f));
    bool use_x = (g0 <= g1) && (g0 <= g2);
    bool use_y = !use_x && (g1 <= g2);
    bool use_z = !use_x && !use_y;
    V3<T> n_in = v3<T>(sel(use_x, sx, T(0.0f)), sel(use_y, sy, T(0.0f)), sel(use_z, sz, T(0.0f)));
    T d_in = -min_(g0, min_(g1, g2));
    V3<T> n_out = scale(d, T(1.0f) / out_dist);
    n = vsel(outside, n_out, n_in);
    dist = sel(outside, out_dist, d_in) - rad;
    return;
  }
  const T radius = T(ldc(s)), half_len = T(ldc(s + 1));
  T r2 = c.x * c.x + c.y * c.y;
  T r_xy = sqrt_floor(r2, 1e-18f);
  T sc = min_(radius / r_xy, T(1.0f));
  V3<T> cl = v3<T>(c.x * sc, c.y * sc, clip_(c.z, -half_len, half_len));
  V3<T> d = sub(c, cl);
  T out2 = dot(d, d);
  T out_dist = sqrt_floor(out2, 1e-18f);
  bool outside = out2 > T(1e-12f);
  T face_gap = half_len - abs_(c.z);
  T wall_gap = radius - r_xy;
  T zsgn = sel(c.z >= T(0.0f), T(1.0f), T(-1.0f));
  bool use_face = face_gap < wall_gap;
  T inv_rxy = T(1.0f) / r_xy;
  V3<T> n_in = v3<T>(sel(use_face, T(0.0f), c.x * inv_rxy), sel(use_face, T(0.0f), c.y * inv_rxy),
                     sel(use_face, zsgn, T(0.0f)));
  T d_in = -min_(face_gap, wall_gap);
  V3<T> n_out = scale(d, T(1.0f) / out_dist);
  n = vsel(outside, n_out, n_in);
  dist = sel(outside, out_dist, d_in) - rad;
}

// swept-sample CCD in the geom frame: first penetrating sample wins
template <class T>
IGT_HD void sweep(int kind, const float* s, T rad, V3<T> c0, V3<T> dv_l, int samples,
                  T& dist, V3<T>& n) {
  bool found = dist < T(0.0f);
  V3<T> ck = c0;
  for (int k = 0; k < samples; ++k) {
    ck = add(ck, dv_l);
    T dk; V3<T> nk;
    sphere_geom(kind, s, ck, rad, dk, nk);
    bool take = !found && (dk < T(0.0f));
    if (take) { dist = dk; n = nk; }
    found = found || (dk < T(0.0f));
  }
}

// spin-aware impulse against a static surface; returns dv, updates state
template <class T>
IGT_HD V3<T> resolve_static(const float* c, V3<T>& vel, V3<T>& omg, V3<T>& pos, T dist,
                            V3<T> n, T e, T mu, T dist_now) {
  T vn = dot(vel, n);
  bool active = (dist < T(0.0f)) && (vn < T(0.0f));
  if (!active) return v3<T>(T(0.0f), T(0.0f), T(0.0f));
  T e_eff = sel(abs_(vn) > T(ldc(c + C_BOUNCE)), e, T(0.0f));
  T jn = -(T(1.0f) + e_eff) * vn;
  V3<T> slip = ldc(c + C_KAPPA) > 0.0f
      ? sub(vel, scale(cross(omg, n), T(ldc(c + C_RB)))) : vel;
  V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  T jt = min_(mu * jn, vt_n / T(ldc(c + C_ONE_P_KAPPA)));
  V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
  V3<T> dv = sub(scale(n, jn), scale(t_hat, jt));
  vel = add(vel, dv);
  omg = add(omg, scale(cross(n, t_hat), T(ldc(c + C_KAPPA_OVER_RB)) * jt));
  pos = add(pos, scale(n, max_(-dist_now, T(0.0f))));
  return dv;
}

// ------------------------------------------------------------- dynamics --
template <class T, int ND>
IGT_HD void fk(const float* c, const T* q, V3<T>* fp, Q4<T>* fq, V3<T>* axw) {
  const V3<T> bp = cv3<T>(c + C_BASE_P);
  const Q4<T> bq = cq4<T>(c + C_BASE_Q);
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    const int par = (int)ldc(dc + D_PARENT);
    V3<T> pp = bp;
    Q4<T> pq = bq;
#pragma unroll
    for (int k = 0; k < d; ++k)
      if (k == par) { pp = fp[k]; pq = fq[k]; }
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

template <class T, int ND>
IGT_HD void fwd_sub(const T* L, const T* b, T* y) {
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T s = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - L[i * (i + 1) / 2 + j] * y[j];
    y[i] = s / L[i * (i + 1) / 2 + i];
  }
}

template <class T, int ND>
IGT_HD void back_sub(const T* L, const T* y, T* x) {
#pragma unroll
  for (int i = ND - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int j = i + 1; j < ND; ++j) s = s - L[j * (j + 1) / 2 + i] * x[j];
    x[i] = s / L[i * (i + 1) / 2 + i];
  }
}

// Jacobian column i of a point on ``link`` (only ancestors of link move it)
template <class T, int ND>
IGT_HD V3<T> jac_col(const float* c, const float* mask, int link, int i, V3<T> point,
                     const V3<T>* fp, const V3<T>* axw, bool& on) {
  on = false;
#pragma unroll
  for (int l = 0; l < ND; ++l)
    if (l == link) on = ldc(mask + l * ND + i) != 0.0f;
  if (!on) return v3<T>(T(0.0f), T(0.0f), T(0.0f));
  if (ldc(c + DOF_OFF + i * DOF_STRIDE + D_REV) != 0.0f) return cross(axw[i], sub(point, fp[i]));
  return axw[i];
}

// ------------------------------------------------- the phases of a substep --
// Each phase works on one articulation's or one ball's constant block: K2's
// whole pack, or one of K3's articulation or ball blocks, which keep K2's
// slots (fused_substep_multi.cuh). ``sB`` is the batch stride of the
// channel-major buffers.

// One articulation's dynamics: drive (PD, or the effort input when the
// block's C_DRIVE is 1) with the effort clamp -> FK -> RNEA bias -> mass
// matrix -> Cholesky -> semi-implicit Euler with limits -> FK at the new q.
// Its DOFs are rows row0.. of the q, qd, target and effort blocks of x (each
// nd_tot rows); q and tau are written to the same rows of y's q and tau
// blocks. Leaves the packed lower factor in L, the joint velocities in u and
// the post-step frames. ``dr``: env b's first K2-dr channel row (WITH_DR).
template <class T, int ND, bool WITH_DR>
IGT_HD void art_dynamics(const float* __restrict__ c, const float* __restrict__ x,
                         float* __restrict__ y, int b, size_t sB, int row0, int nd_tot,
                         const float* dr, T* L, T* u, V3<T>* fp, Q4<T>* fq, V3<T>* axw) {
  const float* mask = c + mask_off(ND);
  const T dt = T(ldc(c + C_DT));
#define IGT_IN(blk, d) T(x[(size_t)((blk) * nd_tot + row0 + (d)) * sB + b])
#define IGT_OUT(blk, d, v) (y[(size_t)((blk) * nd_tot + row0 + (d)) * sB + b] = to_f(v))
  // DR channel k: kp scale 0..ND-1, kd scale ND.., lower shift 2ND.., upper
  // shift 3ND.., mass 4ND, gravity offset 4ND+1..3
#define IGT_DR(k) T(ldc(dr + (size_t)(k) * sB))
  const bool effort_drive = ldc(c + C_DRIVE) != 0.0f;

  T q[ND], qd[ND], tau[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    q[d] = IGT_IN(0, d);
    qd[d] = IGT_IN(1, d);
    T t;
    if (effort_drive) {
      t = IGT_IN(3, d);
    } else {
      T kp = T(ldc(dc + D_KP)), kd = T(ldc(dc + D_KD));
      if constexpr (WITH_DR) {
        kp = kp * IGT_DR(d);
        kd = kd * IGT_DR(ND + d);
      }
      t = kp * (IGT_IN(2, d) - q[d]) - kd * qd[d] + IGT_IN(3, d);
    }
    const T eff = T(ldc(dc + D_EFFORT));
    tau[d] = clip_(t, -eff, eff);
  }

  fk<T, ND>(c, q, fp, fq, axw);

  // velocity / bias propagation, RNEA with qdd = 0 in the world frame
  const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  V3<T> w[ND], wd[ND], ao[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    const int par = (int)ldc(dc + D_PARENT);
    V3<T> w_p = zero3, wd_p = zero3, ao_p = zero3, o_p = cv3<T>(c + C_BASE_P);
#pragma unroll
    for (int k = 0; k < d; ++k)
      if (k == par) { w_p = w[k]; wd_p = wd[k]; ao_p = ao[k]; o_p = fp[k]; }
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

  // per link: world COM and inertia, wrench, Jacobian columns; the bias and
  // the mass matrix accumulate link by link (ascending l per entry)
  T acc[ND];
  T* M = L;   // factored in place below
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = T(0.0f);
#pragma unroll
  for (int i = 0; i < ND * (ND + 1) / 2; ++i) M[i] = T(0.0f);
  const T gx = T(ldc(c + C_GX)), gy = T(ldc(c + C_GY)), gz = T(ldc(c + C_GZ));
#pragma unroll
  for (int l = 0; l < ND; ++l) {
    const float* lc = c + DOF_OFF + l * DOF_STRIDE;
    const Q4<T> qq = fq[l];
    V3<T> com = add(fp[l], qrot(qq, cv3<T>(lc + D_COM)));
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
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RI[i][j] = R[i][0] * T(ldc(I + j)) + R[i][1] * T(ldc(I + 3 + j)) + R[i][2] * T(ldc(I + 6 + j));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) {
        Iw[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
        Iw[j][i] = Iw[i][j];
      }
    V3<T> rc = sub(com, fp[l]);
    V3<T> a_com = add(ao[l], add(cross(wd[l], rc), cross(w[l], cross(w[l], rc))));
    const T m = T(ldc(lc + D_MASS));
    V3<T> f;
    if constexpr (WITH_DR) {
      // link forces (a_com - g_eff) m ms
      f = scale(v3<T>(a_com.x - (gx + IGT_DR(4 * ND + 1)), a_com.y - (gy + IGT_DR(4 * ND + 2)),
                      a_com.z - (gz + IGT_DR(4 * ND + 3))),
                m * IGT_DR(4 * ND));
    } else {
      f = scale(v3<T>(a_com.x - gx, a_com.y - gy, a_com.z - gz), m);
    }
    V3<T> Iwd = v3<T>(Iw[0][0] * wd[l].x + Iw[0][1] * wd[l].y + Iw[0][2] * wd[l].z,
                      Iw[1][0] * wd[l].x + Iw[1][1] * wd[l].y + Iw[1][2] * wd[l].z,
                      Iw[2][0] * wd[l].x + Iw[2][1] * wd[l].y + Iw[2][2] * wd[l].z);
    V3<T> Iww = v3<T>(Iw[0][0] * w[l].x + Iw[0][1] * w[l].y + Iw[0][2] * w[l].z,
                      Iw[1][0] * w[l].x + Iw[1][1] * w[l].y + Iw[1][2] * w[l].z,
                      Iw[2][0] * w[l].x + Iw[2][1] * w[l].y + Iw[2][2] * w[l].z);
    V3<T> nn = add(Iwd, cross(w[l], Iww));
    if constexpr (WITH_DR) nn = scale(nn, IGT_DR(4 * ND));   // gyroscopic term x ms
    V3<T> J[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (ldc(mask + l * ND + i) == 0.0f) continue;
      J[i] = ldc(c + DOF_OFF + i * DOF_STRIDE + D_REV) != 0.0f ? cross(axw[i], sub(com, fp[i])) : axw[i];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (ldc(mask + l * ND + i) == 0.0f) continue;
      const bool rev_i = ldc(c + DOF_OFF + i * DOF_STRIDE + D_REV) != 0.0f;
      if (rev_i) acc[i] = acc[i] + dot(axw[i], nn);
      acc[i] = acc[i] + dot(J[i], f);
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        if (ldc(mask + l * ND + j) == 0.0f) continue;
        T& Mij = M[i * (i + 1) / 2 + j];
        if (rev_i && ldc(c + DOF_OFF + j * DOF_STRIDE + D_REV) != 0.0f) {
          V3<T> a = axw[j];
          V3<T> Ia = v3<T>(Iw[0][0] * a.x + Iw[0][1] * a.y + Iw[0][2] * a.z,
                           Iw[1][0] * a.x + Iw[1][1] * a.y + Iw[1][2] * a.z,
                           Iw[2][0] * a.x + Iw[2][1] * a.y + Iw[2][2] * a.z);
          Mij = Mij + dot(axw[i], Ia);
        }
        Mij = Mij + m * dot(J[i], J[j]);
      }
    }
  }

  // Cholesky (packed lower triangle, in place) and the solve for qdd
  T rhs[ND], qdd[ND], tmp[ND];
  if constexpr (WITH_DR) {
    // M x ms, before the armature is added
    const T ms = IGT_DR(4 * ND);
#pragma unroll
    for (int i = 0; i < ND * (ND + 1) / 2; ++i) M[i] = M[i] * ms;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    rhs[i] = tau[i] - acc[i];
    M[i * (i + 1) / 2 + i] = M[i * (i + 1) / 2 + i]
        + T(ldc(c + DOF_OFF + i * DOF_STRIDE + D_ARMATURE));
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    T s = M[j * (j + 1) / 2 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
    T dia = sqrt_floor(s, 1e-12f);
    L[j * (j + 1) / 2 + j] = dia;
    T inv_d = T(1.0f) / dia;
#pragma unroll
    for (int i = j + 1; i < ND; ++i) {
      T s2 = M[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      L[i * (i + 1) / 2 + j] = s2 * inv_d;
    }
  }
  fwd_sub<T, ND>(L, rhs, tmp);
  back_sub<T, ND>(L, tmp, qdd);

  // semi-implicit Euler, velocity clamp, joint limits
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float* dc = c + DOF_OFF + d * DOF_STRIDE;
    T v = qd[d] + dt * qdd[d];
    const float mv = ldc(dc + D_MAXVEL);
    if (mv > 0.0f) v = clip_(v, T(-mv), T(mv));
    T p = q[d] + dt * v;
    T lo = T(ldc(dc + D_LO)), hi = T(ldc(dc + D_HI));
    if constexpr (WITH_DR) {
      lo = lo + IGT_DR(2 * ND + d);
      hi = hi + IGT_DR(3 * ND + d);
    }
    bool at_lo = p < lo, at_hi = p > hi;
    p = clip_(p, lo, hi);
    if (at_lo) v = max_(v, T(0.0f));
    if (at_hi) v = min_(v, T(0.0f));
    q[d] = p;
    u[d] = v;
    IGT_OUT(0, d, p);
    IGT_OUT(2, d, tau[d]);
  }
  fk<T, ND>(c, q, fp, fq, axw);
#undef IGT_IN
#undef IGT_OUT
#undef IGT_DR
}

// A ball's free flight over one substep: gravity (gx, gy, gz), velocity
// damping, the optional drag and Magnus terms. ``cb``: the ball's block.
template <class T>
IGT_HD void ball_flight(const float* cb, T gx, T gy, T gz, V3<T>& vel, V3<T>& omg) {
  const T dt = T(ldc(cb + C_DT));
  vel = v3<T>(vel.x + gx * dt, vel.y + gy * dt, vel.z + gz * dt);
  vel = scale(vel, T(ldc(cb + C_LIN_DAMP)));
  omg = scale(omg, T(ldc(cb + C_ANG_DAMP)));
  if (ldc(cb + C_KD_AERO) > 0.0f)
    vel = sub(vel, scale(vel, dt * T(ldc(cb + C_KD_AERO)) * sqrt_floor(dot(vel, vel), 1e-18f)));
  if (ldc(cb + C_KM_AERO) > 0.0f)
    vel = add(vel, scale(cross(omg, vel), dt * T(ldc(cb + C_KM_AERO))));
}

// The moment about a ball's centre (block cb) of a static contact with
// normal n that changed its velocity by dv: lever -r n, impulse dv / inv_m.
template <class T>
IGT_HD V3<T> static_moment(const float* cb, V3<T> n, V3<T> dv) {
  return scale(cross(n, dv), T(ldc(cb + C_TQ_STATIC)));
}

// The ground plane z = 0: the swept minimum along a plane is monotone.
// Returns the velocity change.
template <class T>
IGT_HD V3<T> ball_plane(const float* cb, V3<T>& pos, V3<T>& vel, V3<T>& omg) {
  T dist0 = pos.z - T(ldc(cb + C_RB));
  T dist = min_(dist0, dist0 + vel.z * T(ldc(cb + C_DT)));
  return resolve_static(cb, vel, omg, pos, dist, v3<T>(T(0.0f), T(0.0f), T(1.0f)),
                        T(ldc(cb + C_PLANE_E)), T(ldc(cb + C_PLANE_MU)), dist0);
}

// A ball against one static geom (entry g), 2 sweep samples, combined
// materials e and mu. Returns the velocity change; with ``tq`` adds the
// contact's moment about the ball's centre to it.
template <class T>
IGT_HD V3<T> ball_static(const float* cb, const float* g, T e, T mu, V3<T>& pos, V3<T>& vel,
                         V3<T>& omg, V3<T>* tq = nullptr) {
  const int kind = (int)ldc(g + G_KIND);
  const float* R = g + G_ROT;
  const T rb = T(ldc(cb + C_RB));
  V3<T> c0 = mat_t(R, sub(pos, cv3<T>(g + G_POS)));
  V3<T> dv_l = mat_t(R, scale(vel, T(ldc(cb + C_DT_HALF))));
  T dist;
  V3<T> n_l;
  sphere_geom(kind, g + G_SIZE, c0, rb, dist, n_l);
  const T d0 = dist;
  sweep(kind, g + G_SIZE, rb, c0, dv_l, 2, dist, n_l);
  const V3<T> n = mat(R, n_l);
  V3<T> dv = resolve_static(cb, vel, omg, pos, dist, n, e, mu, d0);
  if (tq) *tq = add(*tq, static_moment(cb, n, dv));
  return dv;
}

// A ball (block cb) against one articulated geom (entry g) of the
// articulation with block ca, factor L, velocities u and post-step frames:
// swept CCD along the relative motion, gated restitution, spin friction and
// the joint-space reaction through L, which changes u. The materials are
// read only when the contact acts: g[e_off] and g[mu_off], or with WITH_DR
// the geom's own scaled by env b's DR channel (dr, K2-dr's rows) and
// combined with the ball's. Returns whether it acted; P is the impulse on
// the ball. With ``ball_tq`` the contact's moments are added: about the
// ball's centre (lever -r n at the current depth) to it, and about the geom
// body's frame origin (lever to the contact point) to ``geom_tq``.
template <class T, int ND, bool WITH_DR>
IGT_HD bool ball_art(const float* ca, const float* cb, const float* g, int e_off, int mu_off,
                     const float* dr, size_t sB, V3<T>& pos, V3<T>& vel, V3<T>& omg, T* u,
                     const T* L, const V3<T>* fp, const Q4<T>* fq, const V3<T>* axw, V3<T>& P,
                     V3<T>* ball_tq = nullptr, V3<T>* geom_tq = nullptr) {
  const float* mask = ca + mask_off(ND);
  const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  const T rb = T(ldc(cb + C_RB)), inv_mb = T(ldc(cb + C_INV_MB));
  const int kind = (int)ldc(g + A_KIND), link = (int)ldc(g + A_LINK);
  V3<T> lp = zero3;
  Q4<T> lq = cq4<T>(ca + C_BASE_Q);
#pragma unroll
  for (int k = 0; k < ND; ++k)
    if (k == link) { lp = fp[k]; lq = fq[k]; }
  V3<T> gp = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
  Q4<T> gq = qmul(lq, cq4<T>(g + A_OFF_QUAT));
  Q4<T> gqi = conj(gq);
  V3<T> c0 = qrot(gqi, sub(pos, gp));
  T d_now;
  V3<T> n_now_l;
  sphere_geom(kind, g + A_SIZE, c0, rb, d_now, n_now_l);
  const V3<T> n_now = qrot(gq, n_now_l);
  V3<T> cp = sub(pos, scale(n_now, rb));
  V3<T> Jc[ND];
  bool on[ND];
  V3<T> v_point = zero3;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    Jc[i] = jac_col<T, ND>(ca, mask, link, i, cp, fp, axw, on[i]);
    if (on[i]) v_point = add(v_point, scale(Jc[i], u[i]));
  }
  V3<T> v_rel = sub(vel, v_point);
  V3<T> dv_l = qrot(gqi, scale(v_rel, T(ldc(cb + C_DT_QUARTER))));
  T dist = d_now;
  V3<T> n_l = n_now_l;
  sweep(kind, g + A_SIZE, rb, c0, dv_l, 4, dist, n_l);
  V3<T> n = qrot(gq, n_l);
  T vn = dot(v_rel, n);
  if (!((dist < T(0.0f)) && (vn < T(0.0f)))) return false;   // inactive: no impulse
  T e_art;
  if constexpr (WITH_DR)   // restitution scale: DR row 4ND+5
    e_art = T(0.5f) * (T(ldc(cb + C_E_BALL)) + T(ldc(g + A_E_RAW)) * T(ldc(dr + (size_t)(4 * ND + 5) * sB)));
  else
    e_art = T(ldc(g + e_off));
  T e_eff = sel(abs_(vn) > T(ldc(cb + C_BOUNCE)), e_art, T(0.0f));
  T jv[ND], yn[ND], yt[ND], du[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = on[i] ? dot(Jc[i], n) : T(0.0f);
  fwd_sub<T, ND>(L, jv, yn);
  T sq = T(0.0f);
#pragma unroll
  for (int i = 0; i < ND; ++i) sq = sq + yn[i] * yn[i];
  T w_n = inv_mb + sq;
  T Pn = -(T(1.0f) + e_eff) * vn / w_n;
  V3<T> slip = ldc(cb + C_KAPPA) > 0.0f ? sub(v_rel, scale(cross(omg, n), rb)) : v_rel;
  V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = on[i] ? dot(Jc[i], t_hat) : T(0.0f);
  fwd_sub<T, ND>(L, jv, yt);
  sq = T(0.0f);
#pragma unroll
  for (int i = 0; i < ND; ++i) sq = sq + yt[i] * yt[i];
  T w_t = T(ldc(cb + C_WT0)) + sq;
  T mu_art;
  if constexpr (WITH_DR)   // friction scale: DR row 4ND+4
    mu_art = T(0.5f) * (T(ldc(cb + C_MU_BALL)) + T(ldc(g + A_MU_RAW)) * T(ldc(dr + (size_t)(4 * ND + 4) * sB)));
  else
    mu_art = T(ldc(g + mu_off));
  T Pt = min_(mu_art * Pn, vt_n / w_t);
  P = sub(scale(n, Pn), scale(t_hat, Pt));
  vel = add(vel, scale(P, inv_mb));
  omg = add(omg, scale(cross(n, t_hat), T(ldc(cb + C_KAPPA_INVMB_OVER_RB)) * Pt));
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = yn[i] * (-Pn) + yt[i] * Pt;
  back_sub<T, ND>(L, jv, du);
#pragma unroll
  for (int i = 0; i < ND; ++i) u[i] = u[i] + du[i];
  pos = add(pos, scale(n, max_(-d_now, T(0.0f))));
  if (ball_tq) {
    *ball_tq = add(*ball_tq, scale(cross(n_now, P), -rb));
    V3<T> borg = add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)));
    *geom_tq = add(*geom_tq, cross(sub(cp, borg), scale(P, T(-1.0f))));
  }
  return true;
}

// One articulated geom (entry g) of the articulation with block ca against
// one true static (entry sg), pair entry pr: Baumgarte impulse on the
// generalized velocity u, exact support of a cylinder or box along the
// normal, the 2 mm resting band. Returns whether it acted; P is the impulse
// on the geom's body; with ``geom_tq`` its moment about the body's frame
// origin is added there.
template <class T, int ND>
IGT_HD bool art_static(const float* ca, const float* pr, const float* g, const float* sg, T* u,
                       const T* L, const V3<T>* fp, const Q4<T>* fq, const V3<T>* axw, V3<T>& P,
                       V3<T>* geom_tq = nullptr) {
  const float* mask = ca + mask_off(ND);
  const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  const int link = (int)ldc(g + A_LINK);
  const T rbound = T(ldc(g + A_RBOUND));
  V3<T> lp = zero3;
  Q4<T> lq = cq4<T>(ca + C_BASE_Q);
#pragma unroll
  for (int k = 0; k < ND; ++k)
    if (k == link) { lp = fp[k]; lq = fq[k]; }
  V3<T> center = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
  const float* R = sg + G_ROT;
  V3<T> c_local = mat_t(R, sub(center, cv3<T>(sg + G_POS)));
  T dist;
  V3<T> n_local;
  sphere_geom((int)ldc(sg + G_KIND), sg + G_SIZE, c_local, rbound, dist, n_local);
  V3<T> n = mat(R, n_local);
  V3<T> point;
  if (ldc(pr + P_EXACT) != 0.0f) {
    // exact support of the cylinder/box along the normal
    V3<T> n_g = qrot(conj(qmul(lq, cq4<T>(g + A_OFF_QUAT))), n);
    const float* gs = g + A_SIZE;
    T sup;
    if ((int)ldc(g + A_KIND) == GEOM_CYLINDER) {
      T na = abs_(n_g.z);
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
  if (!(dist < T(0.0f))) return false;   // inactive: no impulse
  V3<T> Jc[ND];
  bool on[ND];
  V3<T> v_point = zero3;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    Jc[i] = jac_col<T, ND>(ca, mask, link, i, point, fp, axw, on[i]);
    if (on[i]) v_point = add(v_point, scale(Jc[i], u[i]));
  }
  T vn = dot(v_point, n);
  if (!(vn < T(0.1f))) return false;
  const T bounce = T(ldc(ca + C_BOUNCE));
  T bias = min_(T(ldc(ca + C_BIAS_K)) * max_(-dist - T(0.005f), T(0.0f)),
                T(ldc(ca + C_MAX_DEPEN)));
  T e_eff = sel(abs_(vn) > bounce, T(ldc(pr + P_E)), T(0.0f));
  T jv[ND], yn[ND], yt[ND], du[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = on[i] ? dot(Jc[i], n) : T(0.0f);
  fwd_sub<T, ND>(L, jv, yn);
  T w_n = T(0.0f);
#pragma unroll
  for (int i = 0; i < ND; ++i) w_n = w_n + yn[i] * yn[i];
  T Pn = (-(T(1.0f) + e_eff) * min_(vn, T(0.0f)) + bias) / max_(w_n, T(1e-9f));
  V3<T> vt = sub(v_point, scale(n, vn));
  T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = on[i] ? dot(Jc[i], t_hat) : T(0.0f);
  fwd_sub<T, ND>(L, jv, yt);
  T w_t = T(0.0f);
#pragma unroll
  for (int i = 0; i < ND; ++i) w_t = w_t + yt[i] * yt[i];
  T Pt = min_(T(ldc(pr + P_MU)) * Pn, vt_n / max_(w_t, T(1e-9f)));
  // resting-contact band: ramp the impulse over the first 2 mm
  T s_r = sel(abs_(vn) > bounce, T(1.0f), clip_(-dist / T(0.002f), T(0.0f), T(1.0f)));
  Pn = Pn * s_r;
  Pt = Pt * s_r;
#pragma unroll
  for (int i = 0; i < ND; ++i) jv[i] = yn[i] * Pn - yt[i] * Pt;
  back_sub<T, ND>(L, jv, du);
#pragma unroll
  for (int i = 0; i < ND; ++i) u[i] = u[i] + du[i];
  P = sub(scale(n, Pn), scale(t_hat, Pt));
  if (geom_tq)
    *geom_tq = add(*geom_tq, cross(sub(point, add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)))), P));
  return true;
}

// The ball's velocity caps (PhysX caps the magnitude) and position update.
template <class T>
IGT_HD void ball_finish(const float* cb, V3<T>& pos, V3<T>& vel, V3<T>& omg) {
  vel = scale(vel, min_(T(ldc(cb + C_MAX_LIN)) / sqrt_floor(dot(vel, vel), 1e-18f), T(1.0f)));
  omg = scale(omg, min_(T(ldc(cb + C_MAX_ANG)) / sqrt_floor(dot(omg, omg), 1e-18f), T(1.0f)));
  const T dt = T(ldc(cb + C_DT));
  pos = v3<T>(pos.x + vel.x * dt, pos.y + vel.y * dt, pos.z + vel.z * dt);
}

// ------------------------------------------------------------- the body --
// One env's K2 substep. x: (n_in(ND) [+ n_dr(ND) with WITH_DR], B) inputs,
// y: (n_out(ND, ng, WITH_TORQUE), B) outputs, both channel-major; env b reads
// and writes column b.
template <class T, int ND, bool WITH_DR = false, bool WITH_TORQUE = false>
IGT_HD void fused_substep_env(const float* __restrict__ c, const float* __restrict__ x,
                              float* __restrict__ y, int b, int B) {
  const size_t sB = (size_t)B;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  // DR channel k (only read when WITH_DR): gravity offset 4ND+1..3,
  // friction 4ND+4, restitution 4ND+5
  const float* dr = x + (size_t)n_in(ND) * sB + b;
#define IGT_DR(k) T(ldc(dr + (size_t)(k) * sB))

  T L[ND * (ND + 1) / 2], u[ND];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
  art_dynamics<T, ND, WITH_DR>(c, x, y, b, sB, 0, ND, dr, L, u, fp, fq, axw);

  // ------------------------------------------------------------- ball --
  const T inv_mb = T(ldc(c + C_INV_MB));
  const int ib = 4 * ND;
  V3<T> pos = v3<T>(IGT_IN(ib), IGT_IN(ib + 1), IGT_IN(ib + 2));
  V3<T> vel = v3<T>(IGT_IN(ib + 3), IGT_IN(ib + 4), IGT_IN(ib + 5));
  V3<T> omg = v3<T>(IGT_IN(ib + 6), IGT_IN(ib + 7), IGT_IN(ib + 8));
  const T gx = T(ldc(c + C_GX)), gy = T(ldc(c + C_GY)), gz = T(ldc(c + C_GZ));
  if constexpr (WITH_DR)   // the ball's free flight under g_eff too
    ball_flight(c, gx + IGT_DR(4 * ND + 1), gy + IGT_DR(4 * ND + 2), gz + IGT_DR(4 * ND + 3),
                vel, omg);
  else
    ball_flight(c, gx, gy, gz, vel, omg);
  V3<T> dv0 = ball_plane(c, pos, vel, omg);
  V3<T> imp = scale(dv0, T(ldc(c + C_MB)));
  // WITH_TORQUE: the ball's contact moment and each geom body's
  V3<T> tqb, geom_tq[WITH_TORQUE ? MAX_ART : 1];
  if constexpr (WITH_TORQUE) tqb = static_moment(c, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);

  // static geoms (table, net, base-welded humanoid geoms)
  const int n_static = (int)ldc(c + C_NSTATIC);
  for (int si = 0; si < n_static; ++si) {
    const float* g = c + static_off(ND) + si * STATIC_STRIDE;
    T e = T(ldc(g + G_E)), mu = T(ldc(g + G_MU));
    if constexpr (WITH_DR) {
      // base-welded humanoid geoms (past the true statics) take the shape DR
      if (si >= (int)ldc(c + C_NTRUE_STATIC)) {
        e = T(0.5f) * (T(ldc(c + C_E_BALL)) + T(ldc(g + G_E_RAW)) * IGT_DR(4 * ND + 5));
        mu = T(0.5f) * (T(ldc(c + C_MU_BALL)) + T(ldc(g + G_MU_RAW)) * IGT_DR(4 * ND + 4));
      }
    }
    V3<T> dv = ball_static(c, g, e, mu, pos, vel, omg, WITH_TORQUE ? &tqb : nullptr);
    imp = v3<T>(imp.x + dv.x / inv_mb, imp.y + dv.y / inv_mb, imp.z + dv.z / inv_mb);
  }

  // articulated geoms: ball contacts with joint-space reactions through L
  const int n_art = (int)ldc(c + C_NART);
  V3<T> geom_imp[MAX_ART];
  for (int gi = 0; gi < n_art; ++gi) {
    const float* g = c + art_off(ND) + gi * ART_STRIDE;
    V3<T> P;
    geom_imp[gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    if constexpr (WITH_TORQUE) geom_tq[gi] = geom_imp[gi];
    if (!ball_art<T, ND, WITH_DR>(c, c, g, A_E, A_MU, dr, sB, pos, vel, omg, u, L, fp, fq,
                                  axw, P, WITH_TORQUE ? &tqb : nullptr,
                                  WITH_TORQUE ? &geom_tq[gi] : nullptr))
      continue;
    imp = add(imp, P);
    geom_imp[gi] = v3<T>(-P.x, -P.y, -P.z);
  }

  // art geoms vs the true statics (table slab, net): pairs pruned at pack time
  const int n_pair = (int)ldc(c + C_NPAIR);
  for (int pi = 0; pi < n_pair; ++pi) {
    const float* pr = c + pair_off(ND) + pi * PAIR_STRIDE;
    const int gi = (int)ldc(pr + P_ART);
    V3<T> P;
    if (art_static<T, ND>(c, pr, c + art_off(ND) + gi * ART_STRIDE,
                          c + static_off(ND) + (int)ldc(pr + P_STATIC) * STATIC_STRIDE,
                          u, L, fp, fq, axw, P, WITH_TORQUE ? &geom_tq[gi] : nullptr))
      geom_imp[gi] = add(geom_imp[gi], P);
  }

  // outputs: qd, impulse rows, then the capped ball state
#pragma unroll
  for (int d = 0; d < ND; ++d) IGT_OUT(ND + d, u[d]);
  const int io = 3 * ND + 9;
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
  IGT_OUT(3 * ND, pos.x);
  IGT_OUT(3 * ND + 1, pos.y);
  IGT_OUT(3 * ND + 2, pos.z);
  IGT_OUT(3 * ND + 3, vel.x);
  IGT_OUT(3 * ND + 4, vel.y);
  IGT_OUT(3 * ND + 5, vel.z);
  IGT_OUT(3 * ND + 6, omg.x);
  IGT_OUT(3 * ND + 7, omg.y);
  IGT_OUT(3 * ND + 8, omg.z);
#undef IGT_IN
#undef IGT_OUT
#undef IGT_DR
}

}  // namespace igt
