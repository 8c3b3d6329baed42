// K2's constant pack and the scalar, geometry and ball helpers that every
// kernel's per-env body uses (K1, arm_step.cuh; K2, K2-dr, K2-tau and
// K2-dr-tau, fused_substep_warp.cuh; K3, fused_substep_multi.cuh; K4,
// fused_substep_floating.cuh).
//
// Each body is compiled two ways: inside the __global__ wrapper of its .cu
// (nvcc, sm_90a) and inside the host loop of fused_substep_host.cpp (g++),
// which the CPU tests hold against the plain PyTorch versions and which
// counts the operations this data needs. ``T`` is float in both kernels; the
// host counter instantiates it with a counting type.
//
// Scene constants are read at run time from one float32 buffer (layout
// below, mirrored by isaacgym_tpu_torch/ops/fused_substep.py); K1's pack is
// its header, DOF table and ancestor mask, and K3's and K4's blocks keep its
// slots.
//
// K2-tau (WITH_TORQUE) also writes the force sensors' moment rows after the
// impulse rows: each articulated geom body's contact moment about its frame
// origin (the lever from the body origin, the A_BODY_OFF slots, to the
// contact point; ball contacts and art-vs-static contacts alike), then the
// ball's contact moment about its centre (lever -r n). Built only for scenes
// that register a sensor.
//
// K2-dr reads a per-env domain-randomization channel of n_dr(ND) = 4 ND + 6
// rows appended to the packed input, in the JAX package's order (kp scale,
// kd scale, lower shift, upper shift per DOF, then mass scale, gravity
// offset xyz, friction scale, restitution scale). Each value is read where it
// is used, with __ldg on its env's row.
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

// ---------------------------------------------------- the factor, columns --
// y = L^-1 b for the packed lower factor L (row i at i (i + 1) / 2), each
// row's sum in ascending j.
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

// x = L^-T y, each row's sum in ascending j from the diagonal.
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

// ------------------------------------------------------- the ball phases --
// Each works on one ball's constant block: K2's whole pack, or one of K3's
// ball blocks, which keep K2's slots (fused_substep_multi.cuh).

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

// The ball's velocity caps (PhysX caps the magnitude) and position update.
template <class T>
IGT_HD void ball_finish(const float* cb, V3<T>& pos, V3<T>& vel, V3<T>& omg) {
  vel = scale(vel, min_(T(ldc(cb + C_MAX_LIN)) / sqrt_floor(dot(vel, vel), 1e-18f), T(1.0f)));
  omg = scale(omg, min_(T(ldc(cb + C_MAX_ANG)) / sqrt_floor(dot(omg, omg), 1e-18f), T(1.0f)));
  const T dt = T(ldc(cb + C_DT));
  pos = v3<T>(pos.x + vel.x * dt, pos.y + vel.y * dt, pos.z + vel.z * dt);
}

}  // namespace igt
