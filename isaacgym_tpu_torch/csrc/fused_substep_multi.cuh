// K3, the fused physics substep of K fixed-base articulations and NB balls
// (the two-humanoid C8 scene): the per-env body.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:1477 (build_fused_substep_multi;
// K3 with with_torque=False, K3-tau with with_torque=True, the compile-time
// WITH_TORQUE), in its order: each articulation's dynamics (PD or
// effort drive, FK, mass matrix, RNEA bias, Cholesky, integration, FK at the
// new q); then per ball its free flight, the plane, every static geom and
// every articulated geom of every articulation, each reaction going into
// that articulation's DOF block through its own factor; the ball pair; the
// balls' caps and integration; then every articulated geom against the true
// statics. Each phase is the K2 function of fused_substep.cuh applied to the
// articulation's or the ball's own block of the constant pack, so K2 and K3
// share their arithmetic.
//
// Pack layout (mirrored by isaacgym_tpu_torch/ops/fused_substep_multi.py,
// which checks it against igt_multi_layout): a HEAD-slot header (K2's scene
// slots plus H_*), K articulation blocks each laid out as K2's pack up to its
// static list (header with base pose, drive mode and its geoms' and pairs'
// ranges, DOF table, mask), MAX_BALLS ball blocks each a K2 header with that
// ball's slots, then the static geoms, the articulated geoms (grouped by
// articulation) and the art-vs-static pairs. Static and articulated entries
// carry the material combined with each ball; articulated entries keep K2's
// slots, the body origin (A_BODY_OFF) included.
//
// K3-tau writes, after K3's impulse rows, each articulated geom body's
// contact moment about its frame origin and each ball's about its centre:
// (B, 2 ng + 3 NB, 3) impulse rows in all. A ball-pair contact gives each
// ball -r_i (n x P), as the JAX package's ball-pair block takes it.
//
// ND (DOFs per articulation), K and NB are template parameters, so each
// articulation's factor, velocities and frames are arrays with compile-time
// indices. What bounds it on an H100: like K2, latency. One thread per env
// does K times K2's dynamics and NB times its contact phase, dependent FP32
// work of tens of thousands of operations, and reads and writes ~500 bytes;
// at 4096 envs that is one warp per SM. Two articulations' post-step frames,
// factors and velocities are live through the contact phase, more than 255
// registers hold, so ptxas spills; the spill traffic stays in L1. Making it
// fast (arts across lanes, more envs per SM) is work for later PRs.
#pragma once

#include "fused_substep.cuh"

namespace igt {

constexpr int MULTI_HEAD = 64;
constexpr int MAX_BALLS = 2;
constexpr int MULTI_MAX_STATIC = 24;
constexpr int MULTI_MAX_ART = 16;
constexpr int MULTI_MAX_PAIRS = 32;
// scene-wide header slots past K2's
enum : int { H_K = 40, H_NB = 41, H_BB_E = 42, H_BB_MU = 43, H_BB_WN = 44, H_BB_WT = 45,
             H_BB_T = 46 };
// articulation block slots past K2's
enum : int { C_GEOM_LO = 40, C_GEOM_HI = 41, C_PAIR_LO = 42, C_PAIR_HI = 43 };
constexpr int BALL_STRIDE = 48;
constexpr int MULTI_STATIC_STRIDE = 24;
constexpr int MULTI_ART_STRIDE = 28;
// per-ball materials (+ 2 bi) past K2's entry slots; the entry's articulation
enum : int { G_EB = 20, G_MUB = 21, A_EB = 20, A_MUB = 21, A_ART = 24 };

IGT_HD constexpr int multi_art_stride(int nd) { return static_off(nd); }
IGT_HD constexpr int multi_ball_off(int nd, int k) { return MULTI_HEAD + k * multi_art_stride(nd); }
IGT_HD constexpr int multi_static_off(int nd, int k) { return multi_ball_off(nd, k) + MAX_BALLS * BALL_STRIDE; }
IGT_HD constexpr int multi_art_off(int nd, int k) {
  return multi_static_off(nd, k) + MULTI_MAX_STATIC * MULTI_STATIC_STRIDE;
}
IGT_HD constexpr int multi_pair_off(int nd, int k) {
  return multi_art_off(nd, k) + MULTI_MAX_ART * MULTI_ART_STRIDE;
}
IGT_HD constexpr int multi_total(int nd, int k) { return multi_pair_off(nd, k) + MULTI_MAX_PAIRS * PAIR_STRIDE; }
IGT_HD constexpr int multi_n_in(int nd_tot, int nb) { return 4 * nd_tot + 9 * nb; }

// Fills ``out`` with the layout, in the order of fused_substep_multi.py's
// _LAYOUT_KEYS, so the Python side can check it.
inline int fill_multi_layout(int nd, int k, int* out, int n) {
  if (n < 21 || nd < 1 || k < 1) return 1;
  const int v[21] = {MULTI_HEAD, multi_art_stride(nd), multi_ball_off(nd, k), BALL_STRIDE,
                     multi_static_off(nd, k), MULTI_STATIC_STRIDE, multi_art_off(nd, k),
                     MULTI_ART_STRIDE, multi_pair_off(nd, k), multi_total(nd, k), MAX_BALLS,
                     MULTI_MAX_STATIC, MULTI_MAX_ART, MULTI_MAX_PAIRS, H_K, H_BB_T, C_DRIVE,
                     C_GEOM_LO, G_EB, A_ART, A_EB};
  for (int i = 0; i < 21; ++i) out[i] = v[i];
  return 0;
}

// The two balls' swept sphere-sphere impulse with spin; s_imp gathers it
// into each ball's static row, and with ``tqa`` each ball's moment -r (n x P)
// is added to tqa and tqb.
template <class T>
IGT_HD void ball_pair(const float* c, const float* ca, const float* cb, V3<T>& pa, V3<T>& va,
                      V3<T>& wa, V3<T>& sa, V3<T>& pb, V3<T>& vb, V3<T>& wb, V3<T>& sb,
                      V3<T>* tqa = nullptr, V3<T>* tqb = nullptr) {
  V3<T> d = sub(pa, pb);
  T dn = sqrt_floor(dot(d, d), 1e-18f);
  V3<T> n = scale(d, T(1.0f) / dn);
  V3<T> v_rel = sub(va, vb);
  T dist = dn;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    V3<T> dk = add(d, scale(v_rel, T(ldc(c + H_BB_T + kk))));
    dist = min_(dist, sqrt_floor(dot(dk, dk), 1e-18f));
  }
  const T ra = T(ldc(ca + C_RB)), rb = T(ldc(cb + C_RB));
  T dist_now = dn - ra - rb;
  dist = dist - ra - rb;
  T vn = dot(v_rel, n);
  if (!((dist < T(0.0f)) && (vn < T(0.0f)))) return;   // inactive: no impulse
  T e_eff = sel(abs_(vn) > T(ldc(c + C_BOUNCE)), T(ldc(c + H_BB_E)), T(0.0f));
  T Pn = -(T(1.0f) + e_eff) * vn / T(ldc(c + H_BB_WN));
  V3<T> slip = v_rel;
  if (ldc(ca + C_KAPPA) > 0.0f || ldc(cb + C_KAPPA) > 0.0f) {
    const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    V3<T> spa = ldc(ca + C_KAPPA) > 0.0f ? scale(cross(wa, n), ra) : zero3;
    V3<T> spb = ldc(cb + C_KAPPA) > 0.0f ? scale(cross(wb, n), rb) : zero3;
    slip = sub(v_rel, add(spa, spb));
  }
  V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
  T Pt = min_(T(ldc(c + H_BB_MU)) * Pn, vt_n / T(ldc(c + H_BB_WT)));
  V3<T> P = sub(scale(n, Pn), scale(t_hat, Pt));
  V3<T> dwdir = cross(n, t_hat);
  va = add(va, scale(P, T(ldc(ca + C_INV_MB))));
  vb = sub(vb, scale(P, T(ldc(cb + C_INV_MB))));
  wa = add(wa, scale(dwdir, T(ldc(ca + C_KAPPA_INVMB_OVER_RB)) * Pt));
  wb = add(wb, scale(dwdir, T(ldc(cb + C_KAPPA_INVMB_OVER_RB)) * Pt));
  T push = max_(-dist_now, T(0.0f));
  pa = add(pa, scale(n, T(0.5f) * push));
  pb = sub(pb, scale(n, T(0.5f) * push));
  sa = add(sa, P);
  sb = sub(sb, P);
  if (tqa) {
    V3<T> nxP = cross(n, P);
    *tqa = sub(*tqa, scale(nxP, ra));
    *tqb = sub(*tqb, scale(nxP, rb));
  }
}

// One env's K3 substep. x: (multi_n_in(K ND, NB), B) inputs, y: (3 K ND +
// 9 NB + 3 (ng + 2 NB) [+ 3 (ng + NB) with WITH_TORQUE], B) outputs, both
// channel-major; env b reads and writes column b.
template <class T, int ND, int K, int NB, bool WITH_TORQUE = false>
IGT_HD void fused_substep_multi_env(const float* __restrict__ c, const float* __restrict__ x,
                                    float* __restrict__ y, int b, int B) {
  static_assert(NB >= 1 && NB <= MAX_BALLS, "1 or 2 balls");
  constexpr int NDT = K * ND;
  const size_t sB = (size_t)B;
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
#define IGT_ART(a) (c + MULTI_HEAD + (a) * multi_art_stride(ND))

  T L[K][ND * (ND + 1) / 2], u[K][ND];
  V3<T> fp[K][ND], axw[K][ND];
  Q4<T> fq[K][ND];
#pragma unroll
  for (int a = 0; a < K; ++a)
    art_dynamics<T, ND, false>(IGT_ART(a), x, y, b, sB, a * ND, NDT, nullptr, L[a], u[a],
                               fp[a], fq[a], axw[a]);

  const int n_static = (int)ldc(c + C_NSTATIC);
  const int ng = (int)ldc(c + C_NART);
  V3<T> geom_imp[MULTI_MAX_ART];
  // WITH_TORQUE: each geom body's contact moment and each ball's
  V3<T> geom_tq[WITH_TORQUE ? MULTI_MAX_ART : 1], b_tq[NB];
  for (int gi = 0; gi < ng; ++gi) {
    geom_imp[gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    if constexpr (WITH_TORQUE) geom_tq[gi] = geom_imp[gi];
  }
  V3<T> pos[NB], vel[NB], omg[NB], s_imp[NB];
  const int ib = 4 * NDT;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
    const T inv_mb = T(ldc(cb + C_INV_MB));
    pos[bi] = v3<T>(IGT_IN(ib + 3 * bi), IGT_IN(ib + 3 * bi + 1), IGT_IN(ib + 3 * bi + 2));
    vel[bi] = v3<T>(IGT_IN(ib + 3 * NB + 3 * bi), IGT_IN(ib + 3 * NB + 3 * bi + 1),
                    IGT_IN(ib + 3 * NB + 3 * bi + 2));
    omg[bi] = v3<T>(IGT_IN(ib + 6 * NB + 3 * bi), IGT_IN(ib + 6 * NB + 3 * bi + 1),
                    IGT_IN(ib + 6 * NB + 3 * bi + 2));
    ball_flight(cb, T(ldc(cb + C_GX)), T(ldc(cb + C_GY)), T(ldc(cb + C_GZ)), vel[bi], omg[bi]);
    V3<T> dv0 = ball_plane(cb, pos[bi], vel[bi], omg[bi]);
    s_imp[bi] = scale(dv0, T(ldc(cb + C_MB)));
    if constexpr (WITH_TORQUE)
      b_tq[bi] = static_moment(cb, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);
    for (int si = 0; si < n_static; ++si) {
      const float* g = c + multi_static_off(ND, K) + si * MULTI_STATIC_STRIDE;
      V3<T> dv = ball_static(cb, g, T(ldc(g + G_EB + 2 * bi)), T(ldc(g + G_MUB + 2 * bi)),
                             pos[bi], vel[bi], omg[bi], WITH_TORQUE ? &b_tq[bi] : nullptr);
      s_imp[bi] = v3<T>(s_imp[bi].x + dv.x / inv_mb, s_imp[bi].y + dv.y / inv_mb,
                        s_imp[bi].z + dv.z / inv_mb);
    }
    V3<T> b_art = v3<T>(T(0.0f), T(0.0f), T(0.0f));
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float* ca = IGT_ART(a);
      const int hi = (int)ldc(ca + C_GEOM_HI);
      for (int gi = (int)ldc(ca + C_GEOM_LO); gi < hi; ++gi) {
        const float* g = c + multi_art_off(ND, K) + gi * MULTI_ART_STRIDE;
        V3<T> P;
        if (!ball_art<T, ND, false>(ca, cb, g, A_EB + 2 * bi, A_MUB + 2 * bi, nullptr, sB,
                                    pos[bi], vel[bi], omg[bi], u[a], L[a], fp[a], fq[a],
                                    axw[a], P, WITH_TORQUE ? &b_tq[bi] : nullptr,
                                    WITH_TORQUE ? &geom_tq[gi] : nullptr))
          continue;
        geom_imp[gi] = sub(geom_imp[gi], P);
        b_art = add(b_art, P);
      }
    }
    const int row = 3 * NDT + 9 * NB + 3 * (ng + NB + bi);
    IGT_OUT(row, b_art.x);
    IGT_OUT(row + 1, b_art.y);
    IGT_OUT(row + 2, b_art.z);
  }

  if constexpr (NB == 2) {
    const float* c0 = c + multi_ball_off(ND, K);
    ball_pair(c, c0, c0 + BALL_STRIDE, pos[0], vel[0], omg[0], s_imp[0], pos[1], vel[1],
              omg[1], s_imp[1], WITH_TORQUE ? &b_tq[0] : nullptr,
              WITH_TORQUE ? &b_tq[1] : nullptr);
  }

#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    ball_finish(c + multi_ball_off(ND, K) + bi * BALL_STRIDE, pos[bi], vel[bi], omg[bi]);
    const int o = 3 * NDT + 3 * bi;
    IGT_OUT(o, pos[bi].x);
    IGT_OUT(o + 1, pos[bi].y);
    IGT_OUT(o + 2, pos[bi].z);
    IGT_OUT(o + 3 * NB, vel[bi].x);
    IGT_OUT(o + 3 * NB + 1, vel[bi].y);
    IGT_OUT(o + 3 * NB + 2, vel[bi].z);
    IGT_OUT(o + 6 * NB, omg[bi].x);
    IGT_OUT(o + 6 * NB + 1, omg[bi].y);
    IGT_OUT(o + 6 * NB + 2, omg[bi].z);
    const int row = 3 * NDT + 9 * NB + 3 * (ng + bi);
    IGT_OUT(row, s_imp[bi].x);
    IGT_OUT(row + 1, s_imp[bi].y);
    IGT_OUT(row + 2, s_imp[bi].z);
    if constexpr (WITH_TORQUE) {   // ball moment rows after the geom moment rows
      const int rt = 3 * NDT + 9 * NB + 3 * (2 * ng + 2 * NB + bi);
      IGT_OUT(rt, b_tq[bi].x);
      IGT_OUT(rt + 1, b_tq[bi].y);
      IGT_OUT(rt + 2, b_tq[bi].z);
    }
  }

  // articulated geoms vs the true statics: pairs pruned at pack time
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const float* ca = IGT_ART(a);
    const int hi = (int)ldc(ca + C_PAIR_HI);
    for (int pi = (int)ldc(ca + C_PAIR_LO); pi < hi; ++pi) {
      const float* pr = c + multi_pair_off(ND, K) + pi * PAIR_STRIDE;
      const int gi = (int)ldc(pr + P_ART);
      V3<T> P;
      if (art_static<T, ND>(ca, pr, c + multi_art_off(ND, K) + gi * MULTI_ART_STRIDE,
                            c + multi_static_off(ND, K) + (int)ldc(pr + P_STATIC) * MULTI_STATIC_STRIDE,
                            u[a], L[a], fp[a], fq[a], axw[a], P,
                            WITH_TORQUE ? &geom_tq[gi] : nullptr))
        geom_imp[gi] = add(geom_imp[gi], P);
    }
  }

  const int io = 3 * NDT + 9 * NB;
  for (int gi = 0; gi < ng; ++gi) {
    IGT_OUT(io + 3 * gi, geom_imp[gi].x);
    IGT_OUT(io + 3 * gi + 1, geom_imp[gi].y);
    IGT_OUT(io + 3 * gi + 2, geom_imp[gi].z);
    if constexpr (WITH_TORQUE) {
      const int rt = io + 3 * (ng + 2 * NB + gi);
      IGT_OUT(rt, geom_tq[gi].x);
      IGT_OUT(rt + 1, geom_tq[gi].y);
      IGT_OUT(rt + 2, geom_tq[gi].z);
    }
  }
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int d = 0; d < ND; ++d) IGT_OUT(NDT + a * ND + d, u[a][d]);
#undef IGT_IN
#undef IGT_OUT
#undef IGT_ART
}

}  // namespace igt
