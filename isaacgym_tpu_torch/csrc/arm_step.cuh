// K1, the arm step: one substep of fixed-base dynamics for one articulation,
// the per-env body.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:447 (build_arm_step,
// pallas_call at :693). It is exactly K2's dynamics half, so it is K2's
// art_dynamics phase (fused_substep.cuh): PD drive with the effort clamp ->
// FK -> world inertias -> mass matrix with the static ancestor masks -> RNEA
// bias at qdd = 0 -> Cholesky -> semi-implicit Euler with the velocity clamp
// and the joint limits -> FK at the new q. What K1 adds is what it hands the
// non-kernel contact phase: the joint velocities before any contact, the
// post-step DOF frames (taken after the limit clamp) and the packed lower
// Cholesky factor, row by row (L[i][j], j <= i, at i (i + 1) / 2 + j), the
// order of ops/arm_step.py's unpack_chol, through which the contact phase
// solves with it.
//
// The Pallas kernel folds the base pose in as a constant; here it is an
// input, per env (rows 4 ND .. 4 ND + 6 of x: position, then the xyzw
// quaternion), so the constant pack (K2's header, DOF table and ancestor
// mask, ops/arm_step.py) serves any base pose.
//
// Buffers are channel-major (channel, B) float32. x: q, qd, targets, efforts
// (ND rows each), base position (3), base quaternion (4). y: q_new, qd_new,
// tau (ND rows each), frame positions (3 ND rows, d-major), frame
// quaternions (4 ND rows), the factor (ND (ND + 1) / 2 rows).
//
// What bounds it on an H100: one thread per env, ~5,000 dependent FP32
// operations each (the host loop counts them), ~300 bytes in and out; at
// B = 4096 one warp per SM, so it is latency-bound, as K2 is.
#pragma once

#include "fused_substep.cuh"

namespace igt {

IGT_HD constexpr int arm_n_in(int nd) { return 4 * nd + 7; }
IGT_HD constexpr int arm_n_out(int nd) { return 10 * nd + nd * (nd + 1) / 2; }

template <class T, int ND>
IGT_HD void arm_step_env(const float* __restrict__ c, const float* __restrict__ x,
                         float* __restrict__ y, int b, int B) {
  const size_t sB = (size_t)B;
#define IGT_X(ch) T(x[(size_t)(ch) * sB + b])
#define IGT_Y(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  const V3<T> bp = v3<T>(IGT_X(4 * ND), IGT_X(4 * ND + 1), IGT_X(4 * ND + 2));
  Q4<T> bq;
  bq.x = IGT_X(4 * ND + 3); bq.y = IGT_X(4 * ND + 4);
  bq.z = IGT_X(4 * ND + 5); bq.w = IGT_X(4 * ND + 6);
  T L[ND * (ND + 1) / 2], u[ND];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
  art_dynamics<T, ND, false>(c, x, y, b, sB, 0, ND, nullptr, L, u, fp, fq, axw, bp, bq);
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    IGT_Y(ND + d, u[d]);
    IGT_Y(3 * ND + 3 * d, fp[d].x);
    IGT_Y(3 * ND + 3 * d + 1, fp[d].y);
    IGT_Y(3 * ND + 3 * d + 2, fp[d].z);
    IGT_Y(6 * ND + 4 * d, fq[d].x);
    IGT_Y(6 * ND + 4 * d + 1, fq[d].y);
    IGT_Y(6 * ND + 4 * d + 2, fq[d].z);
    IGT_Y(6 * ND + 4 * d + 3, fq[d].w);
  }
#pragma unroll
  for (int t = 0; t < ND * (ND + 1) / 2; ++t) IGT_Y(10 * ND + t, L[t]);
#undef IGT_X
#undef IGT_Y
}

}  // namespace igt
