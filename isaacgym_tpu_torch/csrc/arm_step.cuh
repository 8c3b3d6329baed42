// K1, the arm step: one substep of fixed-base dynamics for one articulation,
// the per-env body, four envs to a warp.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:447 (build_arm_step,
// pallas_call at :693). It is exactly K2's dynamics half, so it is
// art_warp.cuh's arms_dynamics with the arms as envs: PD drive with the
// effort clamp -> FK -> world inertias -> mass matrix with the static
// ancestor masks -> RNEA bias at qdd = 0 -> Cholesky -> semi-implicit Euler
// with the velocity clamp and the joint limits -> FK at the new q. What K1
// adds is what it hands the non-kernel contact phase: the joint velocities
// before any contact, the post-step DOF frames (taken after the limit clamp)
// and the packed lower Cholesky factor, row by row (L[i][j], j <= i, at
// i (i + 1) / 2 + j), the order of ops/arm_step.py's unpack_chol, through
// which the contact phase solves with it.
//
// The Pallas kernel folds the base pose in as a constant; here it is an
// input, per env (rows 4 ND .. 4 ND + 6 of x: position, then the xyzw
// quaternion; EnvCols with BASE_IN_X), so the constant pack (K2's header,
// DOF table and ancestor mask, ops/arm_step.py) serves any base pose.
//
// Buffers are channel-major (channel, B) float32. x: q, qd, targets, efforts
// (ND rows each), base position (3), base quaternion (4). y: q_new, qd_new,
// tau (ND rows each), frame positions (3 ND rows, d-major), frame
// quaternions (4 ND rows), the factor (ND (ND + 1) / 2 rows).
//
// Env b0 + a runs on lanes 8 a .. 8 a + 7 of the warp (EnvCols, K1_ENVS =
// 4): K1 has no contact phase, so the envs of a warp never need different
// phases, and a phase on one lane per env (the FK walks, the factor) issues
// once for four envs. Four envs of eight lanes ran 6-8 % faster than two of
// sixteen on the card (PERF.md). Every value is formed by the operations of
// the one-thread-per-env body this design replaced, in the same order, so
// the outputs are the same bits.
#pragma once

#include "art_warp.cuh"
#include "fused_substep.cuh"
#include "warp.cuh"

namespace igt {

constexpr int K1_ENVS = 4;   // envs per warp

IGT_HD constexpr int arm_n_in(int nd) { return 4 * nd + 7; }
IGT_HD constexpr int arm_n_out(int nd) { return 10 * nd + nd * (nd + 1) / 2; }

// A warp's block: each env's arm state and the dynamics' scratch.
template <class T, int ND, int G>
struct ArmStepShared {
  ArmState<T, ND> arm[G];
  struct {
    ArmsDyn<T, ND, G> dyn;
  } s;
};

// Envs b0 .. b0 + G - 1 of K1 (those below B), run by the warp ``w`` with the
// warp's block ``sh``. x: (arm_n_in(ND), B), y: (arm_n_out(ND), B).
template <class T, int ND, int G = K1_ENVS>
IGT_HD void arm_step_warp(const float* __restrict__ c, const float* __restrict__ x,
                          float* __restrict__ y, int b0, int B, ArmStepShared<T, ND, G>& sh,
                          const Lanes& w) {
  constexpr int HW = WARP / G;
  const EnvCols<ND, G, true> io{x, y, b0, B, (size_t)B, 0};
  arms_dynamics<T, ND, G, false, true>([c](int) { return c; }, io, sh, w);
  // outputs: u, the post-step frames, the packed factor, one lane per channel
  each_arm<G>(w, [=, &sh](int a, int s) {
    const auto& ar = sh.arm[a];
    for (int d = s; d < ND; d += HW) {
      io.put(ND + d, a, ar.u[d]);
      io.put(3 * ND + 3 * d, a, ar.fp[d].x);
      io.put(3 * ND + 3 * d + 1, a, ar.fp[d].y);
      io.put(3 * ND + 3 * d + 2, a, ar.fp[d].z);
      io.put(6 * ND + 4 * d, a, ar.fq[d].x);
      io.put(6 * ND + 4 * d + 1, a, ar.fq[d].y);
      io.put(6 * ND + 4 * d + 2, a, ar.fq[d].z);
      io.put(6 * ND + 4 * d + 3, a, ar.fq[d].w);
    }
    for (int t = s; t < tri(ND); t += HW) io.put(10 * ND + t, a, ar.L[t]);
  });
}

}  // namespace igt
