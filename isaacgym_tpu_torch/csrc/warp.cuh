// The warp that runs one env, shared by the kernels whose per-env body is a
// sequence of warp phases (K3 and K3-tau, fused_substep_multi.cuh; K4 and
// K4-tau, fused_substep_floating.cuh).
//
// A phase is each() (f(lane) on every lane, then the warp syncs) or one()
// (lane 0 alone). State passes from phase to phase only through the env's
// block of shared memory, so the same body compiles two ways: on the card
// each thread runs its own lane; in the g++ host loop
// (fused_substep_host.cpp) one thread runs the 32 lanes of each phase in
// turn, forward or reversed, and a phase that read what another of its lanes
// writes would show as a difference between the two orders.
#pragma once

#include <math.h>

#include <type_traits>

#include "fused_substep.cuh"

namespace igt {

constexpr int WARP = 32;

// The lanes of the warp that runs one env.
struct Lanes {
  int lane;       // on the card: this thread's lane
  bool reverse;   // on the host: run each phase's lanes 31 .. 0
};

// A phase: f(lane) on every lane, then the warp syncs (on the host, the 32
// lanes one after another).
template <class F>
IGT_HD void each(const Lanes& w, F f) {
#ifdef __CUDA_ARCH__
  f(w.lane);
  __syncwarp();
#else
  for (int i = 0; i < WARP; ++i) f(w.reverse ? WARP - 1 - i : i);
#endif
}

// The warp syncs (on the host, nothing: its lanes run one after another).
IGT_HD void sync(const Lanes&) {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// A phase of lane 0 alone.
template <class F>
IGT_HD void one(const Lanes& w, F f) {
  each(w, [&](int lane) {
    if (lane == 0) f();
  });
}

// The lowest set bit's index (x != 0) and the set bits' count of a word.
IGT_HD int low_bit(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}
IGT_HD int pop_count(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// where row i of a packed lower triangle starts
IGT_HD constexpr int tri(int i) { return i * (i + 1) / 2; }

// The highest of the indices lane, lane + 32, ... below n (-1: none). A
// lane walks its indices down from it: at NV = 33 lane 0 holds 0 and 32, and
// a phase over the rows i > j then runs row 32 in the same pass as the other
// lanes' rows instead of in a second pass of its own.
IGT_HD constexpr int top_index(int lane, int n) {
  return lane >= n ? -1 : lane + WARP * ((n - 1 - lane) / WARP);
}

// The row of entry t of a packed lower triangle (compile-time where t is).
IGT_HD constexpr int tri_row(int t) {
  int r = 0;
  while (tri(r + 1) <= t) ++r;
  return r;
}

// Entry t = tri(k1) + k2 (k2 <= k1) of a packed lower triangle, in closed
// form: a loop per lane would run as long as the lane that needs most.
IGT_HD void tri_entry(int t, int& k1, int& k2) {
  int r = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  r += tri(r + 1) <= t;   // float rounding next to a row's start
  r -= tri(r) > t;
  k1 = r;
  k2 = t - tri(r);
}

// Row j's diagonal, L_jj = sqrt(M_jj - L_j0^2 - ... - L_j(j-1)^2), once the
// Cholesky has subtracted those terms from it, and its reciprocal.
template <class T>
IGT_HD void chol_pivot(T* L, T* dinv, int j) {
  T& Ljj = L[tri(j) + j];
  const T dia = sqrt_floor(Ljj, 1e-12f);
  Ljj = dia;
  dinv[j] = T(1.0f) / dia;
}

// sum_k y_k^2 from the squares, ascending k
template <class T, int NV>
IGT_HD T sum_sq(const T* sq) {
  T s = T(0.0f);
  for (int k = 0; k < NV; ++k) s = s + sq[k];
  return s;
}

// The host's counting float (fused_substep_host.cpp) counts the operations
// a body does; float counts nothing (COUNTS<T>). ops_now(T()) reads the
// count and ops_drop(T(), n) takes n back out of it: a body drops the work of
// a speculative test that a state change throws away, so the count (a
// bound's) is the work the data needs.
template <class T>
constexpr bool COUNTS = !std::is_same<T, float>::value;
IGT_HD long long ops_now(float) { return 0; }
IGT_HD void ops_drop(float, long long) {}

// Two structs in one storage where T allows it (float: on the card the
// dynamics' and the contacts' scratch are one stretch of shared memory), side
// by side where it does not (the host's counting float).
template <class A, class B, bool SHARE>
struct Overlay {
  A dyn;
  B ct;
};
template <class A, class B>
struct Overlay<A, B, true> {
  union {
    A dyn;
    B ct;
  };
};

}  // namespace igt
