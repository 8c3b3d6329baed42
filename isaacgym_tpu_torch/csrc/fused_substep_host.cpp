// Host loops over the kernels' per-env bodies (arm_step.cuh for K1,
// fused_substep_warp.cuh for K2, K2-dr, K2-tau and K2-dr-tau,
// fused_substep_multi.cuh for K3 and K3-tau, fused_substep_floating.cuh for
// K4 and K4-tau), for the CPU tests and for counting the operations the
// kernels do on given inputs. Each warp's 32 lanes run every phase one after
// another (warp.cuh), in order or reversed. Never on the main path.
//
//   g++ -std=c++17 -O2 -shared -fPIC -I csrc -o libigt_host.so csrc/fused_substep_host.cpp
//
// or, as ops/_build.py builds it, one object for each kernel family compiled
// side by side (-c -DIGT_HOST_PART=1 for K1, 2 for K2's builds, 3 for K3's,
// 4 for K4's, 5 for K3-tau's, 6 for K3's reversed lanes; 0, the default, is
// all of them) and linked into the one library.
#include <cmath>
#include <cstring>

namespace igt {

// A float that counts every arithmetic operation, comparison and math call
// applied to it (unary minus and copies are free). Single-threaded use only.
// One counter for the whole library (an inline variable): the operators are
// inline functions that every part's object shares.
inline long long g_ops = 0;

struct CountF {
  float v;
  CountF() : v(0.0f) {}
  CountF(float a) : v(a) {}  // NOLINT: implicit, so constants mix in
};
inline CountF operator+(CountF a, CountF b) { ++g_ops; return CountF(a.v + b.v); }
inline CountF operator-(CountF a, CountF b) { ++g_ops; return CountF(a.v - b.v); }
inline CountF operator*(CountF a, CountF b) { ++g_ops; return CountF(a.v * b.v); }
inline CountF operator/(CountF a, CountF b) { ++g_ops; return CountF(a.v / b.v); }
inline CountF operator-(CountF a) { return CountF(-a.v); }
inline bool operator<(CountF a, CountF b) { ++g_ops; return a.v < b.v; }
inline bool operator>(CountF a, CountF b) { ++g_ops; return a.v > b.v; }
inline bool operator<=(CountF a, CountF b) { ++g_ops; return a.v <= b.v; }
inline bool operator>=(CountF a, CountF b) { ++g_ops; return a.v >= b.v; }
inline CountF sqrt_(CountF a) { ++g_ops; return CountF(std::sqrt(a.v)); }
inline CountF sin_(CountF a) { ++g_ops; return CountF(std::sin(a.v)); }
inline CountF cos_(CountF a) { ++g_ops; return CountF(std::cos(a.v)); }
inline CountF abs_(CountF a) { ++g_ops; return CountF(std::fabs(a.v)); }
inline CountF min_(CountF a, CountF b) { ++g_ops; return a.v < b.v ? a : b; }
inline CountF max_(CountF a, CountF b) { ++g_ops; return a.v > b.v ? a : b; }
inline float to_f(CountF a) { return a.v; }
inline long long ops_now(CountF) { return g_ops; }
inline void ops_drop(CountF, long long n) { g_ops -= n; }

}  // namespace igt

#include "arm_step.cuh"
#include "fused_substep_floating.cuh"
#include "fused_substep_multi.cuh"
#include "fused_substep_warp.cuh"

namespace {

// Takes back out of the count the work of a last warp's groups past the last
// env: they run env B - 1 again (EnvCols). ``warp(b)`` runs the warp from env
// b; from B - 1 every one of its G groups runs env B - 1, so a G-th of that
// warp's count is one group's.
template <class Warp>
void drop_idle_groups(int b0, int G, int B, Warp warp) {
  const int idle = b0 + G - B;
  if (idle <= 0) return;
  const long long o = igt::g_ops;
  warp(B - 1);
  igt::g_ops = o - (igt::g_ops - o) / G * idle;
}

// K2 (K2-dr, K2-tau, K2-dr-tau) over every warp of two envs, in float or with
// the counting float (nd 7), the warp's 32 lanes of each phase in turn
// (``reverse``: 31 .. 0). Each warp's block starts as 0xff bytes (a NaN in
// every float), so a value read before it is written shows. Returns 0 (or
// the operation count), or -1 on another DOF count.
template <class T, bool WITH_DR, bool WITH_TORQUE = false>
long long run_k2(const float* consts, const float* x, float* y, int B, int nd,
                 bool reverse = false) {
  if (nd != 7 || B < 1) return -1;
  igt::g_ops = 0;
  igt::K2Shared<T, 7, WITH_TORQUE> sh;
  const auto warp = [&](int b0) {
    std::memset(static_cast<void*>(&sh), 0xff, sizeof sh);
    igt::fused_substep_warp<T, 7, WITH_DR, WITH_TORQUE>(consts, x, y, b0, B, sh,
                                                         igt::Lanes{0, reverse});
  };
  for (int b0 = 0; b0 < B; b0 += igt::K2_ENVS) {
    warp(b0);
    drop_idle_groups(b0, igt::K2_ENVS, B, warp);
  }
  return igt::g_ops;
}

template <class T>
long long run_k2_flags(const float* consts, const float* x, float* y, int B, int nd,
                       int with_dr, int with_torque, bool reverse = false) {
  if (with_torque)
    return with_dr ? run_k2<T, true, true>(consts, x, y, B, nd, reverse)
                   : run_k2<T, false, true>(consts, x, y, B, nd, reverse);
  return with_dr ? run_k2<T, true>(consts, x, y, B, nd, reverse)
                 : run_k2<T, false>(consts, x, y, B, nd, reverse);
}

// K3 (K3-tau) over every env, in float or with the counting float; the
// shapes the CUDA library is built for, the warp's 32 lanes of each phase in
// turn (``reverse``: 31 .. 0). Each env's block starts as 0xff bytes (a NaN
// in every float), so a value read before it is written shows. Returns 0 (or
// the operation count), or -1 on another shape.
template <class T, bool WITH_TORQUE, int ND, int K, int NB>
void multi_envs(const float* consts, const float* x, float* y, int B, bool reverse) {
  igt::MultiShared<T, ND, K, NB, WITH_TORQUE> sh;
  for (int b = 0; b < B; ++b) {
    std::memset(static_cast<void*>(&sh), 0xff, sizeof sh);
    igt::fused_substep_multi_env<T, ND, K, NB, WITH_TORQUE>(consts, x, y, b, B, sh,
                                                            igt::Lanes{0, reverse});
  }
}

template <class T, bool WITH_TORQUE = false>
long long run_multi(const float* consts, const float* x, float* y, int B, int nd, int k,
                    int nb, bool reverse = false) {
  if (B < 1) return -1;
  igt::g_ops = 0;
  if (nd == 7 && k == 2 && nb == 1) {
    multi_envs<T, WITH_TORQUE, 7, 2, 1>(consts, x, y, B, reverse);
  } else if (nd == 3 && k == 2 && nb == 2) {
    multi_envs<T, WITH_TORQUE, 3, 2, 2>(consts, x, y, B, reverse);
  } else if (nd == 26 && k == 2 && nb == 2) {
    multi_envs<T, WITH_TORQUE, 26, 2, 2>(consts, x, y, B, reverse);
  } else {
    return -1;
  }
  return igt::g_ops;
}

// K4 (K4-tau) over every env, in float or with the counting float: ND 27
// (C10) and 4 (the CPU tests' toy biped), the warp's 32 lanes of each phase
// in turn (``reverse``: 31 .. 0). Each env's block starts as 0xff bytes (a
// NaN in every float), so a value read before it is written shows. Returns 0
// (or the operation count), or -1 on another DOF count.
template <class T, bool WITH_TORQUE, int ND>
void floating_envs(const float* consts, const float* x, float* y, int B, bool reverse) {
  igt::FloatShared<T, ND, WITH_TORQUE> sh;
  for (int b = 0; b < B; ++b) {
    std::memset(static_cast<void*>(&sh), 0xff, sizeof sh);
    igt::fused_substep_floating_env<T, ND, WITH_TORQUE>(consts, x, y, b, B, sh,
                                                        igt::Lanes{0, reverse});
  }
}

template <class T, bool WITH_TORQUE = false>
long long run_floating(const float* consts, const float* x, float* y, int B, int nd,
                       bool reverse = false) {
  if (B < 1) return -1;
  igt::g_ops = 0;
  if (nd == 27) {
    floating_envs<T, WITH_TORQUE, 27>(consts, x, y, B, reverse);
  } else if (nd == 4) {
    floating_envs<T, WITH_TORQUE, 4>(consts, x, y, B, reverse);
  } else {
    return -1;
  }
  return igt::g_ops;
}

// K1 over every warp of K1_ENVS envs, in float or with the counting float
// (nd 7), the lanes of each phase in turn (``reverse``: 31 .. 0), each warp's
// block starting as 0xff bytes. Returns 0 (or the operation count), or -1 on
// another DOF count.
template <class T>
long long run_arm(const float* consts, const float* x, float* y, int B, int nd,
                  bool reverse = false) {
  if (nd != 7 || B < 1) return -1;
  igt::g_ops = 0;
  igt::ArmStepShared<T, 7, igt::K1_ENVS> sh;
  const auto warp = [&](int b0) {
    std::memset(static_cast<void*>(&sh), 0xff, sizeof sh);
    igt::arm_step_warp<T, 7>(consts, x, y, b0, B, sh, igt::Lanes{0, reverse});
  };
  for (int b0 = 0; b0 < B; b0 += igt::K1_ENVS) {
    warp(b0);
    drop_idle_groups(b0, igt::K1_ENVS, B, warp);
  }
  return igt::g_ops;
}

}  // namespace

#ifndef IGT_HOST_PART
#define IGT_HOST_PART 0
#endif
#define IGT_PART(n) (IGT_HOST_PART == 0 || IGT_HOST_PART == (n))

#if IGT_PART(1)
// K1: x is (arm_n_in(7), B), y is (arm_n_out(7), B)
extern "C" int igt_arm_step_host(const float* consts, const float* x, float* y, int B, int nd) {
  return run_arm<float>(consts, x, y, B, nd) == 0 ? 0 : 1;
}

extern "C" long long igt_arm_step_count_ops(const float* consts, const float* x, float* y,
                                            int B, int nd) {
  return run_arm<igt::CountF>(consts, x, y, B, nd);
}

// K1 in float with the lanes of every phase run in reverse order, 31 .. 0
extern "C" int igt_arm_step_reversed_host(const float* consts, const float* x, float* y, int B,
                                          int nd) {
  return run_arm<float>(consts, x, y, B, nd, true) == 0 ? 0 : 1;
}

#endif  // K1

#if IGT_PART(2)
// K2: x is (n_in(7), B)
extern "C" int igt_fused_substep_host(const float* consts, const float* x, float* y,
                                      int B, int nd) {
  return run_k2_flags<float>(consts, x, y, B, nd, 0, 0) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_count_ops(const float* consts, const float* x,
                                                 float* y, int B, int nd) {
  return run_k2_flags<igt::CountF>(consts, x, y, B, nd, 0, 0);
}

// K2-dr: x is (n_in(7) + n_dr(7), B), the randomization channel last
extern "C" int igt_fused_substep_dr_host(const float* consts, const float* x, float* y,
                                         int B, int nd) {
  return run_k2_flags<float>(consts, x, y, B, nd, 1, 0) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_dr_count_ops(const float* consts, const float* x,
                                                    float* y, int B, int nd) {
  return run_k2_flags<igt::CountF>(consts, x, y, B, nd, 1, 0);
}

// K2-tau (with_dr 0) and K2-dr-tau (with_dr 1): y gains the moment rows
extern "C" int igt_fused_substep_tau_host(const float* consts, const float* x, float* y,
                                          int B, int nd, int with_dr) {
  return run_k2_flags<float>(consts, x, y, B, nd, with_dr, 1) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_tau_count_ops(const float* consts, const float* x,
                                                     float* y, int B, int nd, int with_dr) {
  return run_k2_flags<igt::CountF>(consts, x, y, B, nd, with_dr, 1);
}

// K2's build (with_dr, with_torque) in float with the lanes of every phase run
// in reverse order, 31 .. 0
extern "C" int igt_fused_substep_reversed_host(const float* consts, const float* x, float* y,
                                               int B, int nd, int with_dr, int with_torque) {
  return run_k2_flags<float>(consts, x, y, B, nd, with_dr, with_torque, true) == 0 ? 0 : 1;
}

extern "C" int igt_fused_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}

#endif  // K2

#if IGT_PART(3)
// K3: x is (4 k nd + 9 nb, B)
extern "C" int igt_fused_substep_multi_host(const float* consts, const float* x, float* y,
                                            int B, int nd, int k, int nb) {
  return run_multi<float>(consts, x, y, B, nd, k, nb) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_multi_count_ops(const float* consts, const float* x,
                                                       float* y, int B, int nd, int k, int nb) {
  return run_multi<igt::CountF>(consts, x, y, B, nd, k, nb);
}

extern "C" int igt_multi_layout(int nd, int k, int* out, int n) {
  return igt::fill_multi_layout(nd, k, out, n);
}

// The blocks tree_warp.cuh derives from one articulation's block of a K3
// pack (``art``: its header, DOF table and ancestor mask at nd DOFs): out[0]
// the blocks, out[1] the factor's entries, out[2] the active columns, out[3
// ..] each block's DOFs in block order. Returns 0, or 1 for a DOF count the
// library is not built for (3, 7, 26) or too short an ``out``.
template <int ND>
int tree_of(const float* art, int* out, int n) {
  igt::Tree<ND> tr;
  for (int l = 0; l < ND; ++l) igt::tree_link<ND>(art, tr, l);
  igt::tree_blocks<ND>(art, tr);
  if (n < 3 + tr.nblk) return 1;
  out[0] = tr.nblk;
  out[1] = tr.nent;
  out[2] = tr.ncol;
  for (int b = 0; b < tr.nblk; ++b) out[3 + b] = tr.bs[b + 1] - tr.bs[b];
  return 0;
}

extern "C" int igt_multi_tree(const float* art, int nd, int* out, int n) {
  if (nd == 3) return tree_of<3>(art, out, n);
  if (nd == 7) return tree_of<7>(art, out, n);
  if (nd == 26) return tree_of<26>(art, out, n);
  return 1;
}

#endif  // K3

#if IGT_PART(5)
// K3-tau: the same inputs; y gains the 3 (ng + nb) moment rows
extern "C" int igt_fused_substep_multi_tau_host(const float* consts, const float* x, float* y,
                                                int B, int nd, int k, int nb) {
  return run_multi<float, true>(consts, x, y, B, nd, k, nb) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_multi_tau_count_ops(const float* consts, const float* x,
                                                           float* y, int B, int nd, int k,
                                                           int nb) {
  return run_multi<igt::CountF, true>(consts, x, y, B, nd, k, nb);
}
#endif  // K3-tau

#if IGT_PART(6)
// K3 (with_torque 0) or K3-tau (1) in float with the lanes of every phase
// run in reverse order, 31 .. 0
extern "C" int igt_fused_substep_multi_reversed_host(const float* consts, const float* x,
                                                     float* y, int B, int nd, int k, int nb,
                                                     int with_torque) {
  return (with_torque ? run_multi<float, true>(consts, x, y, B, nd, k, nb, true)
                      : run_multi<float>(consts, x, y, B, nd, k, nb, true)) == 0 ? 0 : 1;
}
#endif  // K3, reversed lanes

#if IGT_PART(4)
// K4: x is (fl_n_in(nd), B), y is (fl_n_out(nd, ng), B)
extern "C" int igt_fused_substep_floating_host(const float* consts, const float* x, float* y,
                                               int B, int nd) {
  return run_floating<float>(consts, x, y, B, nd) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_floating_count_ops(const float* consts, const float* x,
                                                          float* y, int B, int nd) {
  return run_floating<igt::CountF>(consts, x, y, B, nd);
}

// K4-tau: y is (fl_n_out(nd, ng, true), B)
extern "C" int igt_fused_substep_floating_tau_host(const float* consts, const float* x, float* y,
                                                   int B, int nd) {
  return run_floating<float, true>(consts, x, y, B, nd) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_floating_tau_count_ops(const float* consts,
                                                              const float* x, float* y, int B,
                                                              int nd) {
  return run_floating<igt::CountF, true>(consts, x, y, B, nd);
}

// K4 (with_torque 0) or K4-tau (1) in float with the lanes of every phase
// run in reverse order, 31 .. 0
extern "C" int igt_fused_substep_floating_reversed_host(const float* consts, const float* x,
                                                        float* y, int B, int nd,
                                                        int with_torque) {
  return (with_torque ? run_floating<float, true>(consts, x, y, B, nd, true)
                      : run_floating<float>(consts, x, y, B, nd, true)) == 0 ? 0 : 1;
}

extern "C" int igt_floating_layout(int nd, int* out, int n) {
  return igt::fill_floating_layout(nd, out, n);
}
#endif  // K4
