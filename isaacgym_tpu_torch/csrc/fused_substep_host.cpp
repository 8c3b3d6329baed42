// Host loops over the kernels' per-env bodies (arm_step.cuh for K1,
// fused_substep.cuh for K2, K2-dr and K2-tau, fused_substep_multi.cuh for K3
// and K3-tau, fused_substep_floating.cuh for K4 and K4-tau), for the CPU
// tests and for counting the operations the kernels do on given inputs.
// Never on the main path.
//
//   g++ -std=c++17 -O2 -shared -fPIC -I csrc -o libigt_host.so csrc/fused_substep_host.cpp
#include <cmath>
#include <cstring>

namespace igt {

// A float that counts every arithmetic operation, comparison and math call
// applied to it (unary minus and copies are free). Single-threaded use only.
static long long g_ops = 0;

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
#include "fused_substep_multi.cuh"
#include "fused_substep_floating.cuh"

namespace {

// Runs the body on every env in float; returns 0, or 1 on a bad shape.
template <bool WITH_DR, bool WITH_TORQUE = false>
int run(const float* consts, const float* x, float* y, int B, int nd) {
  if (nd != 7 || B < 1) return 1;
  for (int b = 0; b < B; ++b)
    igt::fused_substep_env<float, 7, WITH_DR, WITH_TORQUE>(consts, x, y, b, B);
  return 0;
}

// Runs the body on every env with the counting float; returns the total
// number of operations, or -1 on a bad shape (outputs are written as by run).
template <bool WITH_DR, bool WITH_TORQUE = false>
long long count_ops(const float* consts, const float* x, float* y, int B, int nd) {
  if (nd != 7 || B < 1) return -1;
  igt::g_ops = 0;
  for (int b = 0; b < B; ++b)
    igt::fused_substep_env<igt::CountF, 7, WITH_DR, WITH_TORQUE>(consts, x, y, b, B);
  return igt::g_ops;
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

// K1 over every env, in float or with the counting float (nd 7). Returns 0
// (or the operation count), or -1 on another DOF count.
template <class T>
long long run_arm(const float* consts, const float* x, float* y, int B, int nd) {
  if (nd != 7 || B < 1) return -1;
  igt::g_ops = 0;
  for (int b = 0; b < B; ++b) igt::arm_step_env<T, 7>(consts, x, y, b, B);
  return igt::g_ops;
}

}  // namespace

// K1: x is (arm_n_in(7), B), y is (arm_n_out(7), B)
extern "C" int igt_arm_step_host(const float* consts, const float* x, float* y, int B, int nd) {
  return run_arm<float>(consts, x, y, B, nd) == 0 ? 0 : 1;
}

extern "C" long long igt_arm_step_count_ops(const float* consts, const float* x, float* y,
                                            int B, int nd) {
  return run_arm<igt::CountF>(consts, x, y, B, nd);
}

// K2: x is (n_in(7), B)
extern "C" int igt_fused_substep_host(const float* consts, const float* x, float* y,
                                      int B, int nd) {
  return run<false>(consts, x, y, B, nd);
}

extern "C" long long igt_fused_substep_count_ops(const float* consts, const float* x,
                                                 float* y, int B, int nd) {
  return count_ops<false>(consts, x, y, B, nd);
}

// K2-dr: x is (n_in(7) + n_dr(7), B), the randomization channel last
extern "C" int igt_fused_substep_dr_host(const float* consts, const float* x, float* y,
                                         int B, int nd) {
  return run<true>(consts, x, y, B, nd);
}

extern "C" long long igt_fused_substep_dr_count_ops(const float* consts, const float* x,
                                                    float* y, int B, int nd) {
  return count_ops<true>(consts, x, y, B, nd);
}

// K2-tau (with_dr 0) and K2-dr-tau (with_dr 1): y gains the moment rows
extern "C" int igt_fused_substep_tau_host(const float* consts, const float* x, float* y,
                                          int B, int nd, int with_dr) {
  return with_dr ? run<true, true>(consts, x, y, B, nd) : run<false, true>(consts, x, y, B, nd);
}

extern "C" long long igt_fused_substep_tau_count_ops(const float* consts, const float* x,
                                                     float* y, int B, int nd, int with_dr) {
  return with_dr ? count_ops<true, true>(consts, x, y, B, nd)
                 : count_ops<false, true>(consts, x, y, B, nd);
}

extern "C" int igt_fused_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}

// K3: x is (4 k nd + 9 nb, B)
extern "C" int igt_fused_substep_multi_host(const float* consts, const float* x, float* y,
                                            int B, int nd, int k, int nb) {
  return run_multi<float>(consts, x, y, B, nd, k, nb) == 0 ? 0 : 1;
}

extern "C" long long igt_fused_substep_multi_count_ops(const float* consts, const float* x,
                                                       float* y, int B, int nd, int k, int nb) {
  return run_multi<igt::CountF>(consts, x, y, B, nd, k, nb);
}

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

// K3 (with_torque 0) or K3-tau (1) in float with the lanes of every phase
// run in reverse order, 31 .. 0
extern "C" int igt_fused_substep_multi_reversed_host(const float* consts, const float* x,
                                                     float* y, int B, int nd, int k, int nb,
                                                     int with_torque) {
  return (with_torque ? run_multi<float, true>(consts, x, y, B, nd, k, nb, true)
                      : run_multi<float>(consts, x, y, B, nd, k, nb, true)) == 0 ? 0 : 1;
}

extern "C" int igt_multi_layout(int nd, int k, int* out, int n) {
  return igt::fill_multi_layout(nd, k, out, n);
}

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
