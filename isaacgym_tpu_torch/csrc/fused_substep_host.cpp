// Host loops over the kernels' per-env bodies (fused_substep.cuh for K2,
// K2-dr and K2-tau, fused_substep_multi.cuh for K3 and K3-tau,
// fused_substep_floating.cuh for K4), for the CPU
// tests and for counting the operations the kernels do on given inputs.
// Never on the main path.
//
//   g++ -std=c++17 -O2 -shared -fPIC -I csrc -o libigt_host.so csrc/fused_substep_host.cpp
#include <cmath>

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

}  // namespace igt

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
// shapes the CUDA library is built for. Returns 0 (or the operation count),
// or -1 on another shape.
template <class T, bool WITH_TORQUE = false>
long long run_multi(const float* consts, const float* x, float* y, int B, int nd, int k,
                    int nb) {
  if (B < 1) return -1;
  igt::g_ops = 0;
  if (nd == 7 && k == 2 && nb == 1) {
    for (int b = 0; b < B; ++b)
      igt::fused_substep_multi_env<T, 7, 2, 1, WITH_TORQUE>(consts, x, y, b, B);
  } else if (nd == 3 && k == 2 && nb == 2) {
    for (int b = 0; b < B; ++b)
      igt::fused_substep_multi_env<T, 3, 2, 2, WITH_TORQUE>(consts, x, y, b, B);
  } else {
    return -1;
  }
  return igt::g_ops;
}

// K4 over every env, in float or with the counting float: ND 27 (C10) and 4
// (the CPU tests' toy biped). Returns 0 (or the operation count), or -1 on
// another DOF count.
template <class T>
long long run_floating(const float* consts, const float* x, float* y, int B, int nd) {
  if (B < 1) return -1;
  igt::g_ops = 0;
  if (nd == 27) {
    for (int b = 0; b < B; ++b) igt::fused_substep_floating_env<T, 27>(consts, x, y, b, B);
  } else if (nd == 4) {
    for (int b = 0; b < B; ++b) igt::fused_substep_floating_env<T, 4>(consts, x, y, b, B);
  } else {
    return -1;
  }
  return igt::g_ops;
}

}  // namespace

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

extern "C" int igt_floating_layout(int nd, int* out, int n) {
  return igt::fill_floating_layout(nd, out, n);
}
