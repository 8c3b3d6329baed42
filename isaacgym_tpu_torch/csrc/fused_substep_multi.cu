// K3 and K3-tau on Hopper: the fused physics substep of K fixed-base
// articulations and NB balls, one warp per env with the articulations side
// by side. Replaces isaacgym_tpu/ops/pallas_dynamics.py:1477
// (build_fused_substep_multi, with_torque False or True); the per-env body
// and how its lanes share the work are described in fused_substep_multi.cuh
// and art_warp.cuh.
//
// Instantiated for <ND, K, NB> = <7, 2, 1> (C8: two 7-DOF humanoids, one
// ball), <3, 2, 2> (the two-arm, two-ball check scene) and <26, 2, 2> (C11:
// two 26-DOF humanoids, two balls), each without and with the torque lanes
// (WITH_TORQUE, launched only for scenes that register a force sensor); any
// other shape is refused with cudaErrorInvalidValue. A block holds
// Geometry<ND, K, NB>::envs envs, one warp each, and their shared blocks
// (static shared memory, at most 48 KB a block), and each instantiation asks
// ptxas for its own blocks_per_sm resident blocks per SM (__launch_bounds__):
//   - <7, 2, 1> and <3, 2, 2>: 4 envs (14-21 KB) a block, 8 blocks per SM,
//     so at most 64 registers a thread; at C8's 4096 envs that is 1,024
//     blocks, all resident at once on the card's 132 SMs (32 warps on most);
//   - <26, 2, 2>: the tree-blocked body (tree_warp.cuh: each articulation's
//     tables for its blocks' entries only, TREE_CAP of them), one env a
//     block, 17,560 B of shared memory, so 12 blocks fit an SM's 228 KB: 12
//     warps per SM, at most 168 registers a thread, and C11's 4096 envs in 3
//     waves (the dense body's 45,816 B held 4 an SM, 8 waves).
// Inputs and outputs are channel-major (channel, B) float32 buffers; a warp
// reads and writes its env's column, one channel per lane. The constants are
// read with __ldg.
//
// What bounds it on an H100: instruction issue. With one warp to each of an
// SM's four schedulers (528 envs) a launch takes about half as long as at
// 4096 (eight to a scheduler): each warp's chain of phases is then the
// limit, and at 4096 the schedulers are busy. A phase on one lane (the FK
// walks, the balls' walks, the back solves, a contact's sums) issues as many
// instructions as one on 32; so the design splits what parallelises, takes
// the contact tests ahead of the walks that need them in order, and skips the
// tests that cannot act (fused_substep_multi.cuh). PERF.md has the times by
// phase (a clock64 probe) and what was tried.
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_fused_substep_multi.so csrc/fused_substep_multi.cu
// and bound with ctypes; the launcher returns cudaGetLastError(). Without
// FMA contraction the kernel rounds op by op as its plain version does: at
// humanoid 2's paddle, 3.2 m from the origin, float32 position rounding is
// amplified through the short ball-to-paddle normal, and a contracted
// build's own rounding put the ball's spin 2.1e-3 past its gate.
#include <cuda_runtime.h>

#include "fused_substep_multi.cuh"

namespace {

// The launch geometry of one shape: envs (warps) per block, and the resident
// blocks per SM that __launch_bounds__ asks for.
template <int ND, int K, int NB>
struct Geometry {
  static constexpr int envs = 4;
  static constexpr int blocks_per_sm = 8;
};
template <>
struct Geometry<26, 2, 2> {
  static constexpr int envs = 1;
  static constexpr int blocks_per_sm = 12;
};

template <int ND, int K, int NB, bool WITH_TORQUE>
__global__ void __launch_bounds__(Geometry<ND, K, NB>::envs * igt::WARP,
                                  Geometry<ND, K, NB>::blocks_per_sm)
fused_substep_multi_kernel(const float* __restrict__ c, const float* __restrict__ x,
                           float* __restrict__ y, int B) {
  constexpr int kEnvs = Geometry<ND, K, NB>::envs;
  using Shared = igt::MultiShared<float, ND, K, NB, WITH_TORQUE>;
  static_assert(sizeof(Shared) * kEnvs <= 48 * 1024,
                "the envs' shared blocks exceed the static shared memory of a block");
  __shared__ Shared sh[kEnvs];
  const int e = threadIdx.x / igt::WARP;
  const int b = blockIdx.x * kEnvs + e;
  if (b >= B) return;   // the whole warp: a warp is one env
  igt::fused_substep_multi_env<float, ND, K, NB, WITH_TORQUE>(
      c, x, y, b, B, sh[e], igt::Lanes{(int)(threadIdx.x % igt::WARP), false});
}

template <int ND, int K, int NB, bool WITH_TORQUE>
int launch(const float* c, const float* x, float* y, int B, void* stream) {
  constexpr int kEnvs = Geometry<ND, K, NB>::envs;
  const int grid = (B + kEnvs - 1) / kEnvs;
  fused_substep_multi_kernel<ND, K, NB, WITH_TORQUE>
      <<<grid, kEnvs * igt::WARP, 0, (cudaStream_t)stream>>>(c, x, y, B);
  return (int)cudaGetLastError();
}

template <bool WITH_TORQUE>
int launch_shape(const float* c, const float* x, float* y, int B, int nd, int k, int nb,
                 int ng, void* stream) {
  if (B < 1 || ng < 0 || ng > igt::MULTI_MAX_ART) return (int)cudaErrorInvalidValue;
  if (nd == 7 && k == 2 && nb == 1) return launch<7, 2, 1, WITH_TORQUE>(c, x, y, B, stream);
  if (nd == 3 && k == 2 && nb == 2) return launch<3, 2, 2, WITH_TORQUE>(c, x, y, B, stream);
  if (nd == 26 && k == 2 && nb == 2) return launch<26, 2, 2, WITH_TORQUE>(c, x, y, B, stream);
  return (int)cudaErrorInvalidValue;
}

// The shape's geometry in out[0..1] and the blocks per SM that the runtime's
// occupancy calculator finds in out[2].
template <int ND, int K, int NB>
cudaError_t fit(bool with_torque, int* out) {
  using G = Geometry<ND, K, NB>;
  out[0] = G::envs;
  out[1] = G::blocks_per_sm;
  return with_torque ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           out + 2, fused_substep_multi_kernel<ND, K, NB, true>,
                           G::envs * igt::WARP, 0)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           out + 2, fused_substep_multi_kernel<ND, K, NB, false>,
                           G::envs * igt::WARP, 0);
}

}  // namespace

// K3: x is (4 K nd + 9 nb, B); ng articulated geoms
extern "C" int igt_fused_substep_multi_launch(const float* consts, const float* x, float* y,
                                              int B, int nd, int k, int nb, int ng,
                                              void* stream) {
  return launch_shape<false>(consts, x, y, B, nd, k, nb, ng, stream);
}

// K3-tau: the same inputs; y gains the 3 (ng + nb) moment rows
extern "C" int igt_fused_substep_multi_tau_launch(const float* consts, const float* x,
                                                  float* y, int B, int nd, int k, int nb,
                                                  int ng, void* stream) {
  return launch_shape<true>(consts, x, y, B, nd, k, nb, ng, stream);
}

// The launch geometry of K3 (with_torque 0) or K3-tau (1) at <nd, k, nb>:
// out[0] the envs (warps) of a block, out[1] the blocks per SM that
// __launch_bounds__ asks for, out[2] the blocks per SM that the runtime's
// occupancy calculator finds for this build. Returns the calculator's
// cudaError_t, or cudaErrorInvalidValue for a shape the library is not
// built for.
extern "C" int igt_multi_occupancy(int nd, int k, int nb, int with_torque, int* out, int n) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  out[2] = 0;
  if (nd == 7 && k == 2 && nb == 1) return (int)fit<7, 2, 1>(with_torque != 0, out);
  if (nd == 3 && k == 2 && nb == 2) return (int)fit<3, 2, 2>(with_torque != 0, out);
  if (nd == 26 && k == 2 && nb == 2) return (int)fit<26, 2, 2>(with_torque != 0, out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int igt_multi_layout(int nd, int k, int* out, int n) {
  return igt::fill_multi_layout(nd, k, out, n);
}
