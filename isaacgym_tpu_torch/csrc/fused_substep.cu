// K2, K2-dr, K2-tau and K2-dr-tau on Hopper: the fused physics substep of
// the flagship scene, two envs to a warp. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:754 (build_fused_substep, with_dr
// False or True, with_torque False or True); the per-env body and how the
// envs share a warp are described in fused_substep_warp.cuh and
// art_warp.cuh. K2-tau is the WITH_TORQUE instantiation, built into the same
// library and launched only for scenes that register a force sensor; it
// writes n_out(7, ng, true) rows, the moment rows after the impulse rows.
//
// Instantiated for ND = 7 (any other DOF count is refused with
// cudaErrorInvalidValue). A block holds kWarps = 4 warps, two envs each, and
// their shared blocks (static shared memory); __launch_bounds__ asks ptxas
// for kBlocksPerSM = 4 resident blocks per SM, so at most 128 registers a
// thread: at the main path's 4096 envs that is 512 blocks, all resident at
// once on the card's 132 SMs (about 16 warps, four to a scheduler, on each).
// Inputs and outputs are channel-major (channel, B) float32 buffers; each
// half-warp reads and writes its env's column, one channel per lane.
// K2-dr's randomization channel is 34 more input rows of the same buffer.
// The scene constants (~4 KB) are read with __ldg.
//
// What bounds it on an H100: instruction issue, as K3 (fused_substep_multi.cu).
// A phase on one lane (the FK walks, the back solve, the ball's walks, a
// contact's sums) issues as many instructions as one on 32, so two envs to a
// warp halve both the issue of those phases and the warps per scheduler
// against one env to a warp.
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_fused_substep.so csrc/fused_substep.cu
// and bound with ctypes; each launcher returns cudaGetLastError(). Without
// FMA contraction the kernels round op by op as the plain version does (see
// CUDA_FLAGS in ops/_build.py).
#include <cuda_runtime.h>

#include "fused_substep_warp.cuh"

namespace {

constexpr int kWarps = 4;                             // warps per block
constexpr int kEnvs = kWarps * igt::K2_ENVS;          // envs per block
constexpr int kBlocksPerSM = 4;

static_assert(sizeof(igt::K2Shared<float, 7, true>) * kWarps <= 48 * 1024,
              "the warps' shared blocks exceed the static shared memory of a block");

template <int ND, bool WITH_DR, bool WITH_TORQUE>
__global__ void __launch_bounds__(kWarps * igt::WARP, kBlocksPerSM)
fused_substep_kernel(const float* __restrict__ c, const float* __restrict__ x,
                     float* __restrict__ y, int B) {
  __shared__ igt::K2Shared<float, ND, WITH_TORQUE> sh[kWarps];
  const int wi = threadIdx.x / igt::WARP;
  const int b0 = (blockIdx.x * kWarps + wi) * igt::K2_ENVS;
  if (b0 >= B) return;   // the whole warp
  igt::fused_substep_warp<float, ND, WITH_DR, WITH_TORQUE>(
      c, x, y, b0, B, sh[wi], igt::Lanes{(int)(threadIdx.x % igt::WARP), false});
}

template <bool WITH_DR, bool WITH_TORQUE = false>
int launch(const float* consts, const float* x, float* y, int B, int nd, int ng,
           void* stream) {
  if (nd != 7 || B < 1 || ng < 0 || ng > igt::MAX_ART) return (int)cudaErrorInvalidValue;
  const int grid = (B + kEnvs - 1) / kEnvs;
  fused_substep_kernel<7, WITH_DR, WITH_TORQUE>
      <<<grid, kWarps * igt::WARP, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
}

template <bool WITH_DR>
cudaError_t fit(bool with_torque, int* blocks) {
  return with_torque ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, fused_substep_kernel<7, WITH_DR, true>, kWarps * igt::WARP, 0)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, fused_substep_kernel<7, WITH_DR, false>, kWarps * igt::WARP, 0);
}

}  // namespace

// K2: x is (n_in(7), B)
extern "C" int igt_fused_substep_launch(const float* consts, const float* x, float* y,
                                        int B, int nd, int ng, void* stream) {
  return launch<false>(consts, x, y, B, nd, ng, stream);
}

// K2-dr: x is (n_in(7) + n_dr(7), B), the randomization channel last
extern "C" int igt_fused_substep_dr_launch(const float* consts, const float* x, float* y,
                                           int B, int nd, int ng, void* stream) {
  return launch<true>(consts, x, y, B, nd, ng, stream);
}

// K2-tau (with_dr 0) and K2-dr-tau (with_dr 1): y is (n_out(7, ng, true), B)
extern "C" int igt_fused_substep_tau_launch(const float* consts, const float* x, float* y,
                                            int B, int nd, int ng, int with_dr,
                                            void* stream) {
  return with_dr ? launch<true, true>(consts, x, y, B, nd, ng, stream)
                 : launch<false, true>(consts, x, y, B, nd, ng, stream);
}

// The launch geometry of K2's build (with_dr, with_torque): out[0] the envs
// of a block, out[1] the blocks per SM that __launch_bounds__ asks for,
// out[2] the blocks per SM that the runtime's occupancy calculator finds for
// this build, out[3] the warps of a block. Returns the calculator's
// cudaError_t.
extern "C" int igt_fused_occupancy(int with_dr, int with_torque, int* out, int n) {
  if (n < 4) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = with_dr ? fit<true>(with_torque != 0, &blocks)
                                  : fit<false>(with_torque != 0, &blocks);
  out[0] = kEnvs;
  out[1] = kBlocksPerSM;
  out[2] = blocks;
  out[3] = kWarps;
  return (int)err;
}

extern "C" int igt_fused_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}
