// K2, K2-dr and K2-tau on Hopper: the fused physics substep of the flagship
// scene, one thread per env. Replaces isaacgym_tpu/ops/pallas_dynamics.py:754
// (build_fused_substep, with_dr False or True, with_torque False or True);
// the per-env body and what bounds it are described in fused_substep.cuh.
// K2-tau is the WITH_TORQUE instantiation, built into the same library and
// launched only for scenes that register a force sensor; it writes
// n_out(7, ng, true) rows, the moment rows after the impulse rows.
//
// Block size 32: at the main path's 4096 envs that is 128 blocks, one warp
// on each of 128 of the card's 132 SMs; 64 or 128 threads a block would
// leave 68 or 100 SMs idle. Inputs and outputs are channel-major (channel,
// B) float32 buffers, so the 32 lanes of a warp read and write 32
// neighbouring floats per channel; K2-dr's randomization channel is 34 more
// input rows of the same buffer. The scene constants (~4 KB) are read with
// __ldg, the same address across a warp.
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_fused_substep.so csrc/fused_substep.cu
// and bound with ctypes; each launcher returns cudaGetLastError(). Without
// FMA contraction the kernels round op by op as the plain version does (see
// CUDA_FLAGS in ops/_build.py).
#include <cuda_runtime.h>

#include "fused_substep.cuh"

namespace {

constexpr int kBlock = 32;

template <int ND, bool WITH_DR, bool WITH_TORQUE>
__global__ void __launch_bounds__(kBlock)
fused_substep_kernel(const float* __restrict__ c, const float* __restrict__ x,
                     float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  igt::fused_substep_env<float, ND, WITH_DR, WITH_TORQUE>(c, x, y, b, B);
}

template <bool WITH_DR, bool WITH_TORQUE = false>
int launch(const float* consts, const float* x, float* y, int B, int nd, int ng,
           void* stream) {
  if (nd != 7 || B < 1 || ng < 0 || ng > igt::MAX_ART) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  fused_substep_kernel<7, WITH_DR, WITH_TORQUE>
      <<<grid, kBlock, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
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

extern "C" int igt_fused_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}
