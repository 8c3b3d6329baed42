// K2 and K2-dr on Hopper: the fused physics substep of the flagship scene,
// one thread per env. Replaces isaacgym_tpu/ops/pallas_dynamics.py:754
// (build_fused_substep, with_dr=False and with_dr=True); the per-env body and
// what bounds it are described in fused_substep.cuh.
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
//        -Xcompiler -fPIC -Xptxas -v -o libigt_kernels.so csrc/*.cu
// and bound with ctypes; each launcher returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fused_substep.cuh"

namespace {

constexpr int kBlock = 32;

template <int ND, bool WITH_DR>
__global__ void __launch_bounds__(kBlock)
fused_substep_kernel(const float* __restrict__ c, const float* __restrict__ x,
                     float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  igt::fused_substep_env<float, ND, WITH_DR>(c, x, y, b, B);
}

template <bool WITH_DR>
int launch(const float* consts, const float* x, float* y, int B, int nd, int ng,
           void* stream) {
  if (nd != 7 || B < 1 || ng < 0 || ng > igt::MAX_ART) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  fused_substep_kernel<7, WITH_DR><<<grid, kBlock, 0, (cudaStream_t)stream>>>(consts, x, y, B);
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

extern "C" int igt_fused_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}
