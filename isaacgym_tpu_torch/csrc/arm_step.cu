// K1 on Hopper: the arm step, one thread per env. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:447 (build_arm_step); the per-env body,
// its layout and what bounds it are described in arm_step.cuh.
//
// Block size 32, as K2: at 4096 envs 128 blocks, one warp on each of 128 of
// the card's 132 SMs. The scene constants (the articulation's ~1.9 KB) are
// read with __ldg, the same address across a warp; inputs and outputs are
// channel-major, so a warp's 32 lanes touch 32 neighbouring floats per row.
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_arm_step.so csrc/arm_step.cu
// and bound with ctypes; the launcher returns cudaGetLastError().
#include <cuda_runtime.h>

#include "arm_step.cuh"

namespace {

constexpr int kBlock = 32;

template <int ND>
__global__ void __launch_bounds__(kBlock)
arm_step_kernel(const float* __restrict__ c, const float* __restrict__ x,
                float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  igt::arm_step_env<float, ND>(c, x, y, b, B);
}

}  // namespace

// x is (arm_n_in(nd), B), y is (arm_n_out(nd), B); built for nd = 7
extern "C" int igt_arm_step_launch(const float* consts, const float* x, float* y, int B,
                                   int nd, void* stream) {
  if (nd != 7 || B < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  arm_step_kernel<7><<<grid, kBlock, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
}

extern "C" int igt_arm_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}
