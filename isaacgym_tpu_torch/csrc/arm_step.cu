// K1 on Hopper: the arm step, four envs to a warp. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:447 (build_arm_step); the per-env
// body, its layout and how the envs share a warp are described in
// arm_step.cuh and art_warp.cuh.
//
// Instantiated for ND = 7 (any other DOF count is refused with
// cudaErrorInvalidValue). A block holds kWarps = 4 warps, K1_ENVS envs each,
// and their shared blocks (static shared memory); __launch_bounds__ asks
// ptxas for kBlocksPerSM = 4 resident blocks per SM, so at most 128
// registers a thread: at the terrain path's 4096 envs, 256 blocks, all
// resident at once on the card's 132 SMs. Inputs and outputs are
// channel-major; each env's lanes read and write its column, one channel
// per lane. The scene constants (the articulation's ~1.9 KB) are read with
// __ldg.
//
// What bounds it on an H100: instruction issue, as K2's (fused_substep.cu).
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_arm_step.so csrc/arm_step.cu
// and bound with ctypes; the launcher returns cudaGetLastError().
#include <cuda_runtime.h>

#include "arm_step.cuh"

namespace {

constexpr int kWarps = 4;                        // warps per block
constexpr int kEnvs = kWarps * igt::K1_ENVS;     // envs per block
constexpr int kBlocksPerSM = 4;

static_assert(sizeof(igt::ArmStepShared<float, 7, igt::K1_ENVS>) * kWarps <= 48 * 1024,
              "the warps' shared blocks exceed the static shared memory of a block");

template <int ND>
__global__ void __launch_bounds__(kWarps * igt::WARP, kBlocksPerSM)
arm_step_kernel(const float* __restrict__ c, const float* __restrict__ x,
                float* __restrict__ y, int B) {
  __shared__ igt::ArmStepShared<float, ND, igt::K1_ENVS> sh[kWarps];
  const int wi = threadIdx.x / igt::WARP;
  const int b0 = (blockIdx.x * kWarps + wi) * igt::K1_ENVS;
  if (b0 >= B) return;   // the whole warp
  igt::arm_step_warp<float, ND>(c, x, y, b0, B, sh[wi],
                                igt::Lanes{(int)(threadIdx.x % igt::WARP), false});
}

}  // namespace

// x is (arm_n_in(nd), B), y is (arm_n_out(nd), B); built for nd = 7
extern "C" int igt_arm_step_launch(const float* consts, const float* x, float* y, int B,
                                   int nd, void* stream) {
  if (nd != 7 || B < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kEnvs - 1) / kEnvs;
  arm_step_kernel<7><<<grid, kWarps * igt::WARP, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
}

// K1's launch geometry, as igt_fused_occupancy's: envs per block, blocks per
// SM asked and found by the runtime's occupancy calculator, warps per block
extern "C" int igt_arm_occupancy(int* out, int n) {
  if (n < 4) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, arm_step_kernel<7>, kWarps * igt::WARP, 0);
  out[0] = kEnvs;
  out[1] = kBlocksPerSM;
  out[2] = blocks;
  out[3] = kWarps;
  return (int)err;
}

extern "C" int igt_arm_layout(int nd, int* out, int n) {
  return igt::fill_layout(nd, out, n);
}
