// K4 on Hopper: the fused physics substep of one floating-base humanoid with
// one ball (the 27-DOF whole-body C10 scene), one thread per env. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:2225 (build_fused_substep_floating,
// with_torque=False); the per-env body and what bounds it are described in
// fused_substep_floating.cuh.
//
// Instantiated for ND = 27 (C10's G1); any other DOF count is refused with
// cudaErrorInvalidValue. Block size 32, as K2's and K3's: at C10's 2048 envs
// that is 64 blocks, one warp on each of 64 of the card's 132 SMs, so at
// most half the SMs hold a warp and each holds one (occupancy 1 warp of 64).
// Inputs and outputs are channel-major (channel, B) float32 buffers, so the
// 32 lanes of a warp read and write 32 neighbouring floats per channel; the
// scene constants (2,809 floats at ND 27) are read with __ldg, the same address
// across a warp.
//
// Built by isaacgym_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
//        -o libigt_fused_substep_floating.so csrc/fused_substep_floating.cu
// and bound with ctypes; the launcher returns cudaGetLastError(). Without
// FMA contraction the kernel rounds op by op as its plain version does.
#include <cuda_runtime.h>

#include "fused_substep_floating.cuh"

namespace {

constexpr int kBlock = 32;
constexpr int kND = 27;

template <int ND>
__global__ void __launch_bounds__(kBlock)
fused_substep_floating_kernel(const float* __restrict__ c, const float* __restrict__ x,
                              float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  igt::fused_substep_floating_env<float, ND>(c, x, y, b, B);
}

}  // namespace

// x is (fl_n_in(27), B); y is (fl_n_out(27, ng), B)
extern "C" int igt_fused_substep_floating_launch(const float* consts, const float* x, float* y,
                                                 int B, int nd, int ng, void* stream) {
  if (nd != kND || B < 1 || ng < 0 || ng > igt::FL_MAX_ART) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  fused_substep_floating_kernel<kND><<<grid, kBlock, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
}

extern "C" int igt_floating_layout(int nd, int* out, int n) {
  return igt::fill_floating_layout(nd, out, n);
}
