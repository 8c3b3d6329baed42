// K4 on Hopper: the fused physics substep of one floating-base humanoid with
// one ball (the 27-DOF whole-body C10 scene), one warp per env, and its
// torque-lane build K4-tau for scenes with a force sensor. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:2225 (build_fused_substep_floating;
// K4 with_torque=False, K4-tau with_torque=True); the per-env body, how its
// lanes share the work and what bounds it are described in
// fused_substep_floating.cuh.
//
// Instantiated for ND = 27 (C10's G1), each build in its own entry point;
// any other DOF count is refused with cudaErrorInvalidValue. A block holds
// kEnvs = 4 envs, one warp each, and their shared blocks (static shared
// memory, under 48 KB); __launch_bounds__ asks ptxas for four resident
// blocks per SM (at most 128 registers a thread). At C10's 2048 envs that is
// 512 blocks, all resident at once on the card's 132 SMs: 16 warps on most
// SMs, where one thread per env gave one warp on each of 64. Inputs and
// outputs are channel-major (channel, B) float32 buffers; a warp reads and
// writes its env's column, one channel per lane. The scene constants (2,809
// floats at ND 27) are read with __ldg.
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

constexpr int kEnvs = 4;          // envs (warps) per block
constexpr int kBlocksPerSM = 4;
constexpr int kND = 27;

static_assert(sizeof(igt::FloatShared<float, kND, true>) * kEnvs <= 48 * 1024,
              "the envs' shared blocks exceed the static shared memory of a block");

template <int ND, bool WITH_TORQUE>
__global__ void __launch_bounds__(kEnvs * igt::WARP, kBlocksPerSM)
fused_substep_floating_kernel(const float* __restrict__ c, const float* __restrict__ x,
                              float* __restrict__ y, int B) {
  __shared__ igt::FloatShared<float, ND, WITH_TORQUE> sh[kEnvs];
  const int e = threadIdx.x / igt::WARP;
  const int b = blockIdx.x * kEnvs + e;
  if (b >= B) return;   // the whole warp: a warp is one env
  igt::fused_substep_floating_env<float, ND, WITH_TORQUE>(
      c, x, y, b, B, sh[e], igt::Lanes{(int)(threadIdx.x % igt::WARP), false});
}

template <bool WITH_TORQUE>
int launch(const float* consts, const float* x, float* y, int B, int nd, int ng, void* stream) {
  if (nd != kND || B < 1 || ng < 0 || ng > igt::FL_MAX_ART) return (int)cudaErrorInvalidValue;
  const int grid = (B + kEnvs - 1) / kEnvs;
  fused_substep_floating_kernel<kND, WITH_TORQUE>
      <<<grid, kEnvs * igt::WARP, 0, (cudaStream_t)stream>>>(consts, x, y, B);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: x is (fl_n_in(27), B); y is (fl_n_out(27, ng), B)
extern "C" int igt_fused_substep_floating_launch(const float* consts, const float* x, float* y,
                                                 int B, int nd, int ng, void* stream) {
  return launch<false>(consts, x, y, B, nd, ng, stream);
}

// K4-tau: y is (fl_n_out(27, ng, true), B)
extern "C" int igt_fused_substep_floating_tau_launch(const float* consts, const float* x,
                                                     float* y, int B, int nd, int ng,
                                                     void* stream) {
  return launch<true>(consts, x, y, B, nd, ng, stream);
}

// The launch geometry of K4 (with_torque 0) or K4-tau (1): out[0] the envs
// (warps) of a block, out[1] the blocks per SM that __launch_bounds__ asks
// for, out[2] the blocks per SM that the runtime's occupancy calculator
// finds for this build. Returns the calculator's cudaError_t.
extern "C" int igt_floating_occupancy(int with_torque, int* out, int n) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  int fit = 0;
  const cudaError_t err =
      with_torque ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &fit, fused_substep_floating_kernel<kND, true>, kEnvs * igt::WARP, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &fit, fused_substep_floating_kernel<kND, false>, kEnvs * igt::WARP, 0);
  out[0] = kEnvs;
  out[1] = kBlocksPerSM;
  out[2] = fit;
  return (int)err;
}

extern "C" int igt_floating_layout(int nd, int* out, int n) {
  return igt::fill_floating_layout(nd, out, n);
}
