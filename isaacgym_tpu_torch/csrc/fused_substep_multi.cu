// K3 and K3-tau on Hopper: the fused physics substep of K fixed-base
// articulations and NB balls, one thread per env. Replaces
// isaacgym_tpu/ops/pallas_dynamics.py:1477 (build_fused_substep_multi,
// with_torque False or True); the per-env body and what bounds it are
// described in fused_substep_multi.cuh.
//
// Instantiated for <ND, K, NB> = <7, 2, 1> (C8: two 7-DOF humanoids, one
// ball) and <3, 2, 2> (the two-arm, two-ball check scene), each without and
// with the torque lanes (WITH_TORQUE, launched only for scenes that register
// a force sensor); any other shape is refused with cudaErrorInvalidValue. Block size 32, as K2's: at 4096
// envs one warp on each of 128 SMs. Inputs and outputs are channel-major
// (channel, B) float32 buffers; the constants are read with __ldg.
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

constexpr int kBlock = 32;

template <int ND, int K, int NB, bool WITH_TORQUE>
__global__ void __launch_bounds__(kBlock)
fused_substep_multi_kernel(const float* __restrict__ c, const float* __restrict__ x,
                           float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  igt::fused_substep_multi_env<float, ND, K, NB, WITH_TORQUE>(c, x, y, b, B);
}

template <int ND, int K, int NB, bool WITH_TORQUE>
int launch(const float* c, const float* x, float* y, int B, void* stream) {
  const int grid = (B + kBlock - 1) / kBlock;
  fused_substep_multi_kernel<ND, K, NB, WITH_TORQUE>
      <<<grid, kBlock, 0, (cudaStream_t)stream>>>(c, x, y, B);
  return (int)cudaGetLastError();
}

template <bool WITH_TORQUE>
int launch_shape(const float* c, const float* x, float* y, int B, int nd, int k, int nb,
                 int ng, void* stream) {
  if (B < 1 || ng < 0 || ng > igt::MULTI_MAX_ART) return (int)cudaErrorInvalidValue;
  if (nd == 7 && k == 2 && nb == 1) return launch<7, 2, 1, WITH_TORQUE>(c, x, y, B, stream);
  if (nd == 3 && k == 2 && nb == 2) return launch<3, 2, 2, WITH_TORQUE>(c, x, y, B, stream);
  return (int)cudaErrorInvalidValue;
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

extern "C" int igt_multi_layout(int nd, int k, int* out, int n) {
  return igt::fill_multi_layout(nd, k, out, n);
}
