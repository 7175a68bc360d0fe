// Shared constants of the affine-gap DP kernels (dp_full.cu, dp_wave.cu,
// traceback.cu). Scores are int32 throughout; NEG is the "unreachable"
// score, identical to pav_tpu.ops.affine_dp.NEG, so tapes compare bit for
// bit with the reference wherever both sides compute from NEG.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pav {

constexpr int NEG = -(1 << 29);

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Two-piece affine gap cost min(o1 + g*e1, o2 + g*e2) (a positive number).
__device__ __forceinline__ int gap_cost(int g, int o1, int o2, int e1, int e2) {
  return imin(o1 + g * e1, o2 + g * e2);
}

// Shared memory a block may use on sm_90 (232,448 bytes).
constexpr int kMaxSmem = 232448;

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pav
