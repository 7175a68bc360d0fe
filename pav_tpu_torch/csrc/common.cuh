// Shared constants of the affine-gap DP kernels (dp_full.cu, dp_wave.cu,
// dp_band.cu, traceback.cu). Scores are int32 throughout; NEG is the
// "unreachable" score, identical to pav_tpu.ops.affine_dp.NEG, so tapes
// compare bit for bit with the reference wherever both sides compute from NEG.
#pragma once

#include <cstdint>
#include <cooperative_groups.h>
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

// Flags between the warps of a block, in shared memory: a plain load and
// store that the compiler may not cache or reorder across the fences the
// callers put around them (block-scope acquire / release measured slower
// on an H100).
__device__ __forceinline__ int ld_volatile(const int* p) {
  return *static_cast<const volatile int*>(p);
}
__device__ __forceinline__ void st_volatile(int* p, int v) { *static_cast<volatile int*>(p) = v; }

// Thread-block clusters (sm_90): the cluster barrier, a block's shared
// memory as seen from another block of its cluster, and acquire loads and
// release stores on an int in any block's shared memory.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// mbarriers in shared memory and asynchronous stores into a neighbour's
// shared memory that complete a transaction on its mbarrier (sm_90): the
// store needs no fence, and the waiting block acquires what it stored.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes this thread's mbar_init visible to the cluster's asynchronous stores.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives on bar, expecting `bytes` of asynchronous stores in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
      ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until bar's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The shared::cluster address of p's place in block `rank`'s shared memory.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Stores v0..v3 at the shared::cluster address `dst` (16-byte aligned) and
// completes 16 bytes on the mbarrier at the shared::cluster address `bar`.
__device__ __forceinline__ void st_async4(uint32_t dst, int v0, int v1, int v2, int v3,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(v0), "r"(v1), "r"(v2), "r"(v3), "r"(bar) : "memory");
}

}  // namespace pav
