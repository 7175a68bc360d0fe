// Chain scan: minimap2-style anchor chaining DP over a batch of slabs.
//
// Replaces the XLA lax.scan of pav_tpu/ops/chain_scan.py::_chain_scan
// (:19-68), vmapped by _chain_scan_batch (:71-82). For anchor i of a slab:
//   cand_j = (f_j + min(dq, dr, k)) - (gap_scale*dd + 0.5*ilog2(dd + 1))
// over the previous `lookback` anchors j of the same group with dq, dr > 0,
// dq, dr <= max_dist and dd = |dr - dq| <= max_gap_diff (compared in
// float32, as the jitted scan does); f_i = best cand if it beats k (parent
// = the oldest j reaching it), else k with parent -1. Bit-identical to the
// plain version (_chain_scan_ref) and to the reference: every score is
// float32, the gap cost is ONE fused multiply-add (__fmaf_rn; XLA on the CPU
// and native/chain.cpp both fuse it, and two roundings differ at some dd),
// the sums use __fadd_rn/__fsub_rn so nvcc contracts nothing else.
//
// What bounds it on an H100: the recurrence is sequential per slab; each
// anchor is a 64-wide reduction whose result feeds the next anchor, so a
// slab costs n dependent reductions (latency bound, a few hundred cycles
// each). Written as torch ops it would be n launches of ~25 ops each; as one
// kernel it is one launch, and B slabs run as B independent warps.
//
// Design: one warp per slab. The lookback window is a ring of 64 slots, two
// per lane (slots lane and lane+32) held in registers; anchor i goes to slot
// i % lookback. Each step broadcasts the anchor from a register chunk of 32
// anchors (one coalesced load per 32 steps), scores both slots per lane, and
// reduces (cand, anchor index) over the warp with xor shuffles: the larger
// cand wins, ties go to the lower anchor index (the oldest, as the
// reference's first-index argmax over its oldest-first buffer). Each lane
// keeps the result of one anchor of the chunk and stores it coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadGroup = -9;
constexpr int kNoAnchor = 0x7fffffff;    // index of a slot past the lookback

// Wrapping int32 arithmetic (the reference's int32 scan wraps; signed
// overflow is undefined in C++).
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

__device__ __forceinline__ bool better(float c, int i, float oc, int oi) {
  return c > oc || (c == oc && i < oi);
}

// Candidate score of one lookback slot (qb, rb, gb, fb) for anchor (q, r, g).
__device__ __forceinline__ float slot_cand(int q, int r, int g, int qb, int rb,
                                           int gb, float fb, int k,
                                           float max_dist, float max_gap_diff,
                                           float gap_scale, float neg) {
  const int dq = wsub(q, qb);
  const int dr = wsub(r, rb);
  const int dd = wabs(wsub(dr, dq));
  const bool ok = gb == g && dq > 0 && dr > 0
                  && __int2float_rn(dq) <= max_dist
                  && __int2float_rn(dr) <= max_dist
                  && __int2float_rn(dd) <= max_gap_diff;
  if (!ok) return neg;
  const float match = __int2float_rn(min(min(dq, dr), k));
  const float fdd1 = __int2float_rn(static_cast<int>(static_cast<unsigned>(dd) + 1u));
  const int ilog = (__float_as_int(fdd1) >> 23) - 127;
  const float gap_cost = __fmaf_rn(gap_scale, __int2float_rn(dd),
                                   __fmul_rn(0.5f, __int2float_rn(ilog)));
  return __fsub_rn(__fadd_rn(fb, match), gap_cost);
}

__global__ void chain_scan_kernel(const int* __restrict__ qpos,
                                  const int* __restrict__ rpos,
                                  const int* __restrict__ group,
                                  float* __restrict__ f_out,
                                  int* __restrict__ p_out,
                                  int B, int n, int lookback, int k,
                                  float max_dist, float max_gap_diff,
                                  float gap_scale) {
  const int lane = threadIdx.x & 31;
  const int slab = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (slab >= B) return;                  // the whole warp leaves together
  const size_t base = static_cast<size_t>(slab) * n;
  const float neg = -1e18f;               // the reference's NEG in float32
  const float kf = __int2float_rn(k);
  const bool live0 = lane < lookback;
  const bool live1 = lane + 32 < lookback;

  // Ring slots lane (0) and lane + 32 (1); empty slots hold the
  // reference's initial buffer values.
  int q0 = 0, r0 = 0, g0 = -1, i0 = -1;
  int q1 = 0, r1 = 0, g1 = -1, i1 = -1;
  float f0 = neg, f1 = neg;
  int slot = 0;                           // ring slot of the next anchor

  for (int c0 = 0; c0 < n; c0 += 32) {
    const int a = c0 + lane;
    int cq = 0, cr = 0, cg = kPadGroup;
    if (a < n) {
      cq = qpos[base + a];
      cr = rpos[base + a];
      cg = group[base + a];
    }
    float my_f = 0.f;
    int my_p = -1;
    const int cnt = min(32, n - c0);
    for (int t = 0; t < cnt; ++t) {
      const int q = __shfl_sync(kFull, cq, t);
      const int r = __shfl_sync(kFull, cr, t);
      const int g = __shfl_sync(kFull, cg, t);
      float bc = live0 ? slot_cand(q, r, g, q0, r0, g0, f0, k, max_dist,
                                   max_gap_diff, gap_scale, neg)
                       : __int_as_float(static_cast<int>(0xff800000u));  // -inf
      int bi = live0 ? i0 : kNoAnchor;
      if (live1) {
        const float c1 = slot_cand(q, r, g, q1, r1, g1, f1, k, max_dist,
                                   max_gap_diff, gap_scale, neg);
        if (better(c1, i1, bc, bi)) {
          bc = c1;
          bi = i1;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float oc = __shfl_xor_sync(kFull, bc, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (better(oc, oi, bc, bi)) {
          bc = oc;
          bi = oi;
        }
      }
      const bool use = bc > kf;           // extending must beat starting fresh
      const float f = use ? bc : kf;
      const int i = c0 + t;
      if (lane == t) {
        my_f = f;
        my_p = use ? bi : -1;
      }
      if (slot == lane) {
        q0 = q; r0 = r; g0 = g; f0 = f; i0 = i;
      } else if (slot == lane + 32) {
        q1 = q; r1 = r; g1 = g; f1 = f; i1 = i;
      }
      slot = slot + 1 == lookback ? 0 : slot + 1;
    }
    if (a < n) {
      f_out[base + a] = my_f;
      p_out[base + a] = my_p;
    }
  }
}

}  // namespace

extern "C" int pav_chain_scan(const void* qpos, const void* rpos,
                              const void* group, void* f, void* parent, int B,
                              int n, int lookback, int k, float max_dist,
                              float max_gap_diff, float gap_scale,
                              void* stream) {
  if (B == 0 || n == 0) return 0;
  if (lookback < 1 || lookback > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = 4;                    // slabs per block
  const int blocks = (B + warps - 1) / warps;
  chain_scan_kernel<<<blocks, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qpos), static_cast<const int*>(rpos),
      static_cast<const int*>(group), static_cast<float*>(f),
      static_cast<int*>(parent), B, n, lookback, k, max_dist, max_gap_diff,
      gap_scale);
  return static_cast<int>(cudaGetLastError());
}
