// Chain scan: minimap2-style anchor chaining DP over a batch of slabs.
//
// Replaces the XLA lax.scan of pav_tpu/ops/chain_scan.py::_chain_scan
// (:19-68), vmapped by _chain_scan_batch (:71-82). For anchor i of a slab:
//   cand_t = (f_t + min(dq, dr, k)) - (gap_scale*dd + 0.5*ilog2(dd + 1))
// over the previous `lookback` anchors t of the same group with dq, dr > 0,
// dq, dr <= max_dist and dd = |dr - dq| <= max_gap_diff (compared in
// float32, as the jitted scan does); f_i = best cand if it beats k (parent
// = the oldest t reaching it), else k with parent -1. Bit-identical to the
// plain version (_chain_scan_ref) and to the reference: every score is
// float32, the gap cost is ONE fused multiply-add (__fmaf_rn; XLA on the CPU
// and native/chain.cpp both fuse it, and two roundings differ at some dd),
// and cand rounds twice, __fsub_rn(__fadd_rn(f, match), gap), so nvcc
// contracts nothing else.
//
// What bounds it on an H100: the recurrence is sequential per slab, so a
// slab is n dependent steps on one warp. Only f_t is new at step t; every
// other term of a candidate (validity, match, ilog, gap cost) is known from
// the inputs. So the kernel pushes rather than pulls: when f_t is final,
// each pending successor i in (t, t + lookback] folds in its candidate
// against t into a running best (strict >, so with folds arriving oldest
// first the oldest maximum stays: the reference's first-index argmax over
// its oldest-first buffer). The serial step is one shuffle of f_t, an add,
// a subtract and a max; the pair terms are computed beside it, off the
// chain. A step then issues ~65 instructions a lane (two pairs of ~25, their
// folds, the finalise), at about 100 cycles a step: the issue of one warp,
// not the serial chain (~43 cycles; pav_chain_step_probe measures it).
//
// Design: one warp per slab, lane l owning the anchors i = l (mod 32). At
// step t of chunk c (t = 32c + s), the pending anchors of lane l are those
// of slots N (anchor 32(c+1) + l) and C (anchor 32c + l while l > s; at
// s == l it is final, its result kept for the chunk's coalesced store, and
// the slot reads anchor 32(c+2) + l from then on). After 32 steps C and N
// trade places. The pair terms of step s + 1 are computed in step s, beside
// step s's fold, so the serial chain and the pair arithmetic overlap; with
// the engine's lookback of 64 every pair is pending and the pending test
// drops out. The chunk's anchors are staged in shared memory, so every lane
// reads anchor t with one broadcast load; the coordinates two chunks ahead
// are loaded a chunk early. Slabs are independent warps with no barrier
// between them: one warp a block up to one slab an SM, four above.
//
// Conversions: int -> float (I2F) runs at a quarter of the float rate. When
// 1 <= k and max_dist, max_gap_diff lie in [0, 2^23), every conversion and
// comparison a valid pair needs has an exact full-rate form: float(x) <= M
// is x <= floor(M) for x > 0 (float(x) is exact to 2^24 and above M beyond
// it), and 0 <= dd, match < 2^23 convert exactly through the exponent bias
// (0x4B000000). Other limits take the I2F forms, as the reference states
// them.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadGroup = -9;
constexpr int kSlabsPerBlock = 4;

// Wrapping int32 arithmetic (the reference's int32 scan wraps; signed
// overflow is undefined in C++).
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

// float(x) for 0 <= x < 2^23, exactly: 2^23 + x has x as its mantissa.
__device__ __forceinline__ float small_to_float(int x) {
  return __fsub_rn(__int_as_float(0x4B000000 + x), 8388608.0f);
}

struct Limits {
  int k;
  int lookback;
  float max_dist, max_gap_diff, gap_scale;
  int td, tg;                       // floor(max_dist), floor(max_gap_diff)
};

// The terms of the pair (anchor i, anchor t): its match and gap cost. The
// gap cost is +inf where t is not a valid predecessor of i (or not pending),
// so the candidate is -inf (or NaN from a garbage match), which never wins.
template <bool kFast>
__device__ __forceinline__ void pair_terms(int qi, int ri, int gi, int qt, int rt,
                                           int gt, bool pending, const Limits& lim,
                                           float& match, float& gap) {
  const int dq = wsub(qi, qt);
  const int dr = wsub(ri, rt);
  const int dd = wabs(wsub(dr, dq));
  const int mt = min(min(dq, dr), lim.k);
  bool ok;
  float fdd, half_ilog;
  if (kFast) {
    // Exact for every valid pair: 1 <= dq, dr <= td, 0 <= dd <= tg < 2^23.
    ok = pending && gi == gt && dq > 0 && dr > 0 && dq <= lim.td && dr <= lim.td
         && dd <= lim.tg;
    fdd = small_to_float(dd);
    match = small_to_float(mt);
    // Biased exponent of float(dd + 1) = 127 + ilog; 0.5 * ilog exactly,
    // as 0.5 * (2^23 + ilog) - 2^22 in one rounding.
    const int e = __float_as_int(__fadd_rn(fdd, 1.0f)) >> 23;
    half_ilog = __fmaf_rn(0.5f, __int_as_float(0x4B000000 - 127 + e), -4194304.0f);
  } else {
    fdd = __int2float_rn(dd);
    ok = pending && gi == gt && dq > 0 && dr > 0
         && __int2float_rn(dq) <= lim.max_dist && __int2float_rn(dr) <= lim.max_dist
         && fdd <= lim.max_gap_diff;
    match = __int2float_rn(mt);
    const float fdd1 = __int2float_rn(static_cast<int>(static_cast<unsigned>(dd) + 1u));
    const int ilog = (__float_as_int(fdd1) >> 23) - 127;
    half_ilog = __fmul_rn(0.5f, __int2float_rn(ilog));
  }
  const float g = __fmaf_rn(lim.gap_scale, fdd, half_ilog);
  gap = ok ? g : __int_as_float(0x7f800000);      // +inf
}

__device__ __forceinline__ void load_anchor(const int* __restrict__ qpos,
                                            const int* __restrict__ rpos,
                                            const int* __restrict__ group,
                                            size_t base, int a, int n, int& q,
                                            int& r, int& g) {
  if (a < n) {
    q = qpos[base + a];
    r = rpos[base + a];
    g = group[base + a];
  } else {
    q = 0;
    r = 0;
    g = kPadGroup;
  }
}

// kFast: the exact full-rate forms (see the top); kAll: lookback 64, so
// every pair of a step is pending.
template <bool kFast, bool kAll>
__global__ void __launch_bounds__(32 * kSlabsPerBlock)
chain_scan_kernel(const int* __restrict__ qpos, const int* __restrict__ rpos,
                  const int* __restrict__ group, float* __restrict__ f_out,
                  int* __restrict__ p_out, int B, int n, Limits lim) {
  __shared__ int4 stage[kSlabsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = blockIdx.x * (blockDim.x >> 5) + warp;
  if (slab >= B) return;
  const size_t base = static_cast<size_t>(slab) * n;
  const float kf = __int2float_rn(lim.k);
  const float ninf = __int_as_float(static_cast<int>(0xff800000u));
  int qC, rC, gC, qN, rN, gN, qF, rF, gF, qG, rG, gG;
  load_anchor(qpos, rpos, group, base, lane, n, qC, rC, gC);
  load_anchor(qpos, rpos, group, base, 32 + lane, n, qN, rN, gN);
  load_anchor(qpos, rpos, group, base, 64 + lane, n, qF, rF, gF);
  // b*: the running best candidate, i*: its anchor. The exact path keeps
  // max(best, k) instead, so f_t is b* itself and the serial chain is a
  // shuffle, an add, a subtract and a max; the index still moves only on a
  // strict >, so it is the oldest maximum wherever that beats k.
  const float b0 = kFast ? kf : ninf;
  float bC = b0, bN = b0;
  int iC = -1, iN = -1;
  for (int c0 = 0; c0 < n; c0 += 32) {
    load_anchor(qpos, rpos, group, base, c0 + 96 + lane, n, qG, rG, gG);
    stage[warp][lane] = make_int4(qC, rC, gC, 0);
    __syncwarp();
    float mN, gapN, mC, gapC;
    {
      const int4 at = stage[warp][0];
      const bool rot = lane == 0;
      pair_terms<kFast>(qN, rN, gN, at.x, at.y, at.z, kAll || 32 + lane <= lim.lookback,
                        lim, mN, gapN);
      pair_terms<kFast>(rot ? qF : qC, rot ? rF : rC, rot ? gF : gC, at.x, at.y, at.z,
                        kAll || (rot ? 64 : lane) <= lim.lookback, lim, mC, gapC);
    }
    float my_f = 0.f;
    int my_p = -1;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const int t = c0 + s;
      // f_t: owned by lane s, slot C.
      const bool use = bC > kf;
      const float fl = kFast || use ? bC : kf;
      const float ft = __shfl_sync(kFull, fl, s);
      if (lane == s) {
        my_f = fl;
        my_p = use ? iC : -1;
        bC = b0;
        iC = -1;
      }
      float nmN = 0.f, ngN = 0.f, nmC = 0.f, ngC = 0.f;
      if (s + 1 < 32) {
        const int4 at = stage[warp][s + 1];
        const bool rot = lane <= s + 1;
        pair_terms<kFast>(qN, rN, gN, at.x, at.y, at.z,
                          kAll || 32 + lane - (s + 1) <= lim.lookback, lim, nmN, ngN);
        pair_terms<kFast>(rot ? qF : qC, rot ? rF : rC, rot ? gF : gC, at.x, at.y, at.z,
                          kAll || (lane > s + 1 ? lane - s - 1 : 63 + lane - s)
                                      <= lim.lookback,
                          lim, nmC, ngC);
      }
      // The folds (a NaN candidate, from a masked pair, never wins).
      const float cN = __fsub_rn(__fadd_rn(ft, mN), gapN);
      const float cC = __fsub_rn(__fadd_rn(ft, mC), gapC);
      iN = cN > bN ? t : iN;
      iC = cC > bC ? t : iC;
      if (kFast) {
        bN = fmaxf(bN, cN);
        bC = fmaxf(bC, cC);
      } else {
        bN = cN > bN ? cN : bN;
        bC = cC > bC ? cC : bC;
      }
      mN = nmN; gapN = ngN; mC = nmC; gapC = ngC;
    }
    const int a = c0 + lane;
    if (a < n) {
      f_out[base + a] = my_f;
      p_out[base + a] = my_p;
    }
    __syncwarp();
    qC = qN; rC = rN; gC = gN;
    qN = qF; rN = rF; gN = gF;
    int ti = iC; iC = iN; iN = ti;
    const float tf = bC; bC = bN; bN = tf;
    qF = qG;
    rF = rG;
    gF = gG;
  }
}

// The least dependent latency of one step: a shuffle of f, an add, a
// subtract and a max, each waiting for the one before (the kernel's serial
// step adds a compare-select). One warp, `iters` steps.
__global__ void chain_step_probe_kernel(float* out, int iters, float a, float b) {
  float f = out[threadIdx.x];
  for (int i = 0; i < iters; ++i) {
    const float ft = __shfl_sync(kFull, f, i & 31);
    f = fmaxf(__fsub_rn(__fadd_rn(ft, a), b), f);
  }
  out[threadIdx.x] = f;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || count <= 0)
      count = 132;
  }
  return count;
}

}  // namespace

extern "C" int pav_chain_scan(const void* qpos, const void* rpos,
                              const void* group, void* f, void* parent, int B,
                              int n, int lookback, int k, float max_dist,
                              float max_gap_diff, float gap_scale,
                              void* stream) {
  if (B == 0 || n == 0) return 0;
  if (lookback < 1 || lookback > 64) return static_cast<int>(cudaErrorInvalidValue);
  Limits lim{k, lookback, max_dist, max_gap_diff, gap_scale, 0, 0};
  constexpr float kExact = 8388608.0f;     // 2^23
  const bool fast = k >= 1 && k < (1 << 23) && max_dist >= 0.f && max_dist < kExact
                    && max_gap_diff >= 0.f && max_gap_diff < kExact;
  if (fast) {
    lim.td = static_cast<int>(floorf(max_dist));
    lim.tg = static_cast<int>(floorf(max_gap_diff));
  }
  // One slab a block spreads the slabs over the SMs; beyond one slab an SM,
  // four slabs a block (one a scheduler).
  const int per_block = B <= sm_count() ? 1 : kSlabsPerBlock;
  const int blocks = (B + per_block - 1) / per_block;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int*>(qpos);
  const auto* r = static_cast<const int*>(rpos);
  const auto* g = static_cast<const int*>(group);
  auto* fo = static_cast<float*>(f);
  auto* po = static_cast<int*>(parent);
  if (fast && lookback == 64)
    chain_scan_kernel<true, true><<<blocks, 32 * per_block, 0, s>>>(q, r, g, fo, po, B, n, lim);
  else if (fast)
    chain_scan_kernel<true, false><<<blocks, 32 * per_block, 0, s>>>(q, r, g, fo, po, B, n, lim);
  else
    chain_scan_kernel<false, false><<<blocks, 32 * per_block, 0, s>>>(q, r, g, fo, po, B, n, lim);
  return static_cast<int>(cudaGetLastError());
}

// One warp of `iters` dependent steps (chain_step_probe_kernel) on out[32].
extern "C" int pav_chain_step_probe(void* out, int iters, void* stream) {
  chain_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters, 1.0f, 0.5f);
  return static_cast<int>(cudaGetLastError());
}
