// Row-banded global alignment with two-piece affine gaps: traceback tape,
// band offsets and the last row's scores.
//
// Replaces pav_tpu/ops/affine_dp.py::_align_batch, the row-banded DP that
// the reference runs on its CPU class ladder and in its entry points
// (__graft_entry__.py: entry() and dryrun_multichip's device step). Not a
// pl.pallas_call: an XLA scan over rows. For every item b and row
// i = 1..max_m the band is a window of `width` columns starting at
//   offs[b][i-1] = clip(i*n // m - width/2, 0, max(n + 1 - width, 0))
// (i*n in wrapping int32, floor division, n and m the item's own lengths);
// the kernel writes one byte per window cell in the layout of
// affine_dp.py:14-22 into tb[b][i-1][w], the offset into offs[b][i-1], and
// the masked H of row max_m into score[b][w]. Cells past n or past m are
// computed and written as the reference does (their state becomes NEG), so
// every output byte compares bit for bit with dp_kernels.align_band_ref.
//
// The recurrence, per window column w (global column j = off + w):
//  * the previous row's H, E1 and E2 are read at w + s (H also at
//    w + s - 1 for the diagonal), s = offs[i-1] - offs[i-2]; lanes shifted
//    in from outside the previous window read NEG; row 1 reads the
//    analytic row 0, H[0][j] = -min(o1 + j e1, o2 + j e2) for 0 <= j <= n;
//  * the substitution is an int8 (match or mismatch), with -128 as the
//    sentinel of global column 0, which is never a diagonal target;
//  * F is an exclusive prefix max over the window of Htilde + w e: NEG at
//    w = 0 and not clamped at NEG elsewhere (align_full clamps, this one
//    does not), and "opened at the left cell" is exact equality with the
//    left cell's term, true at w = 0.
//
// What bounds it on an H100: as in dp_full, rows are dependent and a row's
// only cross-column dependence is F's prefix max, about 45 int32 operations
// a cell against one tape byte written: integer issue, not HBM. An item runs
// on one warp (widths up to 256) or one block (wider), so an item's rows go
// at the rate of one SM.
//
// Design (a first kernel, simple before fast). Lane t of an item owns the C
// consecutive window columns w = t*C + c. The previous row's H, E1 and E2
// live in shared memory, double-buffered by row parity, because the shift s
// changes from row to row (in global scratch when 24 bytes a column do not
// fit, widths above 9664). A row is two passes over the lane's columns:
// pass 1 reads the shifted state, computes E, the diagonal and Htilde, and
// writes E; an exclusive max-scan of the lane maxima (shuffles in a warp;
// across warps, each warp's total and last Htilde published in shared
// memory behind one barrier) gives each lane the running max to its left;
// pass 2 finishes F, H and the byte, written straight to the tape. A second
// barrier ends the row. dp_band_kernel<C, true> runs four items a block,
// one a warp, with no block barrier; <C, false> one item a block.

#include <climits>

#include "common.cuh"

using pav::imax;
using pav::imin;
using pav::NEG;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpItems = 4;        // items (warps) per block of the warp kernel
constexpr int kPub = 4;              // ints a warp publishes per row
constexpr int kMaxWidth = 65536;     // widths up to this (C = 64 at 1024 lanes)

struct Scoring {
  int match, mismatch, o1, o2, e1, e2;
};

__device__ __forceinline__ int bit(bool x, int k) { return static_cast<int>(x) << k; }

// H of the analytic row 0 at global column j (NEG outside 0..n).
__device__ __forceinline__ int row0(int j, int ni, const Scoring& s) {
  if (j < 0 || j > ni) return NEG;
  return j == 0 ? 0 : -pav::gap_cost(j, s.o1, s.o2, s.e1, s.e2);
}

// Band offset of row i: clip(floor(wrap32(i*n) / m) - width/2, 0, max_off).
__device__ __forceinline__ int band_offset(int i, int mi, int ni, int half, int max_off) {
  int center = 0;
  if (mi > 0) {
    const int prod = static_cast<int>(static_cast<unsigned>(i) * static_cast<unsigned>(ni));
    center = prod / mi;
    if (prod % mi != 0 && prod < 0) --center;
  }
  return imin(imax(center - half, 0), max_off);
}

// Ints of per-item state: [2 parities][H, E1, E2][stride].
__host__ __device__ __forceinline__ int state_stride(int width) { return (width + 3) & ~3; }
__host__ __device__ __forceinline__ size_t state_ints(int width) {
  return static_cast<size_t>(6) * state_stride(width);
}

template <int C, bool WARP>
__global__ void __launch_bounds__(1024)
dp_band_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
               const int* __restrict__ m, const int* __restrict__ n,
               int* __restrict__ score, uint8_t* __restrict__ tb, int* __restrict__ offs,
               int* __restrict__ gstate, int B, int max_m, int max_n, int width, Scoring s) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = state_stride(width);
  int b, t;
  int* st;
  int* pub = smem;                          // [warps][kPub] (block kernel only)
  if (WARP) {
    b = blockIdx.x * kWarpItems + warp;
    if (b >= B) return;                     // the whole warp leaves together
    t = lane;
    st = smem + static_cast<size_t>(warp) * state_ints(width);
  } else {
    b = blockIdx.x;
    t = threadIdx.x;
    st = gstate != nullptr ? gstate + static_cast<size_t>(b) * state_ints(width)
                           : smem + 32 * kPub;
  }
  const int mi = m[b], ni = n[b];
  const int half = width / 2;
  const int max_off = imax(ni + 1 - width, 0);
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  uint8_t* tbb = tb + static_cast<size_t>(b) * max_m * width;
  const int w0 = t * C;
  const int8_t match8 = static_cast<int8_t>(s.match), mismatch8 = static_cast<int8_t>(s.mismatch);

  int off_prev = 0;
  for (int i = 1; i <= max_m; ++i) {
    const int off = band_offset(i, mi, ni, half, max_off);
    const int sh = off - off_prev;
    off_prev = off;
    if (t == 0) offs[static_cast<size_t>(b) * max_m + i - 1] = off;
    const int qi = qb[i - 1];
    const bool row_ok = i <= mi;
    const int* Hp = st + ((i - 1) & 1) * 3 * stride;
    const int* E1p = Hp + stride;
    const int* E2p = Hp + 2 * stride;
    int* Hc = st + (i & 1) * 3 * stride;
    int* E1c = Hc + stride;
    int* E2c = Hc + 2 * stride;

    // Pass 1: E, diagonal, Htilde, the E-side bits; lane maxima of
    // Htilde + w*e (INT_MIN, the max's identity, where no column is).
    int HT[C], bits[C];
    int m1 = INT_MIN, m2 = INT_MIN;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      HT[c] = NEG;
      bits[c] = 0;
      if (w < width) {
        const int j = off + w;
        int hup, hdg, e1u, e2u;
        if (i == 1) {
          hup = row0(j, ni, s);
          hdg = row0(j - 1, ni, s);
          e1u = NEG;
          e2u = NEG;
        } else {
          const int k = w + sh;
          const bool in_up = k >= 0 && k < width, in_dg = k >= 1 && k <= width;
          hup = in_up ? Hp[k] : NEG;
          e1u = in_up ? E1p[k] : NEG;
          e2u = in_up ? E2p[k] : NEG;
          hdg = in_dg ? Hp[k - 1] : NEG;
        }
        const int e1o = hup - (s.o1 + s.e1), e1x = e1u - s.e1, e1n = imax(e1o, e1x);
        const int e2o = hup - (s.o2 + s.e2), e2x = e2u - s.e2, e2n = imax(e2o, e2x);
        const int eb = imax(e1n, e2n);
        const int rj = __ldg(rb + imin(imax(j - 1, 0), max_n - 1));
        const int8_t sub = (qi == rj && qi < 4 && rj < 4) ? match8 : mismatch8;
        const int diag = (j < 1 || sub == -128) ? NEG : hdg + sub;
        const int ht = imax(diag, eb);
        HT[c] = ht;
        bits[c] = bit(eb > diag, 0) | bit(e2n > e1n, 2) | bit(e1x > e1o, 4) | bit(e2x > e2o, 5);
        const bool valid = row_ok && j <= ni;
        E1c[w] = valid ? e1n : NEG;
        E2c[w] = valid ? e2n : NEG;
        m1 = imax(m1, ht + w * s.e1);
        m2 = imax(m2, ht + w * s.e2);
      }
    }

    // Exclusive max-scan of (m1, m2) over the item's lanes.
    int v1 = m1, v2 = m2;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(kFull, v1, d);
      const int c = __shfl_up_sync(kFull, v2, d);
      if (lane >= d) {
        v1 = imax(v1, a);
        v2 = imax(v2, c);
      }
    }
    int ex1 = __shfl_up_sync(kFull, v1, 1);
    int ex2 = __shfl_up_sync(kFull, v2, 1);
    int htp = __shfl_up_sync(kFull, HT[C - 1], 1);   // Htilde of column w0 - 1
    if (lane == 0) {
      ex1 = INT_MIN;
      ex2 = INT_MIN;
    }
    if (!WARP) {
      if (lane == 31) {
        pub[warp * kPub + 0] = v1;
        pub[warp * kPub + 1] = v2;
        pub[warp * kPub + 2] = HT[C - 1];
      }
      __syncthreads();
      for (int k = 0; k < warp; ++k) {
        ex1 = imax(ex1, pub[k * kPub + 0]);
        ex2 = imax(ex2, pub[k * kPub + 1]);
      }
      if (lane == 0 && warp > 0) htp = pub[(warp - 1) * kPub + 2];
    }

    // Pass 2: F from the running max, H, the F-side bits; the byte out.
    int run1 = ex1, run2 = ex2;
    int pa1 = htp + (w0 - 1) * s.e1, pa2 = htp + (w0 - 1) * s.e2;
    uint8_t* row = tbb + static_cast<size_t>(i - 1) * width;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      if (w < width) {
        const int ht = HT[c];
        const int a1 = ht + w * s.e1, a2 = ht + w * s.e2;
        const int p1 = w == 0 ? NEG : run1, p2 = w == 0 ? NEG : run2;
        const int f1 = p1 - s.o1 - w * s.e1, f2 = p2 - s.o2 - w * s.e2;
        const int fb = imax(f1, f2);
        const int hn = imax(ht, fb);
        const bool op1 = w == 0 || p1 == pa1, op2 = w == 0 || p2 == pa2;
        row[w] = static_cast<uint8_t>(bits[c] | bit(fb > ht, 1) | bit(f2 > f1, 3) |
                                      bit(op1, 6) | bit(op2, 7));
        const int h = (row_ok && off + w <= ni) ? hn : NEG;
        Hc[w] = h;
        if (i == max_m) score[static_cast<size_t>(b) * width + w] = h;
        run1 = imax(run1, a1);
        run2 = imax(run2, a2);
        pa1 = a1;
        pa2 = a2;
      }
    }
    if (WARP) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
}

template <int C>
cudaError_t launch_warp(const int8_t* q, const int8_t* r, const int* m, const int* n,
                        int* score, uint8_t* tb, int* offs, int B, int max_m, int max_n,
                        int width, const Scoring& s, cudaStream_t stream) {
  const size_t smem = kWarpItems * state_ints(width) * sizeof(int);
  const int grid = (B + kWarpItems - 1) / kWarpItems;
  dp_band_kernel<C, true><<<grid, 32 * kWarpItems, smem, stream>>>(
      q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width, s);
  return cudaGetLastError();
}

size_t block_smem(int width, bool in_shared) {
  return (32 * kPub + (in_shared ? state_ints(width) : 0)) * sizeof(int);
}

template <int C>
cudaError_t launch_block(const int8_t* q, const int8_t* r, const int* m, const int* n,
                         int* score, uint8_t* tb, int* offs, int* scratch, int B, int max_m,
                         int max_n, int width, const Scoring& s, cudaStream_t stream) {
  const int lanes = (width + C - 1) / C;
  const int T = 32 * ((lanes + 31) / 32);
  const size_t smem = block_smem(width, scratch == nullptr);
  cudaError_t err = pav::set_smem(dp_band_kernel<C, false>, smem);
  if (err != cudaSuccess) return err;
  dp_band_kernel<C, false><<<B, T, smem, stream>>>(q, r, m, n, score, tb, offs, scratch, B,
                                                   max_m, max_n, width, s);
  return cudaGetLastError();
}

}  // namespace

// Ints of global scratch per item: 0 where the state fits in shared memory.
extern "C" int pav_dp_band_scratch_ints(int width) {
  if (width <= 256 || block_smem(width, true) <= static_cast<size_t>(pav::kMaxSmem)) return 0;
  return static_cast<int>(state_ints(width));
}

extern "C" int pav_dp_band(const void* q_, const void* r_, const void* m_, const void* n_,
                           void* score_, void* tb_, void* offs_, void* scratch, int B,
                           int max_m, int max_n, int width, int match, int mismatch, int o1,
                           int o2, int e1, int e2, void* stream_) {
  if (B == 0) return 0;
  if (width < 1 || width > max_n + 1 || width > kMaxWidth || max_m < 1 ||
      max_n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* q = static_cast<const int8_t*>(q_);
  const auto* r = static_cast<const int8_t*>(r_);
  const auto* m = static_cast<const int*>(m_);
  const auto* n = static_cast<const int*>(n_);
  auto* score = static_cast<int*>(score_);
  auto* tb = static_cast<uint8_t*>(tb_);
  auto* offs = static_cast<int*>(offs_);
  auto stream = static_cast<cudaStream_t>(stream_);
  const Scoring s{match, mismatch, o1, o2, e1, e2};
  if (width <= 32) return launch_warp<1>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (width <= 64) return launch_warp<2>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (width <= 128) return launch_warp<4>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (width <= 256) return launch_warp<8>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  auto* st = static_cast<int*>(scratch);
  if (pav_dp_band_scratch_ints(width) == 0) {
    st = nullptr;
  } else if (st == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width <= 2048) {
    return launch_block<4>(q, r, m, n, score, tb, offs, st, B, max_m, max_n, width, s, stream);
  }
  if (width <= 8192) {
    return launch_block<8>(q, r, m, n, score, tb, offs, st, B, max_m, max_n, width, s, stream);
  }
  if (width <= 32768) {
    return launch_block<32>(q, r, m, n, score, tb, offs, st, B, max_m, max_n, width, s, stream);
  }
  return launch_block<64>(q, r, m, n, score, tb, offs, st, B, max_m, max_n, width, s, stream);
}
