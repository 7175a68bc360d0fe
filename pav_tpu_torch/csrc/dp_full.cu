// Full-width global alignment with two-piece affine gaps: traceback tape.
//
// Replaces pav_tpu/ops/pallas_dp.py::_dp_kernel (launched by
// pallas_align_full), and computes the same tape as
// pav_tpu/ops/affine_dp.py::_align_batch at offset 0: for every item b and
// row i = 1..max_m, one byte per column j = 0..width-1 (width = max_n + 1)
// in the layout of affine_dp.py:14-22, into tb[b][i-1][j]. Rows past m and
// columns past n are computed and stored as the reference does (from NEG
// state), so whole tapes compare bit for bit.
//
// What bounds it on an H100: the row loop is sequential, so per item the
// work is max_m dependent steps; inside a row, every column is independent
// except the horizontal gap F, an exclusive prefix max over the row. About
// 40 int32 operations per cell against one tape byte written per cell: the
// kernel is bound by integer issue (64 INT32 lanes per SM), not by HBM.
// One item is one block, so an item's rows run at the rate of one SM: at
// width 2049 a row costs about 1.2 us, the integer pipe of the SM being the
// limit, and a batch smaller than the card (the main path's 2048 x 2049
// class comes at B = 8) leaves the other SMs idle. The first design lost rate
// besides: one 32-thread block per small item (half the lanes idle at width
// 17, half the SM's warp slots empty), the per-column state loaded and
// stored in shared memory on every row, two block barriers per row even for
// a single warp, and tape bytes assembled by read-modify-write.
//
// Design. Every lane owns C consecutive columns j = 1 + u*C + c (u = its
// index in the item) and keeps their H, E1, E2 and Htilde in registers for
// the whole row loop; column 0 is computed by every lane of the item's
// first warp. A row is two passes over the lane's columns: pass 1 computes
// E, the diagonal and Htilde and the lane's max of Htilde + j*e for both
// gap pieces; an exclusive max-scan over lanes by __shfl_up_sync gives
// every lane the running max of the columns to its left; pass 2 finishes F,
// H and the byte. The left neighbours (H of the previous row, Htilde of
// this row) come by one shuffle each. F "opened at the previous column" is
// run == Htilde[j-1] + (j-1)*e, exact in int32, and column 0 is always
// opened, as in the reference.
//  * dp_full_warp<S, C> (widths up to 257): one item per S-lane group,
//    32/S items per warp, 4 warps per block, no block barrier at all. At
//    width 17, two items share a warp and every lane owns one column.
//  * dp_full_block<C> (widths 258..4097; C = 4 up to 513, then 8): one item
//    per block of W warps, one block barrier per row: before it, each warp
//    publishes the max of its strip, its running max before its last column
//    and its last Htilde (double-buffered by row parity); after it, lane x
//    of each warp reads warp x's values and a shuffle reduction gives the
//    maxima of the warps to its left. The boundary H that warp w needs at
//    the next row (H[i][j0-1], on warp w-1) it computes itself from those
//    values, so a row needs no second barrier.
//  * widths above 4097 (the unbalanced 512 x 8192 and 16..128 x 32768
//    classes, off the main path): the first design, its state in shared
//    memory up to width 8193 and in global scratch above
//    (dp_full_wide_kernel).
// Tape rows are staged in shared memory (R rows per chunk, placed so that
// shared and global addresses agree mod 16) and written out as 16-byte
// stores: by the warp for its items (dp_full_warp), and by the whole block
// one chunk behind the row loop (dp_full_block, two chunk buffers).

#include <climits>

#include "common.cuh"

using pav::imax;
using pav::NEG;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpBlock = 128;            // threads per dp_full_warp block
constexpr int kBlockCols = 4096;           // dp_full_block up to width 4097
constexpr int kSmemBudget = 100 * 1024;    // shared memory of a dp_full_block

struct Scoring {
  int match, mismatch, o1, o2, e1, e2;
};

__device__ __forceinline__ int bit(bool x, int k) { return static_cast<int>(x) << k; }

// Column 0 of one row, from the column's state of the previous row (each
// lane that needs it keeps a copy). Returns the tape byte, sets
// ht0 = Htilde[i][0].
__device__ __forceinline__ int col0_step(int& h, int& e1s, int& e2s, bool row_ok,
                                         const Scoring& s, int& ht0) {
  const int e1o = h - (s.o1 + s.e1), e1x = e1s - s.e1, e1n = imax(e1o, e1x);
  const int e2o = h - (s.o2 + s.e2), e2x = e2s - s.e2, e2n = imax(e2o, e2x);
  const int eb = imax(e1n, e2n);
  ht0 = imax(NEG, eb);                       // the diagonal is NEG at j = 0
  const int f1 = NEG - s.o1, f2 = NEG - s.o2;  // F from an empty prefix
  const int fb = imax(f1, f2);
  const int hn = imax(ht0, fb);
  h = row_ok ? hn : NEG;
  e1s = row_ok ? e1n : NEG;
  e2s = row_ok ? e2n : NEG;
  return bit(eb > NEG, 0) | bit(fb > ht0, 1) | bit(e2n > e1n, 2) | bit(f2 > f1, 3) |
         bit(e1x > e1o, 4) | bit(e2x > e2o, 5) | 0xc0;
}

// Pass 1 over the lane's columns j0..j0+C-1: E, diagonal, Htilde, the
// E-side tape bits; m = max of Htilde + j*e over the columns, x = the same
// over all but the last. hl is H[i-1][j0-1].
template <int C>
__device__ __forceinline__ void pass1(int (&H)[C], int (&E1)[C], int (&E2)[C], int (&HT)[C],
                                      int (&bits)[C], const int (&rq)[C], int qx, int hl,
                                      int j0, unsigned colv, bool row_ok, const Scoring& s,
                                      int& m1, int& m2, int& x1, int& x2) {
  m1 = NEG;
  m2 = NEG;
  x1 = NEG;
  x2 = NEG;
  const unsigned vm = row_ok ? colv : 0u;
  const int j0e1 = j0 * s.e1, j0e2 = j0 * s.e2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int je1 = j0e1 + c * s.e1, je2 = j0e2 + c * s.e2;   // j*e
    const int hup = H[c];
    const int e1o = hup - (s.o1 + s.e1), e1x = E1[c] - s.e1, e1n = imax(e1o, e1x);
    const int e2o = hup - (s.o2 + s.e2), e2x = E2[c] - s.e2, e2n = imax(e2o, e2x);
    const int eb = imax(e1n, e2n);
    const int diag = hl + (qx == rq[c] ? s.match : s.mismatch);
    hl = hup;
    const int ht = imax(diag, eb);
    HT[c] = ht;
    bits[c] = bit(eb > diag, 0) | bit(e2n > e1n, 2) | bit(e1x > e1o, 4) | bit(e2x > e2o, 5);
    const bool valid = (vm >> c) & 1u;
    E1[c] = valid ? e1n : NEG;
    E2[c] = valid ? e2n : NEG;
    if (c == C - 1) {
      x1 = m1;
      x2 = m2;
    }
    m1 = imax(m1, ht + je1);
    m2 = imax(m2, ht + je2);
  }
}

// Pass 2: F from the running max (run = max of Htilde + j'*e over j' < j),
// H, the F-side tape bits. pa = Htilde[i][j0-1] + (j0-1)*e.
template <int C>
__device__ __forceinline__ void pass2(int (&H)[C], const int (&HT)[C], int (&bits)[C],
                                      int run1, int run2, int pa1, int pa2, int j0,
                                      unsigned colv, bool row_ok, const Scoring& s) {
  const unsigned vm = row_ok ? colv : 0u;
  const int j0e1 = j0 * s.e1, j0e2 = j0 * s.e2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int je1 = j0e1 + c * s.e1, je2 = j0e2 + c * s.e2;
    const int ht = HT[c];
    const int a1 = ht + je1, a2 = ht + je2;
    const int f1 = run1 - s.o1 - je1, f2 = run2 - s.o2 - je2;
    const int fb = imax(f1, f2);
    const int hn = imax(ht, fb);
    bits[c] |= bit(fb > ht, 1) | bit(f2 > f1, 3) | bit(run1 == pa1, 6) | bit(run2 == pa2, 7);
    H[c] = ((vm >> c) & 1u) ? hn : NEG;
    run1 = imax(run1, a1);
    run2 = imax(run2, a2);
    pa1 = a1;
    pa2 = a2;
  }
}

// Exclusive max-scan of two values over the S-lane group of `l` (identity
// NEG); t = the group's total.
template <int S>
__device__ __forceinline__ void group_scan2(int v1, int v2, int l, int& x1, int& x2,
                                            int& t1, int& t2) {
#pragma unroll
  for (int d = 1; d < S; d <<= 1) {
    const int a = __shfl_up_sync(kFull, v1, d, S);
    const int c = __shfl_up_sync(kFull, v2, d, S);
    if (l >= d) {
      v1 = imax(v1, a);
      v2 = imax(v2, c);
    }
  }
  x1 = __shfl_up_sync(kFull, v1, 1, S);
  x2 = __shfl_up_sync(kFull, v2, 1, S);
  if (l == 0) {
    x1 = NEG;
    x2 = NEG;
  }
  t1 = __shfl_sync(kFull, v1, S - 1, S);
  t2 = __shfl_sync(kFull, v2, S - 1, S);
}

// Copy n staged bytes to global memory, 16 bytes a store in the middle;
// needs g and s equal mod 16. Threads `t` of `nt` (nt >= 16) share it.
__device__ __forceinline__ void copy_out(uint8_t* __restrict__ g, const uint8_t* s, int n,
                                         int t, int nt) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15));
  if (t < head) g[t] = s[t];
  const int body = (n - head) >> 4;
  uint4* gd = reinterpret_cast<uint4*>(g + head);
  const uint4* sd = reinterpret_cast<const uint4*>(s + head);
  for (int k = t; k < body; k += nt) gd[k] = sd[k];
  const int done = head + (body << 4);
  if (t < n - done) g[done + t] = s[done + t];
}

__device__ __forceinline__ int mod16(const uint8_t* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Bytes of one chunk buffer: R rows, 16 bytes of slack for the alignment
// offset, rounded up to 16.
__host__ __device__ __forceinline__ int chunk_stride(int R, int width) {
  return (R * width + 16 + 15) & ~15;
}

// Row 0 state of the lane's columns and its column mask (j <= n, j < width).
template <int C>
__device__ __forceinline__ unsigned init_cols(int (&H)[C], int (&E1)[C], int (&E2)[C], int j0,
                                              int ni, int width, const Scoring& s) {
  unsigned colv = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const bool ok = j <= ni && j < width;
    colv |= static_cast<unsigned>(ok) << c;
    H[c] = ok ? -pav::gap_cost(j, s.o1, s.o2, s.e1, s.e2) : NEG;
    E1[c] = NEG;
    E2[c] = NEG;
  }
  return colv;
}

// ---------------------------------------------------------------- warp

template <int S, int C>
__global__ void __launch_bounds__(kWarpBlock)
dp_full_warp(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
             const int* __restrict__ m, const int* __restrict__ n, uint8_t* __restrict__ tb,
             int B, int max_m, int max_n, int width, int R, Scoring s) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = 32 / S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / S, l = lane % S;
  const int item0 = (blockIdx.x * (kWarpBlock / 32) + warp) * G;
  const int b = min(item0 + g, B - 1);   // a group past B recomputes item B-1
  const int stride = chunk_stride(R, width);
  uint8_t* wbuf = smem + static_cast<size_t>(warp) * G * stride;
  uint8_t* mybuf = wbuf + g * stride;

  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  const size_t tape = static_cast<size_t>(max_m) * width;
  const int j0 = 1 + l * C;

  int H[C], E1[C], E2[C], HT[C], bits[C], rq[C];
  const unsigned colv = init_cols(H, E1, E2, j0, ni, width, s);
#pragma unroll
  for (int c = 0; c < C; ++c) rq[c] = ((colv >> c) & 1u) ? rb[j0 + c - 1] : 4;
  int h0 = 0, e10 = NEG, e20 = NEG;

  int qnext = qb[0];
  int r_in = 0, i0 = 1;   // row within the chunk, first row of the chunk
  uint8_t* row = mybuf + mod16(tb + b * tape);
  for (int i = 1; i <= max_m; ++i) {
    const int qi = qnext;
    if (i < max_m) qnext = qb[i];
    const int qx = qi < 4 ? qi : INT_MIN;
    const bool row_ok = i <= mi;

    const int h0_prev = h0;
    int ht0;
    const int byte0 = col0_step(h0, e10, e20, row_ok, s, ht0);
    int hl = __shfl_up_sync(kFull, H[C - 1], 1, S);
    if (l == 0) hl = h0_prev;
    int m1, m2, x1, x2;
    pass1(H, E1, E2, HT, bits, rq, qx, hl, j0, colv, row_ok, s, m1, m2, x1, x2);
    int ex1, ex2, t1, t2;
    group_scan2<S>(m1, m2, l, ex1, ex2, t1, t2);
    int htp = __shfl_up_sync(kFull, HT[C - 1], 1, S);
    if (l == 0) htp = ht0;
    pass2(H, HT, bits, imax(imax(ex1, ht0), NEG), imax(imax(ex2, ht0), NEG),
          htp + (j0 - 1) * s.e1, htp + (j0 - 1) * s.e2, j0, colv, row_ok, s);

    if (l == 0) row[0] = static_cast<uint8_t>(byte0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (j0 + c < width) row[j0 + c] = static_cast<uint8_t>(bits[c]);
    }
    if (r_in == R - 1 || i == max_m) {
      __syncwarp();
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const int bb = item0 + gg;
        if (bb < B) {
          uint8_t* gch = tb + bb * tape + static_cast<size_t>(i0 - 1) * width;
          copy_out(gch, wbuf + gg * stride + mod16(gch), (r_in + 1) * width, lane, 32);
        }
      }
      __syncwarp();
      i0 = i + 1;
      r_in = 0;
      row = mybuf + mod16(tb + b * tape + static_cast<size_t>(i) * width);
    } else {
      ++r_in;
      row += width;
    }
  }
}

// ---------------------------------------------------------------- block

constexpr int kPub = 6;   // ints a warp publishes per row

template <int C>
__global__ void __launch_bounds__(512)
dp_full_block(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
              const int* __restrict__ m, const int* __restrict__ n, uint8_t* __restrict__ tb,
              int max_m, int max_n, int width, int R, Scoring s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, W = T >> 5;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int b = blockIdx.x;
  int* pub = reinterpret_cast<int*>(smem);              // [2][W][kPub]
  uint8_t* stage = reinterpret_cast<uint8_t*>(pub + 2 * W * kPub);  // 2 chunk buffers
  const int stride = chunk_stride(R, width);

  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  uint8_t* tbb = tb + static_cast<size_t>(b) * max_m * width;
  const int j0 = 1 + t * C;

  int H[C], E1[C], E2[C], HT[C], bits[C], rq[C];
  const unsigned colv = init_cols(H, E1, E2, j0, ni, width, s);
#pragma unroll
  for (int c = 0; c < C; ++c) rq[c] = ((colv >> c) & 1u) ? rb[j0 + c - 1] : 4;
  int h0 = 0, e10 = NEG, e20 = NEG;   // column 0, on warp 0 only
  // H[i-1][j0-1] for lane 0 of warp w > 0 (the last column of warp w-1).
  const int jb = j0 - 1;
  int hb = (jb <= ni) ? -pav::gap_cost(jb, s.o1, s.o2, s.e1, s.e2) : NEG;

  int qnext = qb[0];
  int r_in = 0, chunk = 0;   // row within the chunk, chunk index
  uint8_t* gch = tbb;        // the chunk's first tape row
  uint8_t* row = stage + mod16(gch);
  for (int i = 1; i <= max_m; ++i) {
    const int qi = qnext;
    if (i < max_m) qnext = qb[i];
    const int qx = qi < 4 ? qi : INT_MIN;
    const bool row_ok = i <= mi;

    const int h0_prev = h0;
    int ht0 = NEG, byte0 = 0;
    if (w == 0) byte0 = col0_step(h0, e10, e20, row_ok, s, ht0);
    int hl = __shfl_up_sync(kFull, H[C - 1], 1);
    if (l == 0) hl = (w == 0) ? h0_prev : hb;
    int m1, m2, x1, x2;
    pass1(H, E1, E2, HT, bits, rq, qx, hl, j0, colv, row_ok, s, m1, m2, x1, x2);
    int ex1, ex2, t1, t2;
    group_scan2<32>(m1, m2, l, ex1, ex2, t1, t2);
    int* P = pub + (i & 1) * W * kPub;
    if (l == 31) {
      P[w * kPub + 0] = t1;                 // max over the warp's columns
      P[w * kPub + 1] = t2;
      P[w * kPub + 2] = imax(ex1, x1);      // ... over all but its last column
      P[w * kPub + 3] = imax(ex2, x2);
      P[w * kPub + 4] = HT[C - 1];          // Htilde of its last column
      P[w * kPub + 5] = ht0;                // Htilde[i][0] (read from warp 0)
    }
    __syncthreads();
    if (w > 0) ht0 = P[5];

    // The previous chunk is complete: write it out behind the row loop.
    if (r_in == 0 && i > 1) {
      uint8_t* gprev = gch - static_cast<size_t>(R) * width;
      copy_out(gprev, stage + ((chunk - 1) & 1) * stride + mod16(gprev), R * width, t, T);
    }

    // Max over the warps left of w-1, then of w.
    int v1 = (l < w - 1) ? P[l * kPub + 0] : NEG;
    int v2 = (l < w - 1) ? P[l * kPub + 1] : NEG;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v1 = imax(v1, __shfl_xor_sync(kFull, v1, d));
      v2 = imax(v2, __shfl_xor_sync(kFull, v2, d));
    }
    const int base1 = imax(imax(v1, ht0), NEG), base2 = imax(imax(v2, ht0), NEG);
    int rin1 = base1, rin2 = base2, htp = ht0;
    if (w > 0) {
      const int* L = P + (w - 1) * kPub;
      rin1 = imax(base1, L[0]);
      rin2 = imax(base2, L[1]);
      // H[i][j0-1] of the left warp's last column, for the next row.
      const int f1 = imax(base1, L[2]) - s.o1 - jb * s.e1;
      const int f2 = imax(base2, L[3]) - s.o2 - jb * s.e2;
      hb = (row_ok && jb <= ni) ? imax(L[4], imax(f1, f2)) : NEG;
      htp = L[4];
    }
    const int htl = __shfl_up_sync(kFull, HT[C - 1], 1);
    if (l > 0) htp = htl;
    pass2(H, HT, bits, imax(rin1, ex1), imax(rin2, ex2), htp + jb * s.e1, htp + jb * s.e2,
          j0, colv, row_ok, s);

    if (t == 0) row[0] = static_cast<uint8_t>(byte0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (j0 + c < width) row[j0 + c] = static_cast<uint8_t>(bits[c]);
    }
    if (++r_in == R) {
      r_in = 0;
      ++chunk;
      gch += static_cast<size_t>(R) * width;
      row = stage + (chunk & 1) * stride + mod16(gch);
    } else {
      row += width;
    }
  }
  __syncthreads();
  const int last = (max_m - 1) / R;
  uint8_t* glast = tbb + static_cast<size_t>(last) * R * width;
  copy_out(glast, stage + (last & 1) * stride + mod16(glast), (max_m - last * R) * width, t, T);
}

// ------------------------------------------------- widths above 8193

// Exclusive max-scan across the block of two values, identity NEG.
// blockDim.x is a multiple of 32; wt holds 2 ints per warp.
__device__ __forceinline__ void block_excl_max2(int v1, int v2, int* wt,
                                                int& x1, int& x2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i1 = v1, i2 = v2;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int a = __shfl_up_sync(kFull, i1, s);
    const int c = __shfl_up_sync(kFull, i2, s);
    if (lane >= s) {
      i1 = imax(i1, a);
      i2 = imax(i2, c);
    }
  }
  int e1 = __shfl_up_sync(kFull, i1, 1);
  int e2 = __shfl_up_sync(kFull, i2, 1);
  if (lane == 0) {
    e1 = NEG;
    e2 = NEG;
  }
  if (lane == 31) {
    wt[2 * warp] = i1;
    wt[2 * warp + 1] = i2;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    e1 = imax(e1, wt[2 * w]);
    e2 = imax(e2, wt[2 * w + 1]);
  }
  x1 = e1;
  x2 = e2;
}

constexpr int kHeader = 256;   // bytes of shared memory before the row buffers

// The first design, kept for widths above 4097. One block per item; thread
// t owns K columns j = t*K + k;
// the per-column state lives in a buffer laid out [4][K][T] (coalesced over
// threads), in shared memory while it fits (widths up to 8193) and in global
// scratch above; a block scan per row; row bytes collected in shared memory
// and stored coalesced.
__global__ void dp_full_wide_kernel(const int8_t* __restrict__ q,
                                    const int8_t* __restrict__ r,
                                    const int* __restrict__ m,
                                    const int* __restrict__ n,
                                    uint8_t* __restrict__ tb,
                                    int* __restrict__ gscratch,
                                    int max_m, int max_n, int width, int K,
                                    int match, int mismatch,
                                    int o1, int o2, int e1, int e2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x, b = blockIdx.x;
  const int lanes = T * K;
  const int wpad = (width + 15) & ~15;
  int* wt = reinterpret_cast<int*>(smem);
  int* st;
  uint8_t* rowbuf;
  if (gscratch != nullptr) {
    st = gscratch + static_cast<size_t>(b) * 4 * lanes;
    rowbuf = smem + kHeader;
  } else {
    st = reinterpret_cast<int*>(smem + kHeader);
    rowbuf = smem + kHeader + static_cast<size_t>(16) * lanes;
  }
  int* SH = st;               // H[i-1][j], then H[i][j]
  int* SE1 = st + lanes;      // E1
  int* SE2 = st + 2 * lanes;  // E2
  int* SHT = st + 3 * lanes;  // Htilde[i][j]

  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rbase = r + static_cast<size_t>(b) * max_n;
  uint8_t* tbb = tb + static_cast<size_t>(b) * max_m * width;
  const int j0 = t * K;

  // Row 0: H[0][j] = -gapcost(j), E = -inf.
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    const int h = (j == 0) ? 0 : -pav::gap_cost(j, o1, o2, e1, e2);
    SH[k * T + t] = (j <= ni) ? h : NEG;
    SE1[k * T + t] = NEG;
    SE2[k * T + t] = NEG;
  }
  __syncthreads();

  for (int i = 1; i <= max_m; ++i) {
    uint8_t* rb = rowbuf + (i & 1) * wpad;
    const int qi = qb[i - 1];
    const bool row_ok = i <= mi;

    // Pass 1: vertical gaps, diagonal, Htilde; thread maxima of the augs.
    int hleft = (t > 0) ? SH[(K - 1) * T + t - 1] : NEG;   // H[i-1][j0-1]
    int m1 = NEG, m2 = NEG;
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int idx = k * T + t;
      const int hup = SH[idx];
      const int e1o = hup - (o1 + e1), e1x = SE1[idx] - e1;
      const int e1n = imax(e1o, e1x);
      const int e2o = hup - (o2 + e2), e2x = SE2[idx] - e2;
      const int e2n = imax(e2o, e2x);
      const int eb = imax(e1n, e2n);
      const int rj = (j >= 1 && j <= ni) ? static_cast<int>(rbase[j - 1]) : 4;
      const int sub = (qi == rj && qi < 4 && rj < 4) ? match : mismatch;
      const int diag = (j >= 1) ? hleft + sub : NEG;
      const int ht = imax(diag, eb);
      hleft = hup;
      const bool valid = (j <= ni) && row_ok;
      SE1[idx] = valid ? e1n : NEG;
      SE2[idx] = valid ? e2n : NEG;
      SHT[idx] = ht;
      if (j < width) {
        rb[j] = static_cast<uint8_t>((eb > diag) | ((e2n > e1n) << 2) |
                                     ((e1x > e1o) << 4) | ((e2x > e2o) << 5));
      }
      m1 = imax(m1, ht + j * e1);
      m2 = imax(m2, ht + j * e2);
    }

    // Exclusive prefix max of Htilde + j*e over the columns left of j0.
    int run1, run2;
    block_excl_max2(m1, m2, wt, run1, run2);

    // Pass 2: horizontal gaps, H, the rest of the byte.
    int pa1 = NEG, pa2 = NEG;   // Htilde[i][j-1] + (j-1)*e
    if (t > 0) {
      const int htp = SHT[(K - 1) * T + t - 1];
      pa1 = htp + (j0 - 1) * e1;
      pa2 = htp + (j0 - 1) * e2;
    }
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int idx = k * T + t;
      const int ht = SHT[idx];
      const int a1 = ht + j * e1, a2 = ht + j * e2;
      const int f1 = run1 - o1 - j * e1;
      const int f2 = run2 - o2 - j * e2;
      const int op1 = (j == 0) || (run1 == pa1);
      const int op2 = (j == 0) || (run2 == pa2);
      const int fb = imax(f1, f2);
      const int hn = imax(ht, fb);
      const bool valid = (j <= ni) && row_ok;
      SH[idx] = valid ? hn : NEG;
      if (j < width) {
        rb[j] |= static_cast<uint8_t>(((fb > ht) << 1) | ((f2 > f1) << 3) |
                                      (op1 << 6) | (op2 << 7));
      }
      run1 = imax(run1, a1);
      run2 = imax(run2, a2);
      pa1 = a1;
      pa2 = a2;
    }
    __syncthreads();
    uint8_t* out = tbb + static_cast<size_t>(i - 1) * width;
    for (int x = t; x < width; x += T) out[x] = rb[x];
  }
}

void wide_geometry(int width, int& T, int& K) {
  K = (width + 1023) / 1024;
  const int per = (width + K - 1) / K;
  T = ((per + 31) / 32) * 32;
}

size_t wide_smem_in_shared(int width) {
  int T, K;
  wide_geometry(width, T, K);
  const size_t wpad = (width + 15) & ~15;
  return kHeader + static_cast<size_t>(16) * T * K + 2 * wpad;
}

// ---------------------------------------------------------------- launch

template <int S, int C>
cudaError_t launch_warp(const int8_t* q, const int8_t* r, const int* m, const int* n,
                        uint8_t* tb, int B, int max_m, int max_n, int width,
                        const Scoring& s, cudaStream_t stream) {
  constexpr int G = 32 / S;
  constexpr int per_block = (kWarpBlock / 32) * G;
  int R = min(16, max_m);
  while (R > 1 && static_cast<size_t>(kWarpBlock / 32) * G * chunk_stride(R, width) > 48 * 1024) {
    R >>= 1;
  }
  const size_t smem = static_cast<size_t>(kWarpBlock / 32) * G * chunk_stride(R, width);
  const int grid = (B + per_block - 1) / per_block;
  dp_full_warp<S, C><<<grid, kWarpBlock, smem, stream>>>(q, r, m, n, tb, B, max_m, max_n,
                                                        width, R, s);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_block(const int8_t* q, const int8_t* r, const int* m, const int* n,
                         uint8_t* tb, int B, int max_m, int max_n, int width,
                         const Scoring& s, cudaStream_t stream) {
  const int cols = width - 1;
  const int W = (cols + 32 * C - 1) / (32 * C);
  const int T = 32 * W;
  const size_t fixed = static_cast<size_t>(2 * W * kPub) * sizeof(int);
  int R = min(16, max_m);
  while (R > 1 && fixed + 2 * static_cast<size_t>(chunk_stride(R, width)) > kSmemBudget) R >>= 1;
  const size_t smem = fixed + 2 * static_cast<size_t>(chunk_stride(R, width));
  cudaError_t err = pav::set_smem(dp_full_block<C>, smem);
  if (err != cudaSuccess) return err;
  dp_full_block<C><<<B, T, smem, stream>>>(q, r, m, n, tb, max_m, max_n, width, R, s);
  return cudaGetLastError();
}

}  // namespace

// Ints of global scratch per item (0 up to width 8193, where the state
// stays in registers or shared memory).
extern "C" int pav_dp_full_scratch_ints(int width) {
  if (width - 1 <= kBlockCols || wide_smem_in_shared(width) <= pav::kMaxSmem) return 0;
  int T, K;
  wide_geometry(width, T, K);
  return 4 * T * K;
}

extern "C" int pav_dp_full(const void* q_, const void* r_, const void* m_,
                           const void* n_, void* tb_, void* scratch, int B,
                           int max_m, int max_n, int width, int match,
                           int mismatch, int o1, int o2, int e1, int e2,
                           void* stream_) {
  if (B == 0) return 0;
  const auto* q = static_cast<const int8_t*>(q_);
  const auto* r = static_cast<const int8_t*>(r_);
  const auto* m = static_cast<const int*>(m_);
  const auto* n = static_cast<const int*>(n_);
  auto* tb = static_cast<uint8_t*>(tb_);
  auto stream = static_cast<cudaStream_t>(stream_);
  const Scoring s{match, mismatch, o1, o2, e1, e2};
  const int cols = width - 1;
  if (cols <= 16) return launch_warp<16, 1>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= 32) return launch_warp<32, 1>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= 64) return launch_warp<32, 2>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= 128) return launch_warp<32, 4>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= 256) return launch_warp<32, 8>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= 512) return launch_block<4>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  if (cols <= kBlockCols) {
    return launch_block<8>(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
  }
  const bool shared = pav_dp_full_scratch_ints(width) == 0;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int T, K;
  wide_geometry(width, T, K);
  const size_t wpad = (width + 15) & ~15;
  const size_t smem = shared ? wide_smem_in_shared(width) : kHeader + 2 * wpad;
  cudaError_t err = pav::set_smem(dp_full_wide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_full_wide_kernel<<<B, T, smem, stream>>>(
      q, r, m, n, tb, shared ? nullptr : static_cast<int*>(scratch), max_m, max_n, width, K,
      match, mismatch, o1, o2, e1, e2);
  return static_cast<int>(cudaGetLastError());
}
