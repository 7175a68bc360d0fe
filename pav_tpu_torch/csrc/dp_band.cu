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
// What bounds it on an H100: rows are dependent and a row's only
// cross-column dependence is F's prefix max, about 48 int32 operations a
// cell against one tape byte written: integer issue, not HBM, where the
// card is full. The classes with few items (255 x w257, 31 x w513, 8 x
// w4097) leave most SMs idle, so what bounds them is how fast one SM runs
// one item's rows: the latency of a row's dependent chain, and how many of
// the SM's four schedulers the item's warps use. The first design
// lengthened that chain: the offset's division in every row, two block
// barriers a row, shifted reads at a stride of C words (bank conflicts),
// one idle lane or warp for the "+1" column of every ladder width 2^k + 1,
// and tape bytes stored one at a time.
//
// Design. Column 0 of the window is computed apart (by every lane of the
// item's group, or of a block's warp 0, from broadcast reads), so the other
// 2^k columns split evenly: lane t owns the C consecutive columns
// w = 1 + t*C + c. Before the row loop the item's lanes compute every row's
// offset into offs and place the analytic row 0 in row 1's window; the
// offsets and query bases of 16 rows at a time are staged into shared
// memory one window ahead, so the row loop loads neither. The previous
// row's H, E1 and E2 live in shared memory laid out [c][t] (column
// 1 + t*C + c at c*(L+1) + t + 1, column 0 at (C-1)*(L+1)), so a read at a
// uniform shift s has consecutive lanes on consecutive words; E and the H of
// row i are written once, after the row's scan. The reference bases are
// read through L1 (__ldg, a lane's C consecutive bytes): a window of them
// staged into shared memory every 16 rows measured slower at every
// BAND_SHAPES class (the staging's loads stall the row that issues them).
// A row is two passes over the lane's columns: pass 1 reads the shifted
// state, computes E, the diagonal and Htilde and the lane's maxima of
// Htilde + w*e; an exclusive max-scan gives each lane the running max to
// its left; pass 2 finishes F, H and the byte, staged in shared memory (R
// rows a chunk) and written out as 16-byte stores.
//  * dp_band_kernel<C, G> (widths up to 129, and 257 from 528 items on):
//    one item per G-lane group, two items a warp at widths 17 and 33
//    (G = 16), one to four warps a block; the scan by shuffles, __syncwarp
//    between the passes and between rows.
//  * dp_band_kernel<C, 0> (fewer items at width 257, and widths 258..8193):
//    one item per block, with the fewest columns a lane that keep it within
//    16 warps (C = 1 up to width 257, 2 up to 1025, 4 up to 2049, 8 up to
//    4097, 16 up to 8193), so that an item alone on an SM spreads over its
//    four schedulers. One block barrier a row, after pass 1: each warp
//    publishes its maxima and last Htilde, and warp 0 column 0's Htilde,
//    double-buffered by row parity; it covers F's scan across warps and
//    every write-after-read of the single-buffered state (pass 2 writes
//    what the row's pass 1 read). The read-after-write across rows (row
//    i+1's shifted reads of row i's H and E, written by up to the
//    neighbouring warps) is covered by per-warp row flags: a warp publishes
//    the row it has written, and a warp waits only for the warps that own
//    the columns it reads.
//  * widths above 8193 (no caller): the same block kernel with C = 64 and
//    its state in global scratch (dp_band_kernel<64, 0, true>).

#include <climits>

#include "common.cuh"

using pav::imax;
using pav::imin;
using pav::NEG;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPub = 4;              // ints a warp publishes per row
constexpr int kMaxWidth = 65536;
constexpr int kRRows = 16;           // rows per staged window of offsets and query bases
constexpr int kWideC = 64;           // columns a lane above width 8193
constexpr int kFewItems = 4 * 132;   // fewer items than four an SM (an H100's 132)

struct Scoring {
  int match, mismatch, o1, o2, e1, e2;
};

__device__ __forceinline__ int bit(bool x, int k) { return static_cast<int>(x) << k; }

__host__ __device__ constexpr int lg2(int c) { return c <= 1 ? 0 : 1 + lg2(c / 2); }

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

// Index of window column k >= 0 in a [C][L+1] state array of L lanes.
template <int C>
__device__ __forceinline__ int sidx(int k, int L) {
  constexpr int kLg = lg2(C);
  const int k1 = k - 1;
  return (k1 & (C - 1)) * (L + 1) + (k1 >> kLg) + 1;
}

// Ints of one state array, and of the three (H, E1, E2); their bytes in
// shared memory, rounded up to 16 (what follows them takes 16-byte loads).
__host__ __device__ __forceinline__ int state_len(int C, int L) { return C * (L + 1); }
__host__ __device__ __forceinline__ int state_ints(int C, int L) { return 3 * state_len(C, L); }
__host__ __device__ __forceinline__ int state_bytes(int C, int L) {
  return (4 * state_ints(C, L) + 15) & ~15;
}

// A staged window of kRRows rows: their offsets (16 ints), then their
// query bases (16 bytes).
constexpr int kWinQ = 4 * kRRows, kWinBytes = kWinQ + kRRows;

// Bytes of one chunk buffer: R rows, 16 bytes of slack for the alignment
// offset, rounded up to 16.
__host__ __device__ __forceinline__ int chunk_stride(int R, int width) {
  return (R * width + 16 + 15) & ~15;
}

// Shared memory of one item of the group kernel.
__host__ __device__ __forceinline__ int group_item_bytes(int C, int G, int width, int R) {
  return state_bytes(C, G) + 2 * kWinBytes + chunk_stride(R, width);
}

// Shared memory of the block kernel before its state: published values
// [2][W][kPub] and the warps' row flags [W], rounded up to 16.
__host__ __device__ __forceinline__ int block_head_bytes(int W) {
  return (4 * (2 * W * kPub + W) + 15) & ~15;
}

__device__ __forceinline__ int mod16(const uint8_t* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
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

// The window of rows a..a+15 (up to max_m): lanes t < 16 of the item stage
// row a+t's offset and query base.
__device__ __forceinline__ void stage_window(const int* ob, const int8_t* qb, uint8_t* win, int a,
                                             int max_m, int t) {
  const int row = a + t;
  if (t < kRRows && row <= max_m) {
    reinterpret_cast<int*>(win)[t] = ob[row - 1];
    win[kWinQ + t] = static_cast<uint8_t>(qb[row - 1]);
  }
}

// Waits until the warps that own window columns kmin..kmax (clipped to the
// window) have written row `row`'s state: each lane watches one warp's flag.
__device__ __forceinline__ void wait_columns(const int* hflag, int kmin, int kmax, int width,
                                             int span, int row, int lane) {
  kmin = imax(kmin, 0);
  kmax = imin(kmax, width - 1);
  if (kmin <= kmax) {
    const int wlo = kmin == 0 ? 0 : (kmin - 1) / span;
    const int whi = kmax == 0 ? 0 : (kmax - 1) / span;
    if (lane <= whi - wlo) {
      while (pav::ld_volatile(&hflag[wlo + lane]) < row) {
      }
    }
    __threadfence_block();
  }
  __syncwarp();
}

// One item per G-lane group (G = 16 or 32) or, with G = 0, per block; GST:
// the state in global scratch and the bases from global memory.
template <int C, int G, bool GST>
__global__ void __launch_bounds__(G ? 128 : (GST ? 1024 : 512))
dp_band_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
               const int* __restrict__ m, const int* __restrict__ n,
               int* __restrict__ score, uint8_t* __restrict__ tb, int* __restrict__ offs,
               int* __restrict__ gstate, int B, int max_m, int max_n, int width, int R,
               Scoring s) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BLOCK = G == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int b, t, L;
  unsigned gmask;
  int* hs;              // state arrays H, E1, E2 (each state_len ints)
  uint8_t* win0;        // two staged windows of offsets and query bases
  uint8_t* stage;       // chunk buffers: one (group), two (block)
  int* pub = nullptr;   // block: [2][W][kPub]
  int* hflag = nullptr; // block: [W], the last row each warp has written
  const int W = blockDim.x >> 5;
  if (BLOCK) {
    b = blockIdx.x;
    t = threadIdx.x;
    L = blockDim.x;
    gmask = kFull;
    pub = reinterpret_cast<int*>(smem);
    hflag = pub + 2 * W * kPub;
    unsigned char* p = smem + block_head_bytes(W);
    win0 = p;
    p += 2 * kWinBytes;
    if (GST) {
      hs = gstate + static_cast<size_t>(b) * state_ints(C, L);
    } else {
      hs = reinterpret_cast<int*>(p);
      p += state_bytes(C, L);
    }
    stage = p;
  } else {
    const int g = lane / G;
    const int slot = warp * (32 / G) + g;
    b = (blockIdx.x * W + warp) * (32 / G) + g;
    t = lane % G;
    L = G;
    gmask = G == 32 ? kFull : (0xffffu << (16 * g));
    if (b >= B) return;   // the whole group leaves together
    unsigned char* p = smem + static_cast<size_t>(slot) * group_item_bytes(C, G, width, R);
    hs = reinterpret_cast<int*>(p);
    win0 = p + state_bytes(C, G);
    stage = win0 + 2 * kWinBytes;
  }
  int* e1s = hs + state_len(C, L);
  int* e2s = e1s + state_len(C, L);

  const int mi = m[b], ni = n[b];
  const int half = width / 2;
  const int max_off = imax(ni + 1 - width, 0);
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  uint8_t* tbb = tb + static_cast<size_t>(b) * max_m * width;
  int* ob = offs + static_cast<size_t>(b) * max_m;
  int* scb = score + static_cast<size_t>(b) * width;
  const int w0 = 1 + t * C;
  const int8_t match8 = static_cast<int8_t>(s.match), mismatch8 = static_cast<int8_t>(s.mismatch);

  // Prologue: every row's offset; row 0 in row 1's window; the warps' row
  // flags; then the first staged window of offsets and query bases.
  for (int i = 1 + t; i <= max_m; i += L) ob[i - 1] = band_offset(i, mi, ni, half, max_off);
  const int off1 = band_offset(1, mi, ni, half, max_off);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = w0 + c;
    if (w < width) {
      const int k = sidx<C>(w, L);
      hs[k] = row0(off1 + w, ni, s);
      e1s[k] = NEG;
      e2s[k] = NEG;
    }
  }
  if (t == 0) {
    const int k = sidx<C>(0, L);
    hs[k] = row0(off1, ni, s);
    e1s[k] = NEG;
    e2s[k] = NEG;
  }
  if (BLOCK) {
    if (t < W) hflag[t] = 0;
    __syncthreads();   // the offsets (global) and the state
  } else {
    __syncwarp(gmask);
  }
  stage_window(ob, qb, win0, 1, max_m, t);
  if (BLOCK) {
    __syncthreads();
  } else {
    __syncwarp(gmask);
  }

  int off_prev = off1;
  int r_in = 0, chunk = 0;
  const int cb = chunk_stride(R, width);
  uint8_t* gch = tbb;                 // the chunk's first tape row
  uint8_t* row = stage + mod16(gch);
  for (int i = 1; i <= max_m; ++i) {
    const int wi = ((i - 1) / kRRows) & 1;   // the staged window of this row
    const uint8_t* win = win0 + wi * kWinBytes;
    const int off = reinterpret_cast<const int*>(win)[(i - 1) % kRRows];
    const int qi = static_cast<int8_t>(win[kWinQ + (i - 1) % kRRows]);
    const int sh = off - off_prev;
    off_prev = off;
    const bool row_ok = i <= mi;
    if ((i - 1) % kRRows == 0 && i + kRRows <= max_m) {
      // The next window, into the buffer the previous one used; it is read
      // from row i + 16 on, after this row's barrier.
      stage_window(ob, qb, win0 + (wi ^ 1) * kWinBytes, i + kRRows, max_m, t);
    }

    // Row i-1's state in the columns this warp reads (warp 0: column 0's
    // too), from the warps that own them. (Waiting for column 0's owners
    // first and the rest after column 0 measured slower on an H100.)
    constexpr int span = 32 * C;   // columns of a warp (block kernel)
    if (BLOCK && i > 1) {
      wait_columns(hflag, warp * span + sh - (warp == 0 ? 1 : 0), (warp + 1) * span + sh, width,
                   span, i - 1, lane);
    }

    // Column 0 (the group's lanes, or warp 0 of a block): F is NEG and
    // opened; the sentinel where off = 0.
    int ht0 = NEG, byte0 = 0, h0n = NEG, e10n = NEG, e20n = NEG;
    if (!BLOCK || warp == 0) {
      const bool in_up = sh >= 0 && sh < width, in_dg = sh >= 1 && sh <= width;
      const int hup = in_up ? hs[sidx<C>(sh, L)] : NEG;
      const int e1u = in_up ? e1s[sidx<C>(sh, L)] : NEG;
      const int e2u = in_up ? e2s[sidx<C>(sh, L)] : NEG;
      const int hdg = i == 1 ? row0(off - 1, ni, s) : (in_dg ? hs[sidx<C>(sh - 1, L)] : NEG);
      const int e1o = hup - (s.o1 + s.e1), e1x = e1u - s.e1, e1n = imax(e1o, e1x);
      const int e2o = hup - (s.o2 + s.e2), e2x = e2u - s.e2, e2n = imax(e2o, e2x);
      const int eb = imax(e1n, e2n);
      int diag = NEG;
      if (off >= 1) {
        const int rj = __ldg(rb + off - 1);
        const int8_t sub = (qi == rj && qi < 4 && rj < 4) ? match8 : mismatch8;
        diag = sub == -128 ? NEG : hdg + sub;
      }
      ht0 = imax(diag, eb);
      const int f1 = NEG - s.o1, f2 = NEG - s.o2, fb = imax(f1, f2);
      byte0 = bit(eb > diag, 0) | bit(fb > ht0, 1) | bit(e2n > e1n, 2) | bit(f2 > f1, 3) |
              bit(e1x > e1o, 4) | bit(e2x > e2o, 5) | 0xc0;
      const bool valid = row_ok && off <= ni;
      h0n = valid ? imax(ht0, fb) : NEG;
      e10n = valid ? e1n : NEG;
      e20n = valid ? e2n : NEG;
    }

    // Pass 1: E, diagonal, Htilde, the E-side bits; lane maxima of
    // Htilde + w*e (INT_MIN, the max's identity, where no column is).
    int HT[C], bits[C], E1n[C], E2n[C];
    int m1 = INT_MIN, m2 = INT_MIN;
    {
      const int8_t* rp = rb + (off - 1 + w0);   // the lane's reference bases (global, via L1)
      const int kd = w0 - 1 + sh;   // the diagonal of the lane's first column
      int hdg = (kd >= 0 && kd < width) ? hs[sidx<C>(kd, L)] : NEG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int w = w0 + c;
        HT[c] = NEG;
        bits[c] = 0;
        E1n[c] = NEG;
        E2n[c] = NEG;
        if (w < width) {
          const int k = w + sh;
          int hup = NEG, e1u = NEG, e2u = NEG;
          if (k >= 0 && k < width) {
            const int x = sidx<C>(k, L);
            hup = hs[x];
            e1u = e1s[x];
            e2u = e2s[x];
          }
          const int e1o = hup - (s.o1 + s.e1), e1x = e1u - s.e1, e1n = imax(e1o, e1x);
          const int e2o = hup - (s.o2 + s.e2), e2x = e2u - s.e2, e2n = imax(e2o, e2x);
          const int eb = imax(e1n, e2n);
          const int rj = __ldg(rp + c);
          const int8_t sub = (qi == rj && qi < 4 && rj < 4) ? match8 : mismatch8;
          const int diag = sub == -128 ? NEG : hdg + sub;
          hdg = hup;
          const int ht = imax(diag, eb);
          HT[c] = ht;
          bits[c] = bit(eb > diag, 0) | bit(e2n > e1n, 2) | bit(e1x > e1o, 4) | bit(e2x > e2o, 5);
          const bool valid = row_ok && off + w <= ni;
          E1n[c] = valid ? e1n : NEG;
          E2n[c] = valid ? e2n : NEG;
          m1 = imax(m1, ht + w * s.e1);
          m2 = imax(m2, ht + w * s.e2);
        }
      }
    }

    // Exclusive max-scan of (m1, m2) over the item's lanes; htp = Htilde of
    // column w0 - 1.
    int run1, run2, htp;
    {
      constexpr int S = BLOCK ? 32 : G;
      const int l = BLOCK ? lane : t;
      int v1 = m1, v2 = m2;
#pragma unroll
      for (int d = 1; d < S; d <<= 1) {
        const int a = __shfl_up_sync(gmask, v1, d, S);
        const int c = __shfl_up_sync(gmask, v2, d, S);
        if (l >= d) {
          v1 = imax(v1, a);
          v2 = imax(v2, c);
        }
      }
      int ex1 = __shfl_up_sync(gmask, v1, 1, S);
      int ex2 = __shfl_up_sync(gmask, v2, 1, S);
      htp = __shfl_up_sync(gmask, HT[C - 1], 1, S);
      if (l == 0) {
        ex1 = INT_MIN;
        ex2 = INT_MIN;
        htp = ht0;
      }
      int base1 = ht0, base2 = ht0;   // column 0's term, ht0 + 0*e
      if (BLOCK) {
        int* P = pub + (i & 1) * W * kPub;
        if (lane == 31) {
          P[warp * kPub + 0] = v1;          // max over the warp's columns
          P[warp * kPub + 1] = v2;
          P[warp * kPub + 2] = HT[C - 1];   // Htilde of its last column
          if (warp == 0) P[3] = ht0;
        }
        __syncthreads();
        base1 = P[3];   // column 0's term, from warp 0
        base2 = base1;
        // Max over the warps left of this one (one redux.sync each).
        const int u1 = __reduce_max_sync(kFull, lane < warp ? P[lane * kPub + 0] : INT_MIN);
        const int u2 = __reduce_max_sync(kFull, lane < warp ? P[lane * kPub + 1] : INT_MIN);
        base1 = imax(base1, u1);
        base2 = imax(base2, u2);
        if (lane == 0) htp = warp == 0 ? P[3] : P[(warp - 1) * kPub + 2];
      } else {
        __syncwarp(gmask);   // pass 2 rewrites state the group's pass 1 read
      }
      run1 = imax(base1, ex1);
      run2 = imax(base2, ex2);
    }

    // Chunk write-out (block): the previous chunk is complete.
    if (BLOCK && r_in == 0 && i > 1) {
      uint8_t* gprev = gch - static_cast<size_t>(R) * width;
      copy_out(gprev, stage + ((chunk - 1) & 1) * cb + mod16(gprev), R * width, t, L);
    }

    // Pass 2: F from the running max, H, the F-side bits; the state and the
    // staged byte out.
    {
      int pa1 = htp + (w0 - 1) * s.e1, pa2 = htp + (w0 - 1) * s.e2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int w = w0 + c;
        if (w < width) {
          const int ht = HT[c];
          const int a1 = ht + w * s.e1, a2 = ht + w * s.e2;
          const int f1 = run1 - s.o1 - w * s.e1, f2 = run2 - s.o2 - w * s.e2;
          const int fb = imax(f1, f2);
          const int hn = imax(ht, fb);
          row[w] = static_cast<uint8_t>(bits[c] | bit(fb > ht, 1) | bit(f2 > f1, 3) |
                                        bit(run1 == pa1, 6) | bit(run2 == pa2, 7));
          const int h = (row_ok && off + w <= ni) ? hn : NEG;
          const int x = c * (L + 1) + t + 1;   // sidx(w)
          hs[x] = h;
          e1s[x] = E1n[c];
          e2s[x] = E2n[c];
          if (i == max_m) scb[w] = h;
          run1 = imax(run1, a1);
          run2 = imax(run2, a2);
          pa1 = a1;
          pa2 = a2;
        }
      }
      if (t == 0) {
        const int x = sidx<C>(0, L);
        hs[x] = h0n;
        e1s[x] = e10n;
        e2s[x] = e20n;
        row[0] = static_cast<uint8_t>(byte0);
        if (i == max_m) scb[0] = h0n;
      }
    }

    if (BLOCK) {
      // Row i's state of this warp is written: raise its flag.
      __threadfence_block();
      __syncwarp();
      if (lane == 0) pav::st_volatile(&hflag[warp], i);
      if (++r_in == R) {
        r_in = 0;
        ++chunk;
        gch += static_cast<size_t>(R) * width;
        row = stage + (chunk & 1) * cb + mod16(gch);
      } else {
        row += width;
      }
    } else {
      __syncwarp(gmask);   // row i's state before row i+1's shifted reads
      if (++r_in == R || i == max_m) {
        copy_out(gch, stage + mod16(gch), r_in * width, t, G);
        __syncwarp(gmask);
        gch += static_cast<size_t>(r_in) * width;
        r_in = 0;
        row = stage + mod16(gch);
      } else {
        row += width;
      }
    }
  }
  if (BLOCK) {
    __syncthreads();
    const int last = (max_m - 1) / R;
    uint8_t* glast = tbb + static_cast<size_t>(last) * R * width;
    copy_out(glast, stage + (last & 1) * cb + mod16(glast), (max_m - last * R) * width, t, L);
  }
}

// Groups: G lanes an item, C columns a lane; one to four warps a block, so
// that a batch of few items still spreads over the SMs.
template <int C, int G>
cudaError_t launch_group(const int8_t* q, const int8_t* r, const int* m, const int* n,
                         int* score, uint8_t* tb, int* offs, int B, int max_m, int max_n,
                         int width, const Scoring& s, cudaStream_t stream) {
  constexpr int per_warp = 32 / G;
  const int warps = (B + per_warp - 1) / per_warp;
  const int wpb = min(4, max(1, warps / 264));
  int R = min(16, max_m);
  while (R > 1 && static_cast<size_t>(wpb) * per_warp * group_item_bytes(C, G, width, R) >
                      48 * 1024) {
    R >>= 1;
  }
  const size_t smem = static_cast<size_t>(wpb) * per_warp * group_item_bytes(C, G, width, R);
  cudaError_t err = pav::set_smem(dp_band_kernel<C, G, false>, smem);
  if (err != cudaSuccess) return err;
  dp_band_kernel<C, G, false><<<(warps + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(
      q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width, R, s);
  return cudaGetLastError();
}

// Shared memory of the block kernel at R rows a chunk.
size_t block_smem(int C, bool gst, int W, int width, int R) {
  size_t bytes = block_head_bytes(W) + 2 * kWinBytes + 2 * static_cast<size_t>(chunk_stride(R, width));
  if (!gst) bytes += state_bytes(C, 32 * W);
  return bytes;
}

template <int C, bool GST>
cudaError_t launch_block(const int8_t* q, const int8_t* r, const int* m, const int* n,
                         int* score, uint8_t* tb, int* offs, int* scratch, int B, int max_m,
                         int max_n, int width, const Scoring& s, cudaStream_t stream) {
  const int W = (width - 1 + 32 * C - 1) / (32 * C);
  int R = min(16, max_m);
  while (R > 1 && block_smem(C, GST, W, width, R) > static_cast<size_t>(pav::kMaxSmem)) R >>= 1;
  const size_t smem = block_smem(C, GST, W, width, R);
  if (smem > static_cast<size_t>(pav::kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = pav::set_smem(dp_band_kernel<C, 0, GST>, smem);
  if (err != cudaSuccess) return err;
  dp_band_kernel<C, 0, GST><<<B, 32 * W, smem, stream>>>(q, r, m, n, score, tb, offs, scratch, B,
                                                        max_m, max_n, width, R, s);
  return cudaGetLastError();
}

}  // namespace

// Ints of global scratch per item: 0 up to width 8193, where the state lives
// in shared memory.
extern "C" int pav_dp_band_scratch_ints(int width) {
  if (width - 1 <= 8192) return 0;
  const int W = (width - 1 + 32 * kWideC - 1) / (32 * kWideC);
  return state_ints(kWideC, 32 * W);
}

extern "C" int pav_dp_band(const void* q_, const void* r_, const void* m_, const void* n_,
                           void* score_, void* tb_, void* offs_, void* scratch, int B,
                           int max_m, int max_n, int width, int match, int mismatch, int o1,
                           int o2, int e1, int e2, void* stream_) {
  if (B == 0) return 0;
  if (width < 1 || width > max_n + 1 || width > kMaxWidth || max_m < 1 || max_n < 1) {
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
  const int cols = width - 1;
  if (cols <= 16) return launch_group<1, 16>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (cols <= 32) return launch_group<2, 16>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (cols <= 64) return launch_group<2, 32>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  if (cols <= 128) return launch_group<4, 32>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  // A warp an item uses one of an SM's four schedulers, and a row's
  // dependent chain is what bounds an item alone on an SM: where the batch
  // leaves SMs with fewer than four items, an item takes a block, with the
  // fewest columns a lane that keep it within 16 warps.
  if (cols <= 256 && B >= kFewItems) {
    return launch_group<8, 32>(q, r, m, n, score, tb, offs, B, max_m, max_n, width, s, stream);
  }
  if (cols <= 256) {
    return launch_block<1, false>(q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width,
                                  s, stream);
  }
  if (cols <= 1024) {
    return launch_block<2, false>(q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width,
                                  s, stream);
  }
  if (cols <= 2048) {
    return launch_block<4, false>(q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width,
                                  s, stream);
  }
  if (cols <= 4096) {
    return launch_block<8, false>(q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width,
                                  s, stream);
  }
  if (cols <= 8192) {
    return launch_block<16, false>(q, r, m, n, score, tb, offs, nullptr, B, max_m, max_n, width,
                                   s, stream);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_block<kWideC, true>(q, r, m, n, score, tb, offs, static_cast<int*>(scratch), B,
                                    max_m, max_n, width, s, stream);
}
