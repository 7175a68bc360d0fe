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
// An item whose columns fit one SM runs its rows at that SM's rate: at
// width 2049 a row costs about 1.2 us, and a batch smaller than the card
// (the main path's 2048 x 2049 class comes at B = 8) leaves SMs idle. The
// wide classes (16..512 x 8193, 16..128 x 32769) have few rows and many
// columns, and come at small batches (16 x 512 x 8193): one SM an item
// would leave most of the card idle and, at width 32769, hold more state
// than an SM's registers and shared memory.
//
// Design. Every lane owns C consecutive columns j = jbase + 1 + u*C + c (u =
// its index in the block) and keeps their H, E1, E2 and Htilde in registers
// for the whole row loop; column 0 is computed apart, by every lane of the
// item's first warp, so 2^k columns split evenly. A row is two passes over
// the lane's columns: pass 1 computes E, the diagonal and Htilde and the
// lane's max of Htilde + j*e for both gap pieces; an exclusive max-scan
// over lanes by __shfl_up_sync gives every lane the running max of the
// columns to its left; pass 2 finishes F, H and the byte. The left
// neighbours (H of the previous row, Htilde of this row) come by one
// shuffle each. F "opened at the previous column" is
// run == Htilde[j-1] + (j-1)*e, exact in int32, and column 0 is always
// opened, as in the reference.
//  * dp_full_warp<S, C> (widths up to 257): one item per S-lane group,
//    32/S items per warp, 4 warps per block, no block barrier at all. At
//    width 17, two items share a warp and every lane owns one column.
//  * dp_full_block<C, kOneStrip> (widths 258..4097; C = 4 up to 513, then
//    8): one item per block of W warps, one block barrier per row: before
//    it, each warp publishes the max of its columns, its running max before
//    its last column and its last Htilde (double-buffered by row parity);
//    after it, lane x of each warp reads warp x's values and one
//    redux.sync gives the maxima of the warps to its left. The boundary H
//    that warp w needs at the next row (H[i][j0-1], on warp w-1) it computes
//    itself from those values, so a row needs no second barrier.
//  * widths above 4097: the same block over strips of 256*W columns. What
//    strip k needs of the strips to its left at row i is four ints, the
//    Edge: H[i][jl] and Htilde[i][jl] of the column left of its first, and
//    the running maxima of Htilde + j*e up to it. dp_full_block<8,
//    kClusterStrips> runs the S <= 8 strips of an item as one thread-block
//    cluster, one block a strip (at least 2048 columns a strip; 4 x 2048 at
//    width 8193, 8 x 4096 at 32769): the strips form a one-way pipeline,
//    strip k running row i once strip k-1 has sent row i's Edge into a
//    ring of 64 row slots in k's shared memory, by an asynchronous store
//    into distributed shared memory that completes the slot's mbarrier
//    (st.async; no fence on either side). Strip k returns slots by a
//    release store of the rows it has taken, every 32 rows, which orders
//    its loads of those slots before the left strip's next stores into
//    them. Nothing waits
//    on a cluster barrier per row, so an item's rows take
//    (max_m + S - 1) strip-rows.
//    dp_full_block<8, kSerialStrips> runs the strips (up to 4096 columns)
//    one after another in one block, the Edges of every row kept in shared
//    memory; it takes the widths above 32769, which a cluster of 8 strips
//    cannot hold, up to the rows whose Edges fit (about 13000). Nothing goes
//    to global scratch at any width.
// Tape rows are staged in shared memory (R rows per chunk, placed so that
// shared and global addresses agree mod 16) and written out as 16-byte
// stores: by the warp for its items (dp_full_warp), and by the whole block
// one chunk behind the row loop (dp_full_block, two chunk buffers; a
// strip's rows each a segment of the tape row).

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

constexpr int kPub = 8;     // ints a warp publishes per row
constexpr int kRing = 64;   // row slots of a strip's incoming edge ring (clusters)
constexpr int kStripCols = 2048;   // smallest strip of the cluster design (8 warps)

// Where a block's columns get their left boundary: column 0 (one strip, the
// whole row), an edge array filled by the block's previous strip (strips one
// after another), or a ring filled by the left neighbour of a cluster.
enum StripMode { kOneStrip, kSerialStrips, kClusterStrips };

// What strip k hands to strip k+1 for row i: H[i][jl] and Htilde[i][jl] of
// its last column jl, and the running maxima of Htilde[i][j] + j*e over the
// columns j <= jl (column 0 and the strips to the left included).
struct Edge {
  int h, ht, r1, r2;
};

// Bytes of shared memory before the staged tape rows: the published warp
// values [2][W][kPub], the edges, their mbarriers (clusters: one a ring
// slot) and a flag (padded to 16 bytes).
__host__ __device__ __forceinline__ int block_fixed_bytes(int W, int edges, int bars) {
  return 2 * W * kPub * 4 + edges * 16 + bars * 8 + 16;
}

// Staged bytes of one tape row of a strip of SW columns (column 0 included
// in the first): its bytes plus up to 15 of alignment offset, rounded to 16.
__host__ __device__ __forceinline__ int strip_row_bytes(int width, int SW) {
  return (min(width, SW + 1) + 15 + 15) & ~15;
}

// Bytes of one chunk buffer: R whole rows, contiguous as on the tape, for
// one strip; R strip rows at strip_row_bytes apart otherwise.
__host__ __device__ __forceinline__ int block_chunk_bytes(int R, int width, int SW, int S) {
  return S == 1 ? chunk_stride(R, width) : R * strip_row_bytes(width, SW);
}

// One item's columns 1..width-1 in S strips of SW = 32*W*C columns, column
// 0 in strip 0 (kOneStrip: S = 1, one block an item). Lane t of a strip
// owns its columns j0 = jbase + 1 + t*C onwards, in registers across rows.
// A row has one block barrier. Before it, each warp publishes the maxima of
// its columns' Htilde + j*e, its running max before its last column and its
// last Htilde; warp 0 also the strip's left boundary: column 0's Htilde, or
// the left strip's edge. After it, each warp takes the maxima of the warps
// to its left by one redux.sync and computes the H of the column left
// of its first (on warp w-1) itself, so the next row needs no second
// barrier. The barrier covers both dependences between warps of a row: F's
// prefix max (this row) and the boundary H (next row). Between strips only
// the edge passes, one row at a time: strip k runs row i once strip k-1 has
// finished row i (kClusterStrips: the strips of one item are one cluster
// and run as a pipeline, the edge written into the right neighbour's ring
// through distributed shared memory; kSerialStrips: one block runs the
// strips in turn, the edges of every row kept in shared memory).
template <int C, int MODE>
__global__ void __launch_bounds__(512)
dp_full_block(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
              const int* __restrict__ m, const int* __restrict__ n, uint8_t* __restrict__ tb,
              int max_m, int max_n, int width, int R, int strips, int edges, Scoring s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = MODE == kOneStrip ? 1 : strips;
  const int T = blockDim.x, W = T >> 5;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  const int SW = T * C;
  constexpr int kBars = MODE == kClusterStrips ? kRing : 0;
  int* pub = reinterpret_cast<int*>(smem);                    // [2][W][kPub]
  Edge* edge = reinterpret_cast<Edge*>(pub + 2 * W * kPub);   // [edges]
  uint64_t* bar = reinterpret_cast<uint64_t*>(edge + edges);  // [kBars]
  int* taken_by_right = reinterpret_cast<int*>(bar + kBars);  // rows the right strip has taken
  uint8_t* stage = reinterpret_cast<uint8_t*>(taken_by_right + 4);   // 2 chunk buffers

  const int b = MODE == kClusterStrips ? blockIdx.x / S : blockIdx.x;
  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  uint8_t* tbb = tb + static_cast<size_t>(b) * max_m * width;
  const int rs = strip_row_bytes(width, SW);
  const int cb = block_chunk_bytes(R, width, SW, S);

  int k = MODE == kClusterStrips ? static_cast<int>(blockIdx.x % S) : 0;
  const int kend = MODE == kSerialStrips ? S : k + 1;
  if (MODE == kClusterStrips) {
    if (t == 0) {
      for (int x = 0; x < kRing; ++x) pav::mbar_init(&bar[x], 1);
      *taken_by_right = 0;
      pav::mbar_init_fence();
    }
    pav::cluster_sync();   // every block of the cluster runs and has set its barriers
  }
  for (; k < kend; ++k) {
    const bool first = k == 0, last = k == S - 1;
    const int jbase = k * SW;                  // the strip owns columns jbase+1 .. jbase+SW
    const int jlo = first ? 0 : jbase + 1;     // its first tape column
    const int len = min(width - 1, jbase + SW) - jlo + 1;
    const int j0 = jbase + 1 + t * C;

    int H[C], E1[C], E2[C], HT[C], bits[C], rq[C];
    const unsigned colv = init_cols(H, E1, E2, j0, ni, width, s);
#pragma unroll
    for (int c = 0; c < C; ++c) rq[c] = ((colv >> c) & 1u) ? rb[j0 + c - 1] : 4;
    int h0 = 0, e10 = NEG, e20 = NEG;   // column 0, on warp 0 of strip 0
    // H[i-1][j0-1] for lane 0 of warp w > 0 (the last column of warp w-1)
    // and of warp 0 in strips k > 0 (the left strip's last column).
    const int jb = j0 - 1;
    int hb = (jb <= ni) ? -pav::gap_cost(jb, s.o1, s.o2, s.e1, s.e2) : NEG;
    int taken = 0;   // rows of edges the right strip has taken (cluster)
    // The right strip's edge ring and its mbarriers (cluster).
    uint32_t right_edge = 0, right_bar = 0;
    if (MODE == kClusterStrips && !last && t == T - 1) {
      right_edge = pav::cluster_addr(edge, k + 1);
      right_bar = pav::cluster_addr(bar, k + 1);
    }

    int qnext = qb[0];
    int r_in = 0, chunk = 0;                             // row within the chunk, chunk index
    uint8_t* grow = tbb + jlo;                           // the row's first tape byte
    uint8_t* gch = grow;                                 // the chunk's first row
    uint8_t* row = stage + mod16(grow);                  // staged byte of column jlo
    for (int i = 1; i <= max_m; ++i) {
      const int qi = qnext;
      if (i < max_m) qnext = qb[i];
      const int qx = qi < 4 ? qi : INT_MIN;
      const bool row_ok = i <= mi;

      const int h0_prev = h0;
      int ht0 = NEG, byte0 = 0;
      if (first && w == 0) byte0 = col0_step(h0, e10, e20, row_ok, s, ht0);
      int hl = __shfl_up_sync(kFull, H[C - 1], 1);
      if (l == 0) hl = (first && w == 0) ? h0_prev : hb;
      int m1, m2, x1, x2;
      pass1(H, E1, E2, HT, bits, rq, qx, hl, j0, colv, row_ok, s, m1, m2, x1, x2);
      int ex1, ex2, t1, t2;
      group_scan2<32>(m1, m2, l, ex1, ex2, t1, t2);
      // The strip's left boundary at row i: column 0, or the left strip's edge.
      int lm1 = ht0, lm2 = ht0, lht = ht0;
      if (!first && w == 0) {
        Edge e{0, 0, 0, 0};
        if (MODE == kClusterStrips) {
          if (l == 0) {
            // The left strip's asynchronous store of row i completes the
            // slot's mbarrier phase.
            const int slot = (i - 1) & (kRing - 1);
            pav::mbar_arrive_expect(&bar[slot], sizeof(Edge));
            pav::mbar_wait(&bar[slot], ((i - 1) / kRing) & 1);
            e = edge[slot];
            // Every 32 rows, the slots taken so far are free again for the
            // left strip (it waits only when 64 rows ahead). A release: the
            // loads of those slots complete before the left strip, which
            // acquires the count, may store into them again.
            if ((i & 31) == 0) pav::st_release_cluster(pav::cluster_map(taken_by_right, k - 1), i);
          }
          e.h = __shfl_sync(kFull, e.h, 0);
          e.ht = __shfl_sync(kFull, e.ht, 0);
          e.r1 = __shfl_sync(kFull, e.r1, 0);
          e.r2 = __shfl_sync(kFull, e.r2, 0);
        } else {
          e = edge[i - 1];   // read before this row's barrier, rewritten after it
        }
        lm1 = e.r1;
        lm2 = e.r2;
        lht = e.ht;
        hb = e.h;   // H[i][jbase]: lane 0's left column at the next row
      }
      int* P = pub + (i & 1) * W * kPub;
      if (l == 31) {
        P[w * kPub + 0] = t1;                 // max over the warp's columns
        P[w * kPub + 1] = t2;
        P[w * kPub + 2] = imax(ex1, x1);      // ... over all but its last column
        P[w * kPub + 3] = imax(ex2, x2);
        P[w * kPub + 4] = HT[C - 1];          // Htilde of its last column
        if (w == 0) {
          P[5] = lm1;                         // the left boundary's maxima
          P[6] = lm2;
          P[7] = lht;                         // ... and its Htilde
        }
      }
      __syncthreads();
      lm1 = P[5];
      lm2 = P[6];
      lht = P[7];

      // The previous chunk is complete: write it out behind the row loop.
      if (r_in == 0 && i > 1) {
        uint8_t* gprev = gch - static_cast<size_t>(R) * width;
        const uint8_t* buf = stage + ((chunk - 1) & 1) * cb;
        if (S == 1) {
          copy_out(gprev, buf + mod16(gprev), R * width, t, T);
        } else {
          for (int rr = 0; rr < R; ++rr, gprev += width) {
            copy_out(gprev, buf + rr * rs + mod16(gprev), len, t, T);
          }
        }
      }

      // Max over the warps left of w-1 (one redux.sync each), then of w.
      const int v1 = __reduce_max_sync(kFull, (l < w - 1) ? P[l * kPub + 0] : NEG);
      const int v2 = __reduce_max_sync(kFull, (l < w - 1) ? P[l * kPub + 1] : NEG);
      const int base1 = imax(imax(v1, lm1), NEG), base2 = imax(imax(v2, lm2), NEG);
      int rin1 = base1, rin2 = base2, htp = lht;
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
      const int run1 = imax(rin1, ex1), run2 = imax(rin2, ex2);
      pass2(H, HT, bits, run1, run2, htp + jb * s.e1, htp + jb * s.e2, j0, colv, row_ok, s);

      // The edge of row i, from the strip's last lane.
      if (!last && t == T - 1) {
        const Edge e{H[C - 1], HT[C - 1], imax(run1, m1), imax(run2, m2)};
        if (MODE == kClusterStrips) {
          if (i - taken > kRing) {
            while (i - (taken = pav::ld_acquire_cluster(taken_by_right)) > kRing) {
            }
          }
          const int slot = (i - 1) & (kRing - 1);
          pav::st_async4(right_edge + slot * sizeof(Edge), e.h, e.ht, e.r1, e.r2,
                         right_bar + slot * sizeof(uint64_t));
        } else {
          edge[i - 1] = e;
        }
      }

      if (first && t == 0) row[0] = static_cast<uint8_t>(byte0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (j0 + c < width) row[j0 - jlo + c] = static_cast<uint8_t>(bits[c]);
      }
      grow += width;
      if (++r_in == R) {
        r_in = 0;
        ++chunk;
        gch = grow;
        row = stage + (chunk & 1) * cb + mod16(grow);
      } else {
        row = S == 1 ? row + width : stage + (chunk & 1) * cb + r_in * rs + mod16(grow);
      }
    }
    __syncthreads();
    const int lastc = (max_m - 1) / R, rows = max_m - lastc * R;
    uint8_t* glast = tbb + static_cast<size_t>(lastc) * R * width + jlo;
    const uint8_t* buf = stage + (lastc & 1) * cb;
    if (S == 1) {
      copy_out(glast, buf + mod16(glast), rows * width, t, T);
    } else {
      for (int rr = 0; rr < rows; ++rr, glast += width) {
        copy_out(glast, buf + rr * rs + mod16(glast), len, t, T);
      }
    }
    if (MODE == kSerialStrips) __syncthreads();   // the next strip reuses the buffers
  }
  // No block leaves while a neighbour may still write its shared memory.
  if (MODE == kClusterStrips) pav::cluster_sync();
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

// dp_full_block with W warps a strip and S strips an item; R rows a chunk,
// the largest that fits beside the fixed part (at most 16).
template <int C, int MODE>
cudaError_t launch_block(const int8_t* q, const int8_t* r, const int* m, const int* n,
                         uint8_t* tb, int B, int max_m, int max_n, int width, int W, int S,
                         const Scoring& s, cudaStream_t stream) {
  const int SW = 32 * W * C;
  const int edges = MODE == kClusterStrips ? kRing : (MODE == kSerialStrips ? max_m : 0);
  const size_t fixed = block_fixed_bytes(W, edges, MODE == kClusterStrips ? kRing : 0);
  int R = min(16, max_m);
  while (R > 1 && fixed + 2 * static_cast<size_t>(block_chunk_bytes(R, width, SW, S)) > kSmemBudget) {
    R >>= 1;
  }
  const size_t smem = fixed + 2 * static_cast<size_t>(block_chunk_bytes(R, width, SW, S));
  // Strips in turn keep an edge a row: too many rows do not fit.
  if (smem > static_cast<size_t>(pav::kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = pav::set_smem(dp_full_block<C, MODE>, smem);
  if (err != cudaSuccess) return err;
  if (MODE != kClusterStrips) {
    dp_full_block<C, MODE><<<B, 32 * W, smem, stream>>>(q, r, m, n, tb, max_m, max_n, width, R,
                                                       S, edges, s);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dp_full_block<C, MODE>, q, r, m, n, tb, max_m, max_n, width, R,
                           S, edges, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Columns above kBlockCols: strips of 256*W columns. A cluster takes up to
// 8 strips (the portable cluster size) of at least kStripCols columns; one
// block in turn takes strips of up to 4096 (16 warps, the most at up to 128
// registers a thread).
cudaError_t launch_wide(const int8_t* q, const int8_t* r, const int* m, const int* n,
                        uint8_t* tb, int B, int max_m, int max_n, int width, const Scoring& s,
                        cudaStream_t stream) {
  constexpr int C = 8, kCols = 32 * C;
  const int cols = width - 1;
  const bool cluster = cols <= 8 * kBlockCols;
  int S = cluster ? min(8, (cols + kStripCols - 1) / kStripCols)
                  : (cols + kBlockCols - 1) / kBlockCols;
  const int W = (cols + S * kCols - 1) / (S * kCols);
  S = (cols + W * kCols - 1) / (W * kCols);
  if (cluster) {
    return launch_block<C, kClusterStrips>(q, r, m, n, tb, B, max_m, max_n, width, W, S, s,
                                           stream);
  }
  return launch_block<C, kSerialStrips>(q, r, m, n, tb, B, max_m, max_n, width, W, S, s,
                                        stream);
}

}  // namespace

extern "C" int pav_dp_full(const void* q_, const void* r_, const void* m_, const void* n_,
                           void* tb_, int B, int max_m, int max_n, int width, int match,
                           int mismatch, int o1, int o2, int e1, int e2, void* stream_) {
  if (B == 0) return 0;
  if (width < 1 || width != max_n + 1 || max_m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (cols <= 512) {
    return launch_block<4, kOneStrip>(q, r, m, n, tb, B, max_m, max_n, width,
                                      (cols + 127) / 128, 1, s, stream);
  }
  if (cols <= kBlockCols) {
    return launch_block<8, kOneStrip>(q, r, m, n, tb, B, max_m, max_n, width,
                                      (cols + 255) / 256, 1, s, stream);
  }
  return launch_wide(q, r, m, n, tb, B, max_m, max_n, width, s, stream);
}
