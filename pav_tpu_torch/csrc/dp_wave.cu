// Anti-diagonal (wavefront) banded affine-gap DP: traceback tape.
//
// Replaces pav_tpu/ops/pallas_dp.py::_wave_kernel (launched by
// pallas_align_wave), and computes the same tape as
// pav_tpu/ops/affine_dp.py::_align_batch_wave: diagonal d = k+1 of item b is
// row k of tb[b], holding the cells (i, j), i + j = d, i = doffs[b][k] + w
// for lanes w = 0..ww-1, one byte per cell in the layout of
// affine_dp.py:14-22. The band placement doffs comes from the caller
// (affine_dp._wave_geometry, the reference's formula); the window moves by
// s1 = doffs[k] - doffs[k-1] in {0,1} and s2 = doffs[k] - doffs[k-2] in
// {0,1,2}. F is a direct recurrence in which opening wins ties (>=) and E
// extends only when strictly better (>), exactly as the reference. Out of
// band and out of range cells are computed and stored as the reference
// does (bases read at clamped indices, NEG state), so tapes match in full.
//
// What bounds it on an H100: D = max_m + max_n diagonals, each depending on
// the previous two, so per item the work is D dependent steps of ww cells
// (ww = 384 or 1152 lanes). Only B items are independent (B = 4..8 for the
// big balanced classes), one block each, so a diagonal runs at one SM's
// INT32 issue rate (64 lanes a cycle, ~60 integer instructions a cell) plus
// the latency of the hand-off between diagonals; the tape (D*ww bytes per
// item, 75 MB for the 32768 class) is written once.
//
// Design: thread t owns the C = 4 consecutive lanes w = t*C + c and keeps
// their H, Htilde, E1, E2, F1, F2 of diagonal d-1 and H of d-2 in
// registers. The band shift makes every neighbour the lane itself or the
// one left or right of it, the same for all lanes on a diagonal: the
// diagonal's body is specialised on the three offsets (27 cases, one
// uniform switch), so a neighbour is one of the thread's registers or, at
// the thread's first or last lane, one shuffle away; at a warp's edge it is
// the neighbouring warp's edge lane, which every warp publishes to shared
// memory (double-buffered by diagonal parity) before the one block barrier
// of the diagonal. The neighbours' H of d-2 across warps are the values
// read on the diagonal before, kept in registers. Which lanes hold valid
// cells, and which have a diagonal neighbour, are two bit masks a thread
// computes once per diagonal. q and r are staged in shared memory once, the
// band offsets in chunks of kChunk ahead of use, so no global load sits in
// the diagonal loop; each thread stores its 4 tape bytes as one word. The
// first design (lanes strided over threads, the state of the last two
// diagonals in shared memory, 7 shared reads and 6 writes and global base
// reads per cell, one byte stored per cell) ran at the same INT32 bound
// and slower (PERF.md).

#include "common.cuh"

using pav::imax;
using pav::imin;
using pav::NEG;

namespace {

__device__ __forceinline__ int sel(int s) { return s == 1 ? 1 : (s == 0 ? 0 : -1); }

constexpr unsigned kFull = 0xffffffffu;
constexpr int C = 4;          // lanes per thread (2 and 8 were slower, PERF.md)
constexpr int kChunk = 256;   // band offsets staged per chunk
constexpr int kPub = 12;      // ints a warp publishes per diagonal

struct Scoring {
  int match, mismatch, o1, o2, e1, e2;
};

__host__ __device__ __forceinline__ int up16(int x) { return (x + 15) & ~15; }

// Lane c's neighbour at offset O in {-1, 0, 1} of the thread's array X;
// `edge` is the value one lane beyond the thread's lanes on the side of O.
template <int O>
__device__ __forceinline__ int nb(const int (&X)[C], int c, int edge) {
  if (O == 0) return X[c];
  if (O < 0) return c > 0 ? X[c - 1] : edge;
  return c < C - 1 ? X[c + 1] : edge;
}

// The value one lane beyond this thread's lanes on the side of O: from the
// neighbouring thread by a shuffle, or at the warp's edge `left` or `right`
// (the neighbouring warp's edge lane, NEG beyond the band).
template <int O>
__device__ __forceinline__ int edge_of(const int (&X)[C], int lane, int left, int right) {
  if (O < 0) {
    const int v = __shfl_up_sync(kFull, X[C - 1], 1);
    return lane == 0 ? left : v;
  }
  if (O > 0) {
    const int v = __shfl_down_sync(kFull, X[0], 1);
    return lane == 31 ? right : v;
  }
  return 0;
}

// Bits c of [lo, hi] (clamped to the thread's C lanes).
__device__ __forceinline__ unsigned lane_mask(int lo, int hi) {
  lo = imax(lo, 0);
  hi = imin(hi + 1, C);
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

// The state of a thread's C lanes: H, Htilde, E1, E2, F1, F2 of the last
// diagonal and H of the one before.
struct Lanes {
  int H[C], HT[C], E1[C], E2[C], F1[C], F2[C], Hpp[C];
};

// One diagonal of a thread's C lanes for the neighbour offsets OU (up: H, E
// of d-1), OL (left: Htilde, F of d-1) and OD (diagonal: H of d-2); returns
// the lanes' tape bytes as one word. lv, rv: the neighbouring warps' edge
// lanes of d-1 (H, HT, E1, E2, F1, F2); lHpp, rHpp: their edge H of d-2.
template <int OU, int OL, int OD>
__device__ __forceinline__ uint32_t diagonal(Lanes& x, const int (&lv)[6], const int (&rv)[6],
                                             int lHpp, int rHpp, int lane, int w0, int doff,
                                             int d, unsigned valid, unsigned dvalid,
                                             const int8_t* sq, const int8_t* sr, int max_m,
                                             int max_n, const Scoring& s) {
  const int eH = edge_of<OU>(x.H, lane, lv[0], rv[0]);
  const int eE1 = edge_of<OU>(x.E1, lane, lv[2], rv[2]);
  const int eE2 = edge_of<OU>(x.E2, lane, lv[3], rv[3]);
  const int eHT = edge_of<OL>(x.HT, lane, lv[1], rv[1]);
  const int eF1 = edge_of<OL>(x.F1, lane, lv[4], rv[4]);
  const int eF2 = edge_of<OL>(x.F2, lane, lv[5], rv[5]);
  const int eHpp = edge_of<OD>(x.Hpp, lane, lHpp, rHpp);
  Lanes y;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = doff + w0 + c, j = d - i;
    const int hup = nb<OU>(x.H, c, eH);
    const int e1o = hup - (s.o1 + s.e1), e1x = nb<OU>(x.E1, c, eE1) - s.e1;
    const int e2o = hup - (s.o2 + s.e2), e2x = nb<OU>(x.E2, c, eE2) - s.e2;
    const int e1n = imax(e1o, e1x), e2n = imax(e2o, e2x);
    const int eb = imax(e1n, e2n);
    const int htlf = nb<OL>(x.HT, c, eHT);
    const int f1o = htlf - (s.o1 + s.e1), f1x = nb<OL>(x.F1, c, eF1) - s.e1;
    const int f2o = htlf - (s.o2 + s.e2), f2x = nb<OL>(x.F2, c, eF2) - s.e2;
    const int f1n = imax(f1o, f1x), f2n = imax(f2o, f2x);
    const int fb = imax(f1n, f2n);

    const int qv = sq[imin(imax(i - 1, 0), max_m - 1)];
    const int rv_ = sr[imin(imax(j - 1, 0), max_n - 1)];
    const int sub = (qv == rv_ && qv < 4 && rv_ < 4) ? s.match : s.mismatch;
    const int diag = ((dvalid >> c) & 1u) ? nb<OD>(x.Hpp, c, eHpp) + sub : NEG;
    const int ht = imax(diag, eb);
    const int hn = imax(ht, fb);

    const bool ok = (valid >> c) & 1u;
    y.H[c] = ok ? hn : NEG;
    y.HT[c] = ok ? ht : NEG;
    y.E1[c] = ok ? e1n : NEG;
    y.E2[c] = ok ? e2n : NEG;
    y.F1[c] = ok ? f1n : NEG;
    y.F2[c] = ok ? f2n : NEG;
    y.Hpp[c] = x.H[c];
    const unsigned byte = (eb > diag) | ((fb > ht) << 1) | ((e2n > e1n) << 2) |
                          ((f2n > f1n) << 3) | ((e1x > e1o) << 4) | ((e2x > e2o) << 5) |
                          ((f1o >= f1x) << 6) | ((f2o >= f2x) << 7);
    word |= static_cast<uint32_t>(byte) << (8 * c);
  }
  x = y;
  return word;
}

__global__ void __launch_bounds__(1024) dp_wave_kernel(const int8_t* __restrict__ q,
                                                       const int8_t* __restrict__ r,
                                                       const int* __restrict__ m,
                                                       const int* __restrict__ n,
                                                       const int* __restrict__ doffs,
                                                       uint8_t* __restrict__ tb, int max_m,
                                                       int max_n, int ww, Scoring s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, wi = t >> 5, W = T >> 5;
  const int b = blockIdx.x;
  const int D = max_m + max_n;
  int* pub = reinterpret_cast<int*>(smem);    // [2][W][kPub]: first lanes, then last lanes
  int* ring = pub + 2 * W * kPub;             // [2][kChunk] band offsets
  int8_t* sq = reinterpret_cast<int8_t*>(ring + 2 * kChunk);
  int8_t* sr = sq + up16(max_m);

  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  const int* db = doffs + static_cast<size_t>(b) * D;
  uint8_t* tbb = tb + static_cast<size_t>(b) * D * ww;
  for (int x = t; x < max_m; x += T) sq[x] = qb[x];
  for (int x = t; x < max_n; x += T) sr[x] = rb[x];
  for (int x = t; x < kChunk && x < D; x += T) ring[x] = db[x];

  const int w0 = t * C;
  // Diagonal 0: lane 0 is cell (0, 0), H = Htilde = 0.
  Lanes x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x.H[c] = w0 + c == 0 ? 0 : NEG;
    x.HT[c] = x.H[c];
    x.E1[c] = x.E2[c] = x.F1[c] = x.F2[c] = x.Hpp[c] = NEG;
  }
  if (lane == 0) {
    int* P = pub + wi * kPub;
    P[0] = x.H[0]; P[1] = x.HT[0]; P[2] = x.E1[0]; P[3] = x.E2[0]; P[4] = x.F1[0];
    P[5] = x.F2[0];
  }
  if (lane == 31) {
    int* P = pub + wi * kPub + 6;
    P[0] = x.H[C - 1]; P[1] = x.HT[C - 1]; P[2] = x.E1[C - 1]; P[3] = x.E2[C - 1];
    P[4] = x.F1[C - 1]; P[5] = x.F2[C - 1];
  }
  int lHpp = NEG, rHpp = NEG;   // the neighbouring warps' edge H of diagonal d-2
  int dprev1 = 0, dprev2 = 0;
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    const int d = k + 1;
    if ((k & (kChunk - 1)) == 0) {   // the offsets of the chunk after next
      int* dst = ring + ((k / kChunk + 1) & 1) * kChunk;
      for (int z = t; z < kChunk && k + kChunk + z < D; z += T) dst[z] = db[k + kChunk + z];
    }
    const int doff = ring[((k / kChunk) & 1) * kChunk + (k & (kChunk - 1))];
    const int t1 = doff - dprev1, t2 = doff - dprev2;
    dprev2 = dprev1;
    dprev1 = doff;

    // The neighbouring warps' edge lanes of diagonal d-1.
    const int* P = pub + ((d - 1) & 1) * W * kPub;
    int lv[6], rv[6];
#pragma unroll
    for (int z = 0; z < 6; ++z) {
      lv[z] = lane == 0 && wi > 0 ? P[(wi - 1) * kPub + 6 + z] : NEG;
      rv[z] = lane == 31 && wi + 1 < W ? P[(wi + 1) * kPub + z] : NEG;
    }
    // Lanes holding valid cells (i <= m, 0 <= j <= n, w < ww), and those
    // whose diagonal neighbour exists (i >= 1, j >= 1).
    const unsigned valid =
        lane_mask(d - ni - doff - w0, imin(imin(mi, d) - doff, ww - 1) - w0);
    const unsigned dvalid = lane_mask(1 - doff - w0, d - 1 - doff - w0);

    // Neighbour offsets, as the reference's shift_sel reads them: 1 -> +1,
    // 0 -> 0, anything else -> -1.
    const int ou = sel(t1 - 1), ol = sel(t1), od = sel(t2 - 1);
    uint32_t word;
#define PAV_WAVE_CASE(U, L_, D_)                                                              \
  case (U + 1) * 9 + (L_ + 1) * 3 + (D_ + 1):                                                \
    word = diagonal<U, L_, D_>(x, lv, rv, lHpp, rHpp, lane, w0, doff, d, valid, dvalid,      \
                               sq, sr, max_m, max_n, s);                                     \
    break;
    switch ((ou + 1) * 9 + (ol + 1) * 3 + (od + 1)) {
      PAV_WAVE_CASE(-1, -1, -1) PAV_WAVE_CASE(-1, -1, 0) PAV_WAVE_CASE(-1, -1, 1)
      PAV_WAVE_CASE(-1, 0, -1) PAV_WAVE_CASE(-1, 0, 0) PAV_WAVE_CASE(-1, 0, 1)
      PAV_WAVE_CASE(-1, 1, -1) PAV_WAVE_CASE(-1, 1, 0) PAV_WAVE_CASE(-1, 1, 1)
      PAV_WAVE_CASE(0, -1, -1) PAV_WAVE_CASE(0, -1, 0) PAV_WAVE_CASE(0, -1, 1)
      PAV_WAVE_CASE(0, 0, -1) PAV_WAVE_CASE(0, 0, 0) PAV_WAVE_CASE(0, 0, 1)
      PAV_WAVE_CASE(0, 1, -1) PAV_WAVE_CASE(0, 1, 0) PAV_WAVE_CASE(0, 1, 1)
      PAV_WAVE_CASE(1, -1, -1) PAV_WAVE_CASE(1, -1, 0) PAV_WAVE_CASE(1, -1, 1)
      PAV_WAVE_CASE(1, 0, -1) PAV_WAVE_CASE(1, 0, 0) PAV_WAVE_CASE(1, 0, 1)
      default:   // (1, 1, 1), the last of the 27
        word = diagonal<1, 1, 1>(x, lv, rv, lHpp, rHpp, lane, w0, doff, d, valid, dvalid, sq, sr,
                                 max_m, max_n, s);
        break;
    }
#undef PAV_WAVE_CASE
    lHpp = lv[0];
    rHpp = rv[0];
    // Row 0: cell (0, d) has H = -gapcost(d), whatever the recurrence gave.
    if (doff == 0 && w0 == 0) {
      x.H[0] = (valid & 1u) ? -pav::gap_cost(d, s.o1, s.o2, s.e1, s.e2) : NEG;
    }
    if (w0 < ww) {
      *reinterpret_cast<uint32_t*>(tbb + static_cast<size_t>(k) * ww + w0) = word;
    }
    int* Q = pub + (d & 1) * W * kPub + wi * kPub;
    if (lane == 0) {
      Q[0] = x.H[0]; Q[1] = x.HT[0]; Q[2] = x.E1[0]; Q[3] = x.E2[0]; Q[4] = x.F1[0];
      Q[5] = x.F2[0];
    }
    if (lane == 31) {
      Q[6] = x.H[C - 1]; Q[7] = x.HT[C - 1]; Q[8] = x.E1[C - 1]; Q[9] = x.E2[C - 1];
      Q[10] = x.F1[C - 1]; Q[11] = x.F2[C - 1];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pav_dp_wave(const void* q, const void* r, const void* m,
                           const void* n, const void* doffs, void* tb, int B,
                           int max_m, int max_n, int ww, int match,
                           int mismatch, int o1, int o2, int e1, int e2,
                           void* stream) {
  if (B == 0) return 0;
  const int W = (ww + 32 * C - 1) / (32 * C);
  const size_t smem = static_cast<size_t>(2 * W * kPub + 2 * kChunk) * sizeof(int) +
                      up16(max_m) + up16(max_n);
  if (ww % C != 0 || W * 32 > 1024 || smem > static_cast<size_t>(pav::kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = pav::set_smem(dp_wave_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_wave_kernel<<<B, 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), static_cast<const int*>(m),
      static_cast<const int*>(n), static_cast<const int*>(doffs), static_cast<uint8_t*>(tb),
      max_m, max_n, ww, Scoring{match, mismatch, o1, o2, e1, e2});
  return static_cast<int>(cudaGetLastError());
}
