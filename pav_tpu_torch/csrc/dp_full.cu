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
// except the horizontal gap F, an exclusive prefix max over the row. The
// tape write (B*max_m*width bytes) is small next to ~60 integer ops per
// cell, so the kernel is bound by integer issue and by the two block
// barriers of each row, not by HBM. The widest classes reach width 32769
// (16 x 32768), whose H/E1/E2/Htilde rows are 4 x 4 x 32769 bytes = 524 KB
// per item: more than a block's 227 KB of shared memory, and far more than
// registers hold at 1024 threads (64 per thread).
//
// Design: one thread block per item. Thread t owns K consecutive columns
// j = t*K + k (K = ceil(width/1024)); the per-column state lives in a buffer
// laid out [4][K][T] (lane k of every thread contiguous, so a sweep over k
// is conflict-free in shared memory and coalesced in global memory). The
// buffer sits in shared memory while 16*K*T bytes fit (widths up to 8193);
// above that it is global scratch given by the caller, which stays in L2 at
// the batch sizes of those classes. A row takes two passes over the
// thread's columns: pass 1 computes E1/E2, the diagonal and Htilde, and the
// thread's running max of Htilde + j*e for both gap pieces; a block scan
// (shuffles inside a warp, shared memory across warps) turns those into
// each thread's exclusive prefix max; pass 2 finishes F, H and the byte.
// The left neighbours H[i-1][j-1] and Htilde[i][j-1] of a thread's first
// column are read from the neighbour thread's slot in the buffer; the scan
// barrier orders those reads before the writes of pass 2. The bytes of a
// row collect in shared memory (two buffers, alternating rows) and are
// stored coalesced. Ties follow the reference exactly: F "opened at the
// previous column" means run == Htilde[j-1] + (j-1)*e, exact in int32.
// Small classes (16 x 17, the bulk by count) get one warp per item; packing
// several items into a block is later work.

#include "common.cuh"

using pav::imax;
using pav::NEG;

namespace {

// Exclusive max-scan across the block of two values, identity NEG.
// blockDim.x is a multiple of 32; wt holds 2 ints per warp.
__device__ __forceinline__ void block_excl_max2(int v1, int v2, int* wt,
                                                int& x1, int& x2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i1 = v1, i2 = v2;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, i1, s);
    const int c = __shfl_up_sync(0xffffffffu, i2, s);
    if (lane >= s) {
      i1 = imax(i1, a);
      i2 = imax(i2, c);
    }
  }
  int e1 = __shfl_up_sync(0xffffffffu, i1, 1);
  int e2 = __shfl_up_sync(0xffffffffu, i2, 1);
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

constexpr int kHeader = 256;   // bytes of shared memory before the buffers

__global__ void dp_full_kernel(const int8_t* __restrict__ q,
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

void geometry(int width, int& T, int& K) {
  K = (width + 1023) / 1024;
  const int per = (width + K - 1) / K;
  T = ((per + 31) / 32) * 32;
}

size_t smem_in_shared(int width) {
  int T, K;
  geometry(width, T, K);
  const size_t wpad = (width + 15) & ~15;
  return kHeader + static_cast<size_t>(16) * T * K + 2 * wpad;
}

}  // namespace

// Ints of global scratch per item (0 when the state fits shared memory).
extern "C" int pav_dp_full_scratch_ints(int width) {
  if (smem_in_shared(width) <= pav::kMaxSmem) return 0;
  int T, K;
  geometry(width, T, K);
  return 4 * T * K;
}

extern "C" int pav_dp_full(const void* q, const void* r, const void* m,
                           const void* n, void* tb, void* scratch, int B,
                           int max_m, int max_n, int width, int match,
                           int mismatch, int o1, int o2, int e1, int e2,
                           void* stream) {
  if (B == 0) return 0;
  int T, K;
  geometry(width, T, K);
  const bool shared = pav_dp_full_scratch_ints(width) == 0;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t wpad = (width + 15) & ~15;
  const size_t smem = shared ? smem_in_shared(width) : kHeader + 2 * wpad;
  cudaError_t err = pav::set_smem(dp_full_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_full_kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
      static_cast<const int*>(m), static_cast<const int*>(n),
      static_cast<uint8_t*>(tb), shared ? nullptr : static_cast<int*>(scratch),
      max_m, max_n, width, K, match, mismatch, o1, o2, e1, e2);
  return static_cast<int>(cudaGetLastError());
}
