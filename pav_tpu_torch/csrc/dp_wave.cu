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
// (ww = 384 or 1152 lanes): a barrier per diagonal and a few dozen integer
// ops per cell. Only B items are independent (B = 4..8 for the big
// balanced classes), so the card is latency bound on the diagonal loop; the
// tape (D*ww bytes per item, 75 MB for the 32768 class) is written once.
//
// Design: one thread block per item, lanes across threads (strided, w =
// k*T + t, so each tape row is stored coalesced; 1152 lanes run as 2 lanes
// on 576 threads). The state of the last two diagonals lives in shared
// memory, rotated by diagonal parity: H in three buffers (d, d-1, d-2), and
// Htilde, E1, E2, F1, F2 in two, each padded with a NEG guard lane at both
// ends so the +-1 neighbour reads need no branch: 13*(ww+2) ints, 60 KB at
// ww = 1152. The diagonal loop runs inside the kernel with one
// __syncthreads() per diagonal. Query and reference bases are read from
// global memory for each cell (i-1 and j-1, consecutive across lanes); the
// TPU kernel's sliding q/r windows existed to avoid a gather and are not
// carried over.

#include "common.cuh"

using pav::imax;
using pav::imin;
using pav::NEG;

namespace {

__device__ __forceinline__ int sel(int s) { return s == 1 ? 1 : (s == 0 ? 0 : -1); }

__global__ void dp_wave_kernel(const int8_t* __restrict__ q,
                               const int8_t* __restrict__ r,
                               const int* __restrict__ m,
                               const int* __restrict__ n,
                               const int* __restrict__ doffs,
                               uint8_t* __restrict__ tb,
                               int max_m, int max_n, int ww, int K,
                               int match, int mismatch,
                               int o1, int o2, int e1, int e2) {
  extern __shared__ int sm[];
  const int T = blockDim.x, t = threadIdx.x, b = blockIdx.x;
  const int D = max_m + max_n;
  const int P = ww + 2;        // lane w lives at index w + 1
  int* Hb = sm;                // [3][P]
  int* HTb = sm + 3 * P;       // [2][P]
  int* E1b = sm + 5 * P;
  int* E2b = sm + 7 * P;
  int* F1b = sm + 9 * P;
  int* F2b = sm + 11 * P;
  for (int x = t; x < 13 * P; x += T) sm[x] = NEG;
  __syncthreads();
  if (t == 0) {                // diagonal 0: lane 0 is cell (0, 0), H = 0
    Hb[1] = 0;
    HTb[1] = 0;
  }
  __syncthreads();

  const int mi = m[b], ni = n[b];
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rbase = r + static_cast<size_t>(b) * max_n;
  const int* db = doffs + static_cast<size_t>(b) * D;
  uint8_t* tbb = tb + static_cast<size_t>(b) * D * ww;

  for (int k = 0; k < D; ++k) {
    const int d = k + 1;
    const int doff = db[k];
    const int t1 = doff - (k >= 1 ? db[k - 1] : 0);
    const int t2 = doff - (k >= 2 ? db[k - 2] : 0);
    // Lane offsets of the neighbours, as the reference's shift_sel reads
    // them: 1 -> +1, 0 -> 0, anything else -> -1.
    const int o_up = sel(t1 - 1), o_lf = sel(t1), o_dg = sel(t2 - 1);
    int* Hc = Hb + (d % 3) * P;
    const int* Hp = Hb + ((d + 2) % 3) * P;
    const int* Hpp = Hb + ((d + 1) % 3) * P;
    const int cur = (d & 1) * P, prev = ((d + 1) & 1) * P;
    uint8_t* row = tbb + static_cast<size_t>(k) * ww;
    for (int kk = 0; kk < K; ++kk) {
      const int w = kk * T + t;
      if (w >= ww) break;
      const int i = doff + w, j = d - i;
      const bool valid = i <= mi && j >= 0 && j <= ni;
      // Neighbours on d-1 above and left, on d-2 diagonal; padded index =
      // lane + 1.
      const int hup = Hp[w + o_up + 1];
      const int e1up = E1b[prev + w + o_up + 1];
      const int e2up = E2b[prev + w + o_up + 1];
      const int htlf = HTb[prev + w + o_lf + 1];
      const int f1lf = F1b[prev + w + o_lf + 1];
      const int f2lf = F2b[prev + w + o_lf + 1];
      const int hdg = Hpp[w + o_dg + 1];

      const int e1o = hup - (o1 + e1), e1x = e1up - e1;
      const int e1n = imax(e1o, e1x);
      const int e2o = hup - (o2 + e2), e2x = e2up - e2;
      const int e2n = imax(e2o, e2x);
      const int eb = imax(e1n, e2n);

      const int f1o = htlf - (o1 + e1), f1x = f1lf - e1;
      const int f1n = imax(f1o, f1x);
      const int f2o = htlf - (o2 + e2), f2x = f2lf - e2;
      const int f2n = imax(f2o, f2x);
      const int fb = imax(f1n, f2n);

      const int qv = qb[imin(imax(i - 1, 0), max_m - 1)];
      const int rv = rbase[imin(imax(j - 1, 0), max_n - 1)];
      const int sub = (qv == rv && qv < 4 && rv < 4) ? match : mismatch;
      const int diag = (i >= 1 && j >= 1) ? hdg + sub : NEG;
      const int ht = imax(diag, eb);
      int hn = imax(ht, fb);
      if (i == 0) hn = (j == 0) ? 0 : -pav::gap_cost(j, o1, o2, e1, e2);

      Hc[w + 1] = valid ? hn : NEG;
      HTb[cur + w + 1] = valid ? ht : NEG;
      E1b[cur + w + 1] = valid ? e1n : NEG;
      E2b[cur + w + 1] = valid ? e2n : NEG;
      F1b[cur + w + 1] = valid ? f1n : NEG;
      F2b[cur + w + 1] = valid ? f2n : NEG;
      row[w] = static_cast<uint8_t>(
          (eb > diag) | ((fb > ht) << 1) | ((e2n > e1n) << 2) |
          ((f2n > f1n) << 3) | ((e1x > e1o) << 4) | ((e2x > e2o) << 5) |
          ((f1o >= f1x) << 6) | ((f2o >= f2x) << 7));
    }
    __syncthreads();
  }
}

void geometry(int ww, int& T, int& K) {
  K = (ww + 1023) / 1024;
  const int per = (ww + K - 1) / K;
  T = ((per + 31) / 32) * 32;
}

}  // namespace

extern "C" int pav_dp_wave(const void* q, const void* r, const void* m,
                           const void* n, const void* doffs, void* tb, int B,
                           int max_m, int max_n, int ww, int match,
                           int mismatch, int o1, int o2, int e1, int e2,
                           void* stream) {
  if (B == 0) return 0;
  int T, K;
  geometry(ww, T, K);
  const size_t smem = static_cast<size_t>(13) * (ww + 2) * sizeof(int);
  if (smem > static_cast<size_t>(pav::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = pav::set_smem(dp_wave_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_wave_kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
      static_cast<const int*>(m), static_cast<const int*>(n),
      static_cast<const int*>(doffs), static_cast<uint8_t*>(tb),
      max_m, max_n, ww, K, match, mismatch, o1, o2, e1, e2);
  return static_cast<int>(cudaGetLastError());
}
