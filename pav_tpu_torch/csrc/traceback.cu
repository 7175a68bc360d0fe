// Traceback walker: DP tape -> fused 2-bit step tape, path length, err flag.
//
// Replaces the XLA walker inside pav_tpu/ops/affine_dp.py::_align_and_trace_impl
// (the `one` scan at affine_dp.py:767-855). Per item, from (m, n) towards
// (0, 0), L = roundup4(max_m + max_n) steps, carrying the state H/E/F and the
// gap piece; each step reads one tape byte, emits a step code (0 '=', 1 'X',
// 2 'I', 3 'D'; nothing once at (0, 0)) and moves. It reads either tape
// geometry: rows (full width: row = i-1, lane = j - offs[row]) or
// anti-diagonals (wave: row = i+j-1, lane = i - offs[row]). Output row b of
// out is [L/4 packed codes (4 per byte, first step in the low bits) | 4-byte
// little-endian path length | err byte], bit-identical to the reference,
// including both err updates and the final (i > 0) | (j > 0).
//
// What bounds it on an H100: the walk is sequential per item (up to L =
// 65536 steps for the 32768 class) and each step is a dependent load from
// the tape at a data-dependent address: latency bound, one item per thread.
// Written as torch ops it would be L launches per call; as one kernel it is
// a single launch whose time is L dependent loads, with B threads in flight
// to hide them.
//
// Design: one thread per item, 128 threads per block; codes are packed in a
// register and stored one byte per four steps.

#include "common.cuh"

using pav::imax;
using pav::imin;

namespace {

__global__ void traceback_kernel(const uint8_t* __restrict__ tb,
                                 const int* __restrict__ offs,
                                 const int8_t* __restrict__ q,
                                 const int8_t* __restrict__ r,
                                 const int* __restrict__ m,
                                 const int* __restrict__ n,
                                 uint8_t* __restrict__ out,
                                 int B, int rows, int w_dim, int max_m,
                                 int max_n, int L, int wave) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* tbb = tb + static_cast<size_t>(b) * rows * w_dim;
  const int* ob = offs + static_cast<size_t>(b) * rows;
  const int8_t* qb = q + static_cast<size_t>(b) * max_m;
  const int8_t* rb = r + static_cast<size_t>(b) * max_n;
  uint8_t* o = out + static_cast<size_t>(b) * (L / 4 + 5);

  int i = m[b], j = n[b], st = 0, piece = 0, err = 0, path_len = 0;
  unsigned acc = 0;
  for (int s = 0; s < L; ++s) {
    const bool done = i <= 0 && j <= 0;
    const bool at_top = i <= 0 && j > 0;
    const bool at_left = j <= 0 && i > 0;
    int row, w;
    if (wave) {
      row = imax(i + j - 1, 0);
      w = i - ob[row];
    } else {
      row = imax(i - 1, 0);
      w = j - ob[row];
    }
    const bool in_band = w >= 0 && w < w_dim;
    const int byte = tbb[static_cast<size_t>(row) * w_dim + imin(imax(w, 0), w_dim - 1)];

    const int act_h = (byte & 2) ? 2 : ((byte & 1) ? 1 : 0);   // 0 diag, 1 E, 2 F
    int act = (st == 0) ? act_h : st;
    const int new_piece = (st == 0 && act == 1) ? ((byte >> 2) & 1)
                        : (st == 0 && act == 2) ? ((byte >> 3) & 1) : piece;
    act = at_top ? 2 : (at_left ? 1 : act);

    const int qv = qb[imax(i - 1, 0)], rv = rb[imax(j - 1, 0)];
    const int diag_code = (qv == rv && qv < 4 && rv < 4) ? 0 : 1;
    const int e_ext = new_piece == 0 ? (byte >> 4) & 1 : (byte >> 5) & 1;
    const int f_open = new_piece == 0 ? (byte >> 6) & 1 : (byte >> 7) & 1;
    const int code = act == 0 ? diag_code : (act == 1 ? 2 : 3);
    const int di = (act == 0 || act == 1) ? 1 : 0;
    const int dj = (act == 0 || act == 2) ? 1 : 0;
    const int e_ext_eff = at_left ? 1 : e_ext;
    const int f_open_eff = at_top ? 0 : f_open;
    const int new_st = act == 0 ? 0
                     : act == 1 ? (e_ext_eff == 1 ? 1 : 0)
                                : (f_open_eff == 1 ? 0 : 2);
    const int inside = !done && !at_top && !at_left && !in_band;
    err |= inside && st == 0 && act == 0;   // affine_dp.py:824
    err |= inside;                           // affine_dp.py:825

    if (!done) {
      i -= di;
      j -= dj;
      st = new_st;
      ++path_len;
      acc |= static_cast<unsigned>(code) << (2 * (s & 3));
    }
    piece = new_piece;
    if ((s & 3) == 3) {
      o[s >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
  }
  err |= (i > 0) || (j > 0);
  const int base = L / 4;
  o[base + 0] = static_cast<uint8_t>(path_len & 0xff);
  o[base + 1] = static_cast<uint8_t>((path_len >> 8) & 0xff);
  o[base + 2] = static_cast<uint8_t>((path_len >> 16) & 0xff);
  o[base + 3] = static_cast<uint8_t>((path_len >> 24) & 0xff);
  o[base + 4] = static_cast<uint8_t>(err);
}

}  // namespace

extern "C" int pav_traceback(const void* tb, const void* offs, const void* q,
                             const void* r, const void* m, const void* n,
                             void* out, int B, int rows, int w_dim, int max_m,
                             int max_n, int L, int wave, void* stream) {
  if (B == 0) return 0;
  if (L % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  traceback_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const int*>(offs),
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
      static_cast<const int*>(m), static_cast<const int*>(n),
      static_cast<uint8_t*>(out), B, rows, w_dim, max_m, max_n, L, wave);
  return static_cast<int>(cudaGetLastError());
}

// Message for a CUDA error code returned by any entry of this library.
extern "C" const char* pav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
