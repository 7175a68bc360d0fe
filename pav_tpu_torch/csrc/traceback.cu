// Traceback walker: DP tape -> fused 2-bit step tape, path length, err flag.
//
// Replaces the XLA walker inside pav_tpu/ops/affine_dp.py::_align_and_trace_impl
// (the `one` scan at affine_dp.py:767-855). Per item, from (m, n) towards
// (0, 0), at most L = roundup4(max_m + max_n) steps, carrying the state
// H/E/F and the gap piece; each step reads one tape byte, emits a step code
// (0 '=', 1 'X', 2 'I', 3 'D') and moves. It reads either tape geometry:
// rows (full width: row = i-1, lane = j; the tape of align_full, whose
// offsets are zeros and are not read) or anti-diagonals (wave: row = i+j-1,
// lane = i - offs[row], clamped to the band, err set outside it). Output
// row b of out is [L/4 packed codes (4 per byte, first step in the low
// bits; zeros past the path) | 4-byte little-endian path length | err
// byte], bit-identical to the reference, including both err updates and
// the final (i > 0) | (j > 0).
//
// What bounds it on an H100: each step's tape address depends on the byte
// read by the step before, so an item's walk is sequential: not bytes or
// operations over the card, but the latency and the instructions of one
// step on one warp (measured: ~50-60 instructions, 70-160 ns a step;
// locating the next cells before the byte arrives, to shorten the chain of
// dependent reads, was no faster). The first design (one thread per item,
// straight from global memory) paid an L2 round trip or two per step (offs,
// then the byte), walked all L steps whatever the path length, and ran
// B = 8 items on 8 lanes of one SM.
//
// Design. The walk reads shared memory only, ~10x shorter latency than L2,
// in groups of four steps without a branch (a step after the walk's end
// changes nothing):
//  * traceback_windows (items whose staged tape exceeds the whole-tape
//    limit): one warp per item, one block per warp, so B items use B SMs.
//    The warp stages a window of the tape that the walk enters next, with
//    the q, r (and wave: offs) bytes it needs, by 16-byte cp.async copies:
//    full width, kRowsF rows x kColsF columns ending at the walk's cell;
//    wave, kRowsW diagonals x (2 kHalfW + 1) lanes around it. Every lane
//    walks the same path from shared memory (warp-uniform, so the warp stays
//    converged for the copies). When, at a group's end, the walk is within
//    half a window of the lower row or lane edge, the warp stages the next
//    window at the walk's cell into the other buffer and moves to it
//    kSwitch steps later, so the copy's latency hides behind the walk.
//  * traceback_whole (tapes up to 200 KB staged, when the launch fits one
//    wave of resident blocks): the warp stages the whole tapes of G items
//    and lane g walks item g; G shrinks for small batches so that enough
//    warps are in flight.
//  * A staged tape row keeps its global address mod 16 (row stride S == the
//    tape's row stride mod 16), so cell (row, lane) is at row * S + lane +
//    tk in either layout.
//  * The walk stops at the first edge (i = 0 or j = 0): the rest of the path
//    is a run of I or D codes, written in bulk with the zero tail.

#include "common.cuh"

using pav::imax;
using pav::imin;

namespace {

constexpr int kRowsF = 64;     // full-width window: tape rows
constexpr int kColsF = 128;    // ... and columns
constexpr int kRowsW = 128;    // wave window: diagonals
constexpr int kHalfW = 48;     // ... and lanes either side of the walk's lane
constexpr int kSwitch = 16;    // steps (at least) from staging a window to walking it
constexpr int kWholeSmem = 200 * 1024;  // shared memory of a traceback_whole block
constexpr int kMinWarps = 4 * 132;      // traceback_whole: warps wanted in flight

// Bytes of one item's staged tape, q, r and offs up to which
// traceback_whole stages the whole tape (pav_traceback_whole_max changes
// it, for timing).
int g_whole_max = kWholeSmem;

__host__ __device__ __forceinline__ int up16(int x) { return (x + 15) & ~15; }

// A staging buffer: tape rows of S bytes (S == w_dim mod 16), then q, r and
// offs spans; every part starts 16-byte aligned.
struct Layout {
  int S, q, r, o, total;
};

__host__ __device__ __forceinline__ Layout make_layout(int rows, int lanes, int qlen,
                                                       int rlen, int olen, int w_dim) {
  Layout L;
  const int need = up16(lanes + 15);
  L.S = need + ((w_dim - need) & 15);
  L.q = up16(rows * L.S + 16);
  L.r = L.q + up16(qlen + 16);
  L.o = L.r + up16(rlen + 16) + 16;   // 16 bytes below the offs: rows -1, -2
  L.total = L.o + up16(4 * olen + 16);
  return L;
}

Layout window_layout(bool wave, int w_dim) {
  return wave ? make_layout(kRowsW, 2 * kHalfW + 1, kRowsW, kRowsW, kRowsW + 2, w_dim)
              : make_layout(kRowsF, kColsF, kRowsF, kColsF, 0, w_dim);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Stage bytes [g, g + len) at s + (g mod 16), whole aligned 16-byte chunks,
// lane `lane` of `nl` taking every nl-th chunk; returns g mod 16.
__device__ __forceinline__ int stage_span(uint8_t* s, const void* gp, int len, int lane, int nl) {
  const uintptr_t g = reinterpret_cast<uintptr_t>(gp);
  const int sh = static_cast<int>(g & 15);
  const int chunks = (sh + len + 15) >> 4;
  for (int k = lane; k < chunks; k += nl) {
    cp16(s + 16 * k, reinterpret_cast<const void*>(g - sh + 16 * k));
  }
  return sh;
}

// Stage tape rows [r_lo, r_lo + nrows) x lanes [l_lo, l_lo + nl) of one
// item's tape (row stride w_dim) at s, row k at s + k * S: cell (row, lane)
// lands at s[(row - r_lo) * S + sh + lane - l_lo]; returns sh.
__device__ __forceinline__ int stage_rows(uint8_t* s, const uint8_t* tb, int w_dim, int S,
                                          int r_lo, int nrows, int l_lo, int nl, int lane,
                                          int nlanes) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(tb + static_cast<size_t>(r_lo) * w_dim + l_lo);
  const int sh0 = static_cast<int>(g0 & 15);
  const int cpr = (nl + 30) >> 4;   // chunks a row may straddle
  // Lanes split into row groups of cpr lanes (or all lanes on one row).
  const int per = cpr < nlanes ? nlanes / cpr : 1;
  const int c0 = cpr < nlanes ? lane % cpr : lane;
  const int cstep = cpr < nlanes ? cpr : nlanes;
  for (int k = cpr < nlanes ? lane / cpr : 0; k < nrows; k += per) {
    if (cpr < nlanes && lane >= per * cpr) break;
    const uintptr_t gk = g0 + static_cast<size_t>(k) * w_dim;
    const int shk = static_cast<int>(gk & 15);
    for (int c = c0; c < cpr && 16 * c < shk + nl; c += cstep) {
      cp16(s + k * S + sh0 - shk + 16 * c, reinterpret_cast<const void*>(gk - shk + 16 * c));
    }
  }
  return sh0;
}

struct Item {
  const uint8_t* tb;   // [rows, w_dim]
  const int* offs;     // [rows]
  const int8_t* q;     // [max_m]
  const int8_t* r;     // [max_n]
};

struct Args {
  const uint8_t* tb;
  const int* offs;
  const int8_t* q;
  const int8_t* r;
  const int* m;
  const int* n;
  uint8_t* out;
  int B, rows, w_dim, max_m, max_n, L;
};

__device__ __forceinline__ Item item(const Args& a, int b) {
  return {a.tb + static_cast<size_t>(b) * a.rows * a.w_dim, a.offs + static_cast<size_t>(b) * a.rows,
          a.q + static_cast<size_t>(b) * a.max_m, a.r + static_cast<size_t>(b) * a.max_n};
}

// A staged window: tape byte of (row, lane) at T[row * S + lane + tk], q[i-1]
// at Q[i - 1 + qk], r[j-1] at R[j - 1 + rk], offs[row] at O[row + ok]; it
// holds rows >= r_lo and lanes [l_lo, l_hi].
struct Win {
  int tk, qk, rk, ok, r_lo, l_lo, l_hi;
};

__device__ __forceinline__ int clamp_lane(int x, int w_dim) { return imin(imax(x, 0), w_dim - 1); }

// Stage the window of the cell (ia, ja) on tape row row_a, clamped lane la.
template <bool WAVE>
__device__ __forceinline__ void stage_window(const Item& it, const Args& a, uint8_t* buf,
                                             const Layout& ly, Win& w, int ia, int ja, int row_a,
                                             int la, int lane) {
  constexpr int NR = WAVE ? kRowsW : kRowsF;
  w.r_lo = imax(row_a - NR + 1, 0);
  if (WAVE) {
    w.l_lo = imax(la - kHalfW, 0);
    w.l_hi = imin(la + kHalfW, a.w_dim - 1);
  } else {
    w.l_lo = imax(la - kColsF + 1, 0);
    w.l_hi = la;
  }
  const int sh = stage_rows(buf, it.tb, a.w_dim, ly.S, w.r_lo, row_a - w.r_lo + 1, w.l_lo,
                            w.l_hi - w.l_lo + 1, lane, 32);
  w.tk = sh - w.r_lo * ly.S - w.l_lo;
  // The walk moves one tape row (wave: one or two diagonals) and at most one
  // of i and j per step, so in the window i - 1 >= q_lo and j - 1 >= r_lo.
  const int q_lo = WAVE ? imax(ia - NR, 0) : w.r_lo;
  const int r_lo = WAVE ? imax(ja - NR, 0) : imax(w.l_lo - 1, 0);
  w.qk = stage_span(buf + ly.q, it.q + q_lo, ia - q_lo, lane, 32) - q_lo;
  w.rk = stage_span(buf + ly.r, it.r + r_lo, ja - r_lo, lane, 32) - r_lo;
  if (WAVE) {
    const int o_lo = imax(w.r_lo - 2, 0);
    w.ok = stage_span(buf + ly.o, it.offs + o_lo, 4 * (row_a - o_lo + 1), lane, 32) / 4 - o_lo;
  }
  cp_commit();
}

// One step from cell (i, j), i, j > 0, whose tape byte is `byte`, with
// qv = q[i-1], rv = r[j-1] and inb = the cell is in the band (the reference's
// step body, affine_dp.py:773-832, without its edge cases). Returns the code.
__device__ __forceinline__ unsigned step(int byte, int qv, int rv, bool inb, int& i, int& j,
                                         int& st, int& piece, int& err) {
  const int act_h = (byte & 2) ? 2 : (byte & 1);   // 0 diag, 1 E, 2 F
  const int act = st != 0 ? st : act_h;
  const int new_piece = st != 0 ? piece
                      : act == 1 ? (byte >> 2) & 1
                      : act == 2 ? (byte >> 3) & 1 : piece;
  const int e_ext = new_piece ? (byte >> 5) & 1 : (byte >> 4) & 1;
  const int f_open = new_piece ? (byte >> 7) & 1 : (byte >> 6) & 1;
  const int code = act == 0 ? ((qv == rv && qv < 4 && rv < 4) ? 0 : 1) : act + 1;
  err |= !inb && st == 0 && act == 0;   // affine_dp.py:824
  err |= !inb;                          // affine_dp.py:825
  st = act == 0 ? 0 : act == 1 ? e_ext : (f_open ? 0 : 2);
  piece = new_piece;
  i -= act != 2;
  j -= act != 1;
  return static_cast<unsigned>(code);
}

// The staged bytes a walk reads: tape byte of (row, lane) at
// T[row * S + lane + tk], q[i-1] at Q[i - 1 + qk], r[j-1] at R[j - 1 + rk],
// offs[row] at O[row + ok].
struct View {
  const uint8_t* T;
  const int8_t* Q;
  const int8_t* R;
  const int* O;
  int S, tk, qk, rk, ok;
};

__device__ __forceinline__ View view(const uint8_t* buf, const Layout& ly, int tk, int qk, int rk,
                                     int ok) {
  return {buf, reinterpret_cast<const int8_t*>(buf + ly.q),
          reinterpret_cast<const int8_t*>(buf + ly.r), reinterpret_cast<const int*>(buf + ly.o),
          ly.S, tk, qk, rk, ok};
}

// A walk at cell (i, j) on tape row `row`, clamped lane `lc` (`inb`: in the
// band), after s steps; acc holds the codes of the current group.
struct Walk {
  int i, j, st, piece, err, s, row, lc;
  bool inb;
  unsigned acc;
};

__device__ __forceinline__ bool alive(const Walk& w, int L) { return w.i > 0 && w.j > 0 && w.s < L; }

// Four steps of the walk (from a step count divisible by 4), without a
// branch: a step once the walk has ended changes nothing, and the cell's
// row and lane move only onto cells with i, j > 0, so every read stays in
// the staged bytes.
template <bool WAVE>
__device__ __forceinline__ void walk4(Walk& w, const View& v, int w_dim, int L) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool on = alive(w, L);
    const int byte = v.T[w.row * v.S + w.lc + v.tk];
    const int qv = v.Q[w.i - 1 + v.qk], rv = v.R[w.j - 1 + v.rk];
    const int o1 = WAVE ? v.O[w.row - 1 + v.ok] : 0, o2 = WAVE ? v.O[w.row - 2 + v.ok] : 0;
    int i = w.i, j = w.j, st = w.st, piece = w.piece, err = w.err;
    const unsigned code = step(byte, qv, rv, w.inb, i, j, st, piece, err);
    int row, lc;
    bool inb = true;
    if (WAVE) {
      const bool dg = i != w.i && j != w.j;          // a diagonal step: two diagonals back
      row = w.row - 1 - dg;
      const int raw = i - (dg ? o2 : o1);
      lc = clamp_lane(raw, w_dim);
      inb = raw == lc;
    } else {
      row = i - 1;
      lc = j;
    }
    const bool move = on && i > 0 && j > 0;
    w.acc |= on ? code << (2 * u) : 0u;
    w.s += on;
    w.err = on ? err : w.err;
    w.st = on ? st : w.st;
    w.piece = on ? piece : w.piece;
    w.i = on ? i : w.i;
    w.j = on ? j : w.j;
    w.row = move ? row : w.row;
    w.lc = move ? lc : w.lc;
    w.inb = move ? inb : w.inb;
  }
}

// After the walk's last step: the pure-gap run along the edge it reached
// (i > 0: `edge` I steps; j > 0: D steps), then zeros to L/4 bytes, the
// path length and the err byte. Lane `lane` of `nl` writes every nl-th byte.
__device__ __forceinline__ void finish(uint8_t* o, int L, const Walk& w, int lane, int nl) {
  int i = w.i, j = w.j, err = w.err;
  const int s = w.s;
  const int edge = imin(i + j, L - s);
  const unsigned code = i > 0 ? 2u : 3u;
  const int k0 = s >> 2;
  for (int k = k0 + lane; k < L / 4; k += nl) {
    unsigned v = k == k0 ? w.acc : 0u;
    for (int p = imax(4 * k, s); p < imin(4 * k + 4, s + edge); ++p) v |= code << (2 * (p & 3));
    o[k] = static_cast<uint8_t>(v);
  }
  if (lane == 0) {
    if (i > 0) i -= edge; else j -= edge;
    const int path_len = s + edge;
    err |= (i > 0) || (j > 0);
    o[L / 4 + 0] = static_cast<uint8_t>(path_len & 0xff);
    o[L / 4 + 1] = static_cast<uint8_t>((path_len >> 8) & 0xff);
    o[L / 4 + 2] = static_cast<uint8_t>((path_len >> 16) & 0xff);
    o[L / 4 + 3] = static_cast<uint8_t>((path_len >> 24) & 0xff);
    o[L / 4 + 4] = static_cast<uint8_t>(err);
  }
}

// The walk from (m, n): row, lane and band flag of its first cell.
template <bool WAVE>
__device__ __forceinline__ Walk start(int m, int n, const int* offs, int w_dim) {
  Walk w{m, n, 0, 0, 0, 0, 0, 0, true, 0u};
  if (m > 0 && n > 0) {
    if (WAVE) {
      w.row = m + n - 1;
      const int raw = m - offs[w.row];
      w.lc = clamp_lane(raw, w_dim);
      w.inb = raw == w.lc;
    } else {
      w.row = m - 1;
      w.lc = n;
    }
  }
  return w;
}

// One warp per item, walking staged windows (see the note at the top).
template <bool WAVE>
__global__ void __launch_bounds__(32) traceback_windows(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const Item it = item(a, b);
  const Layout ly = make_layout(WAVE ? kRowsW : kRowsF, WAVE ? 2 * kHalfW + 1 : kColsF,
                                WAVE ? kRowsW : kRowsF, WAVE ? kRowsW : kColsF,
                                WAVE ? kRowsW + 2 : 0, a.w_dim);
  uint8_t* cbuf = smem;
  uint8_t* pbuf = smem + ly.total;
  uint8_t* o = a.out + static_cast<size_t>(b) * (a.L / 4 + 5);
  const int L = a.L;

  Walk w = start<WAVE>(a.m[b], a.n[b], it.offs, a.w_dim);
  Win cw, pw;
  bool pending = false;
  int since = 0;
  if (alive(w, L)) {
    stage_window<WAVE>(it, a, cbuf, ly, cw, w.i, w.j, w.row, w.lc, lane);
    cp_wait();
  }
  while (alive(w, L)) {
    const int s0 = w.s;
    walk4<WAVE>(w, view(cbuf, ly, cw.tk, cw.qk, cw.rk, cw.ok), a.w_dim, L);
    if (w.s - s0 < 4) break;   // the walk ended inside the group: finish takes acc
    if (lane == 0) o[s0 >> 2] = static_cast<uint8_t>(w.acc);
    w.acc = 0;
    if (!alive(w, L)) break;
    // The walk's cell is in the current window: windows are staged at the
    // walk's cell; the next one once, at a group's end, the cell is within
    // half a window of its lower row or lane edge (full: 32 rows or 64
    // columns; wave: 64 diagonals or 24 lanes, a step moving one or two
    // diagonals and at most one lane); and the walk moves to it after
    // kSwitch to kSwitch + 3 steps, still inside both.
    if (pending) {
      since += 4;
      if (since >= kSwitch) {
        cp_wait();
        cw = pw;
        uint8_t* t = cbuf;
        cbuf = pbuf;
        pbuf = t;
        pending = false;
      }
    } else if ((cw.r_lo > 0 && w.row - cw.r_lo < (WAVE ? kRowsW : kRowsF) / 2) ||
               (cw.l_lo > 0 && w.lc - cw.l_lo < (WAVE ? kHalfW : kColsF) / 2) ||
               (WAVE && cw.l_hi < a.w_dim - 1 && cw.l_hi - w.lc < kHalfW / 2)) {
      stage_window<WAVE>(it, a, pbuf, ly, pw, w.i, w.j, w.row, w.lc, lane);
      pending = true;
      since = 0;
    }
  }
  if (pending) cp_wait();
  finish(o, L, w, lane, 32);
}

// Whole tapes of G items staged by the warp; lane g walks item g.
template <bool WAVE>
__global__ void __launch_bounds__(32) traceback_whole(Args a, Layout ly, int G) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x, b0 = blockIdx.x * G;
  const int need = WAVE ? a.max_m + a.max_n : a.max_m;
  for (int g = 0; g < G && b0 + g < a.B; ++g) {
    const Item it = item(a, b0 + g);
    uint8_t* buf = smem + static_cast<size_t>(g) * ly.total;
    stage_rows(buf, it.tb, a.w_dim, ly.S, 0, need, 0, a.w_dim, lane, 32);
    stage_span(buf + ly.q, it.q, a.max_m, lane, 32);
    stage_span(buf + ly.r, it.r, a.max_n, lane, 32);
    if (WAVE) stage_span(buf + ly.o, it.offs, 4 * need, lane, 32);
  }
  cp_commit();
  cp_wait();
  const int b = b0 + lane;
  if (lane >= G || b >= a.B) return;
  const Item it = item(a, b);
  const View v = view(smem + static_cast<size_t>(lane) * ly.total, ly,
                      static_cast<int>(reinterpret_cast<uintptr_t>(it.tb) & 15),
                      static_cast<int>(reinterpret_cast<uintptr_t>(it.q) & 15),
                      static_cast<int>(reinterpret_cast<uintptr_t>(it.r) & 15),
                      static_cast<int>(reinterpret_cast<uintptr_t>(it.offs) & 15) / 4);
  uint8_t* o = a.out + static_cast<size_t>(b) * (a.L / 4 + 5);
  const int L = a.L;
  Walk w = start<WAVE>(a.m[b], a.n[b], it.offs, a.w_dim);
  while (alive(w, L)) {
    const int s0 = w.s;
    walk4<WAVE>(w, v, a.w_dim, L);
    if (w.s - s0 < 4) break;
    o[s0 >> 2] = static_cast<uint8_t>(w.acc);
    w.acc = 0;
  }
  finish(o, L, w, 0, 1);
}

// SMs of the current device.
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Whole tapes are staged when an item's staged bytes fit the block and the
// launch's blocks fit one wave of the card's resident blocks (a second wave
// would wait for the first: 512 items of 256 x 257 walk faster in windows,
// 8 of 32 x 2049 whole; PERF.md); else the walk goes through windows.
template <bool WAVE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int need = WAVE ? a.max_m + a.max_n : a.max_m;
  const Layout whole = make_layout(need, a.w_dim, a.max_m, a.max_n, WAVE ? need : 0, a.w_dim);
  if (whole.total <= g_whole_max && whole.total <= kWholeSmem) {
    int G = 32;
    while (G > 1 && (G * whole.total > kWholeSmem || (a.B + G - 1) / G < kMinWarps)) G >>= 1;
    const size_t smem = static_cast<size_t>(G) * whole.total;
    cudaError_t err = pav::set_smem(traceback_whole<WAVE>, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, traceback_whole<WAVE>, 32, smem);
    if (err != cudaSuccess) return err;
    const int blocks = (a.B + G - 1) / G;
    if (blocks <= per_sm * sm_count()) {
      traceback_whole<WAVE><<<blocks, 32, smem, stream>>>(a, whole, G);
      return cudaGetLastError();
    }
  }
  const size_t smem = 2 * static_cast<size_t>(window_layout(WAVE, a.w_dim).total);
  traceback_windows<WAVE><<<a.B, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Set the largest staged item (bytes) that traceback_whole takes; a negative
// value only reads it. Returns the previous value. For timing the two
// designs against each other; the default is kWholeSmem.
extern "C" int pav_traceback_whole_max(int bytes) {
  const int old = g_whole_max;
  if (bytes >= 0) g_whole_max = bytes;
  return old;
}

extern "C" int pav_traceback(const void* tb, const void* offs, const void* q,
                             const void* r, const void* m, const void* n,
                             void* out, int B, int rows, int w_dim, int max_m,
                             int max_n, int L, int wave, void* stream) {
  if (B == 0) return 0;
  if (L % 4 != 0 || (!wave && w_dim < max_n + 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(tb), static_cast<const int*>(offs),
               static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
               static_cast<const int*>(m), static_cast<const int*>(n),
               static_cast<uint8_t*>(out), B, rows, w_dim, max_m, max_n, L};
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wave ? launch<true>(a, st) : launch<false>(a, st));
}

// Message for a CUDA error code returned by any entry of this library.
extern "C" const char* pav_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
