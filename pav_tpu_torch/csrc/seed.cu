// Minimizer seeding on the card: the sketch of a sequence, the run
// boundaries of the hash-sorted reference table, and a contig's anchor rows
// probed against that table.
//
// Replaces no TPU kernel: pav_tpu builds the index and a contig's anchors on
// the host (pav_tpu/align/aligner/index.py, chain.py; native/minimizer.cpp,
// native/lookup.cpp), as the port's CPU path still does. On the card the
// reference's table stays resident and each contig's anchors are made and
// sorted there, so the host only downloads the sorted rows.
//
// Semantics are native/minimizer.cpp's, bit for bit: k-mer start p has the
// canonical hash h(p) = mix64(min(fwd, rc)) (strand 1 when rc < fwd), or
// ~0 when one of its k bases is ambiguous (code >= 4); p is a minimizer when
// h(p) != ~0 and h(p) is the minimum of some full window of w k-mer starts
// covering it (ties emit every tying start). A sequence with fewer than w
// k-mer starts has no minimizer. Hashes travel as order-preserving keys,
// h ^ 2^63 read as int64, so a signed sort orders them as unsigned hashes.
//
// Every pass that writes a variable number of outputs runs twice over the
// same tiles of kTile elements: a count per tile, an exclusive scan of the
// counts (pav_seed_scan), then the writes at the scanned offsets, each
// thread's outputs after those of the threads before it. Output order is
// input order, with no atomics.
//
// Bound: bytes. The sketch reads n bases and writes 13 bytes a minimizer
// (about 2n/(w+1) of them); the probe reads a query key and the run starts
// it lands on; the fill writes 12 bytes an anchor. The k-mers are hashed
// from shared memory (a block stages its tile of bases plus the window and
// k-mer halo once), so the arithmetic stays off device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                      // elements a thread
constexpr int kTile = kThreads * kPer;       // elements a block
constexpr int kMaxK = 31;                    // 2k bits in a 64-bit word
constexpr int kMaxW = 64;
constexpr uint64_t kInvalid = ~0ull;
constexpr uint64_t kSign = 1ull << 63;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

// Exclusive prefix sum of one value a thread over the block; the block's
// total in *total. Every thread of the block must call it.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kThreads / 32 ? warp_sum[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = s;
  }
  __syncthreads();
  const T before = warp ? warp_sum[warp - 1] : T(0);
  *total = warp_sum[kThreads / 32 - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return before + x - v;
}

// Minimizers of k-mer starts [lo, lo + kTile) of one sequence. Count pass
// (kEmit false): the tile's count into tile_count. Emit pass: (pos, key,
// strand) at tile_off[tile] onward, in position order.
template <bool kEmit>
__global__ void __launch_bounds__(kThreads)
sketch_kernel(const uint8_t* __restrict__ codes, int64_t n, int k, int w,
              int64_t* __restrict__ tile_count, const int64_t* __restrict__ tile_off,
              int32_t* __restrict__ out_pos, int64_t* __restrict__ out_key,
              int8_t* __restrict__ out_strand) {
  __shared__ uint8_t base_s[kTile + 2 * kMaxW + kMaxK];
  __shared__ uint64_t hash_s[kTile + 2 * kMaxW];
  __shared__ uint8_t strand_s[kTile + 2 * kMaxW];
  __shared__ uint64_t wmin_s[kTile + kMaxW];

  const int64_t n_kmers = n - k + 1;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t hi = min(lo + kTile, n_kmers);
  // Hashed k-mer starts a0 .. hi + w - 2 (entry i is start a0 + i); windows
  // a0 .. hi - 1 (entry i starts at a0 + i), the windows that cover [lo, hi).
  const int64_t a0 = lo - (w - 1);
  const int n_hash = static_cast<int>(hi - lo) + 2 * (w - 1);
  const int n_win = static_cast<int>(hi - lo) + w - 1;
  const int n_base = n_hash + k - 1;

  for (int i = threadIdx.x; i < n_base; i += kThreads) {
    const int64_t b = a0 + i;
    base_s[i] = (b >= 0 && b < n) ? codes[b] : 4;
  }
  __syncthreads();
  // Each thread rolls the k-mers of its own run of starts, as the host
  // sketcher rolls the whole sequence: one base a start after the first k.
  {
    const int chunk = (n_hash + kThreads - 1) / kThreads;
    const int i_lo = threadIdx.x * chunk;
    const int i_hi = min(i_lo + chunk, n_hash);
    const uint64_t mask = (1ull << (2 * k)) - 1;
    uint64_t fwd = 0, rc = 0;
    int run = 0;  // unambiguous bases ending at b
    for (int b = i_lo; b < i_hi + k - 1; ++b) {
      const uint8_t c = base_s[b];
      if (c < 4) {
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | (static_cast<uint64_t>(3 - c) << (2 * (k - 1)));
        ++run;
      } else {
        fwd = rc = 0;
        run = 0;
      }
      const int i = b - (k - 1);
      if (i >= i_lo) {
        hash_s[i] = run >= k ? mix64(fwd < rc ? fwd : rc) : kInvalid;
        strand_s[i] = rc < fwd ? 1 : 0;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_win; i += kThreads) {
    uint64_t m = hash_s[i];
    for (int t = 1; t < w; ++t) {
      const uint64_t h = hash_s[i + t];
      m = h < m ? h : m;
    }
    wmin_s[i] = m;
  }
  __syncthreads();

  // A start is a minimizer when it equals the minimum of a full window that
  // covers it (every covering window's minimum is at most its hash).
  const int64_t last_win = n_kmers - w;
  unsigned flags = 0;
  int count = 0;
  const int64_t p0 = lo + static_cast<int64_t>(threadIdx.x) * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t p = p0 + e;
    if (p >= hi) break;
    const uint64_t h = hash_s[p - a0];
    if (h == kInvalid) continue;
    const int64_t j_lo = p - (w - 1) > 0 ? p - (w - 1) : 0;
    const int64_t j_hi = p < last_win ? p : last_win;
    bool hit = false;
    for (int64_t j = j_lo; j <= j_hi; ++j) hit = hit || wmin_s[j - a0] == h;
    if (hit) {
      flags |= 1u << e;
      ++count;
    }
  }
  int total;
  const int before = block_exclusive_scan<int>(count, &total);
  if (!kEmit) {
    if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
    return;
  }
  int64_t o = tile_off[blockIdx.x] + before;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!(flags >> e & 1u)) continue;
    const int64_t p = p0 + e;
    out_pos[o] = static_cast<int32_t>(p);
    out_key[o] = static_cast<int64_t>(hash_s[p - a0] ^ kSign);
    out_strand[o] = static_cast<int8_t>(strand_s[p - a0]);
    ++o;
  }
}

// out[i] = sum of in[0 .. i) for i <= n (out[n] the total); one block.
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t n) {
  int64_t carry = 0;
  for (int64_t base = 0; base < n; base += kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kPer;
    int64_t v[kPer];
    int64_t s = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = i0 + e < n ? in[i0 + e] : 0;
      s += v[e];
    }
    int64_t total;
    int64_t run = carry + block_exclusive_scan<int64_t>(s, &total);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (i0 + e < n) out[i0 + e] = run;
      run += v[e];
    }
    carry += total;
  }
  if (threadIdx.x == 0) out[n] = carry;
}

// Run starts of a sorted key array: (key, first index) of each run.
template <bool kEmit>
__global__ void __launch_bounds__(kThreads)
runs_kernel(const int64_t* __restrict__ keys, int64_t n, int64_t* __restrict__ tile_count,
            const int64_t* __restrict__ tile_off, int64_t* __restrict__ uniq_keys,
            int64_t* __restrict__ uniq_starts) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile
                     + static_cast<int64_t>(threadIdx.x) * kPer;
  unsigned flags = 0;
  int count = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t i = i0 + e;
    if (i >= n) break;
    if (i == 0 || keys[i] != keys[i - 1]) {
      flags |= 1u << e;
      ++count;
    }
  }
  int total;
  const int before = block_exclusive_scan<int>(count, &total);
  if (!kEmit) {
    if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
    return;
  }
  int64_t o = tile_off[blockIdx.x] + before;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!(flags >> e & 1u)) continue;
    uniq_keys[o] = keys[i0 + e];
    uniq_starts[o] = i0 + e;
    ++o;
  }
}

// Each query key's hits in the table: its run's length, 0 where the key is
// absent or occurs more than max_occ times (native/lookup.cpp's filter),
// and the run's first row; the tile's total into tile_count.
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int64_t* __restrict__ qkey, int64_t nq,
             const int64_t* __restrict__ uniq_keys,
             const int64_t* __restrict__ uniq_starts, int64_t n_uniq, int64_t max_occ,
             int32_t* __restrict__ out_count, int64_t* __restrict__ out_start,
             int64_t* __restrict__ tile_count) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile
                     + static_cast<int64_t>(threadIdx.x) * kPer;
  int64_t sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t i = i0 + e;
    if (i >= nq) break;
    const int64_t q = qkey[i];
    int64_t a = 0, b = n_uniq;  // lower bound of q
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (uniq_keys[mid] < q) a = mid + 1;
      else b = mid;
    }
    int64_t c = 0, start = -1;
    if (a < n_uniq && uniq_keys[a] == q) {
      const int64_t len = uniq_starts[a + 1] - uniq_starts[a];
      if (len <= max_occ) {
        c = len;
        start = uniq_starts[a];
      }
    }
    out_count[i] = static_cast<int32_t>(c);
    out_start[i] = start;
    sum += c;
  }
  int64_t total;
  block_exclusive_scan<int64_t>(sum, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

// The anchor rows of each query's hits, in query order, then table order:
// the strand-transformed query position (qlen - q - k where the strands
// differ) and the sort key group << 31 | rpos, group = chrom * 2 + rev.
__global__ void __launch_bounds__(kThreads)
fill_kernel(const int32_t* __restrict__ qpos, const int8_t* __restrict__ qstrand,
            const int32_t* __restrict__ count, const int64_t* __restrict__ start,
            int64_t nq, const int64_t* __restrict__ tile_off, int64_t qlen, int k,
            const int32_t* __restrict__ idx_chrom, const int32_t* __restrict__ idx_pos,
            const int8_t* __restrict__ idx_strand, int32_t* __restrict__ out_q,
            int64_t* __restrict__ out_key) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile
                     + static_cast<int64_t>(threadIdx.x) * kPer;
  int c[kPer];
  int64_t sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    c[e] = i0 + e < nq ? count[i0 + e] : 0;
    sum += c[e];
  }
  int64_t total;
  int64_t o = tile_off[blockIdx.x] + block_exclusive_scan<int64_t>(sum, &total);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (c[e] == 0) continue;
    const int64_t i = i0 + e;
    const int64_t s = start[i];
    const int64_t q = qpos[i];
    const int8_t qs = qstrand[i];
    for (int j = 0; j < c[e]; ++j) {
      const int64_t flat = s + j;
      const int64_t rev = idx_strand[flat] != qs ? 1 : 0;
      const int64_t group = static_cast<int64_t>(idx_chrom[flat]) * 2 + rev;
      out_q[o] = static_cast<int32_t>(rev ? qlen - q - k : q);
      out_key[o] = (group << 31) | static_cast<int64_t>(idx_pos[flat]);
      ++o;
    }
  }
}

int tiles(int64_t n) { return static_cast<int>((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// Elements a tile: the sizes of tile_count (tiles) and tile_off (tiles + 1).
int pav_seed_tile() { return kTile; }

// The sketch of codes[0 .. n): emit 0 writes the tile counts, emit 1 the
// minimizers at the scanned offsets (pos int32, key int64, strand int8).
int pav_seed_sketch(const void* codes, int64_t n, int k, int w, void* tile_count,
                    const void* tile_off, void* out_pos, void* out_key, void* out_strand,
                    int emit, void* stream) {
  if (k < 1 || k > kMaxK || w < 1 || w > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_kmers = n - k + 1;
  if (n_kmers <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  if (emit)
    sketch_kernel<true><<<tiles(n_kmers), kThreads, 0, s>>>(
        c, n, k, w, nullptr, static_cast<const int64_t*>(tile_off),
        static_cast<int32_t*>(out_pos), static_cast<int64_t*>(out_key),
        static_cast<int8_t*>(out_strand));
  else
    sketch_kernel<false><<<tiles(n_kmers), kThreads, 0, s>>>(
        c, n, k, w, static_cast<int64_t*>(tile_count), nullptr, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Exclusive scan of n int64 counts into out[0 .. n], out[n] the total.
int pav_seed_scan(const void* in, void* out, int64_t n, void* stream) {
  scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Run starts of n sorted keys: emit 0 the tile counts, emit 1 each run's
// key and first index.
int pav_seed_runs(const void* keys, int64_t n, void* tile_count, const void* tile_off,
                  void* uniq_keys, void* uniq_starts, int emit, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const int64_t*>(keys);
  if (emit)
    runs_kernel<true><<<tiles(n), kThreads, 0, s>>>(
        kp, n, nullptr, static_cast<const int64_t*>(tile_off),
        static_cast<int64_t*>(uniq_keys), static_cast<int64_t*>(uniq_starts));
  else
    runs_kernel<false><<<tiles(n), kThreads, 0, s>>>(
        kp, n, static_cast<int64_t*>(tile_count), nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Hits of nq query keys in the table (uniq_starts has n_uniq + 1 entries,
// the last the table's length).
int pav_seed_probe(const void* qkey, int64_t nq, const void* uniq_keys,
                   const void* uniq_starts, int64_t n_uniq, int64_t max_occ,
                   void* out_count, void* out_start, void* tile_count, void* stream) {
  if (nq <= 0) return 0;
  probe_kernel<<<tiles(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(qkey), nq, static_cast<const int64_t*>(uniq_keys),
      static_cast<const int64_t*>(uniq_starts), n_uniq, max_occ,
      static_cast<int32_t*>(out_count), static_cast<int64_t*>(out_start),
      static_cast<int64_t*>(tile_count));
  return static_cast<int>(cudaGetLastError());
}

// Anchor rows of the probed queries at the scanned tile offsets.
int pav_seed_fill(const void* qpos, const void* qstrand, const void* count,
                  const void* start, int64_t nq, const void* tile_off, int64_t qlen, int k,
                  const void* idx_chrom, const void* idx_pos, const void* idx_strand,
                  void* out_q, void* out_key, void* stream) {
  if (nq <= 0) return 0;
  fill_kernel<<<tiles(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qpos), static_cast<const int8_t*>(qstrand),
      static_cast<const int32_t*>(count), static_cast<const int64_t*>(start), nq,
      static_cast<const int64_t*>(tile_off), qlen, k,
      static_cast<const int32_t*>(idx_chrom), static_cast<const int32_t*>(idx_pos),
      static_cast<const int8_t*>(idx_strand), static_cast<int32_t*>(out_q),
      static_cast<int64_t*>(out_key));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
