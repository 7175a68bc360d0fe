"""Minimizer extraction and reference index, fully vectorized.

Window-minimum minimizer selection over an invertible 64-bit hash of canonical
k-mers (the minimap2 seeding scheme re-implemented as whole-array numpy passes;
no per-base Python loops). The index is a hash-sorted flat table queried by
binary search — replicated or sharded per host in the multi-host path.
"""

import numpy as np

from ... import kmer as km

_SIGN_FLIP = np.uint64(0x8000000000000000)
_INVALID = np.uint64(0xFFFFFFFFFFFFFFFF)

import threading as _threading

_POOL = None
_POOL_LOCK = _threading.Lock()


def _pool():
    """Shared sketching pool (the native sketcher releases the GIL).
    Double-checked lock: concurrent contig-planning threads must never race
    two executors into existence (the loser would leak idle workers)."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                import os
                from concurrent.futures import ThreadPoolExecutor
                _POOL = ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1))
    return _POOL


def mix64(x):
    """Invertible 64-bit finalizer (splitmix-style) applied to canonical k-mers."""
    x = np.asarray(x, dtype=np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def _to_ordered_i64(u):
    """Order-preserving uint64 -> int64 mapping (for min/max reductions)."""
    return (u ^ _SIGN_FLIP).view(np.int64)


def minimizers(codes, k, w):
    """Select (pos, hash, strand) minimizers of a sequence.

    A k-mer position is a minimizer if its hash is the minimum of at least one
    w-window of consecutive k-mer starts covering it.

    :return: (pos int64, hash uint64, strand int8); strand=1 when the
        reverse-complement k-mer is canonical. Windows touching ambiguous bases
        never win.
    """
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64),
             np.zeros(0, dtype=np.int8))
    if len(codes) < k:
        return empty

    # Primary path: single-pass native sketcher (native/minimizer.cpp).
    from ... import native
    res = native.minimizer_sketch(codes, k, w)
    if res is not None:
        return res

    ku = km.KmerUtil(k)
    kmers, valid = km.kmer_codes(codes, k)
    n = len(kmers)
    if n == 0:
        return empty

    rc = ku.rev_complement(kmers)
    canon = np.minimum(kmers, rc)
    strand = (rc < kmers).astype(np.int8)

    h = mix64(canon)
    h[~valid] = _INVALID
    hi = _to_ordered_i64(h)

    if n < w:
        w = n

    from numpy.lib.stride_tricks import sliding_window_view
    # win_min[j] = min h over k-mer starts [j, j+w)
    win_min = sliding_window_view(hi, w).min(axis=1)          # length n-w+1
    # cover_max[i] = max win_min over windows covering i (= window starts [i-w+1, i]).
    lo = np.iinfo(np.int64).min
    pad = np.full(w - 1, lo, dtype=np.int64)
    padded = np.concatenate([pad, win_min, pad])
    cover_max = sliding_window_view(padded, w).max(axis=1)     # length n

    is_min = (hi == cover_max) & valid
    pos = np.nonzero(is_min)[0].astype(np.int64)
    if len(pos) == 0:
        return empty
    return pos, h[pos], strand[pos]


# Chunk size (in k-mer starts) for parallel sketching. Large enough that the
# per-chunk overlap (w-1 k-mers each side) is negligible.
_SKETCH_CHUNK = 2 << 20


def minimizers_parallel(codes, k, w, chunk=_SKETCH_CHUNK):
    """Exact `minimizers`, chunk-parallel over the shared sketch pool.

    A position p's minimizer status depends only on windows covering p
    (window starts [p-w+1, p], i.e. window ends [p, p+w-1]). Sketching the
    base range [lo-(w-1), hi+w-2+k) therefore reproduces, for every k-mer
    start in [lo, hi), exactly the window set the whole-sequence sketch sees;
    emissions are filtered to [lo, hi) so chunks partition the output. Chunks
    are independent -> thread-parallel (the native sketcher releases the GIL).
    """
    n_kmers = len(codes) - k + 1
    if n_kmers <= chunk + 2 * w:
        return minimizers(codes, k, w)

    bounds = list(range(0, n_kmers, chunk)) + [n_kmers]

    def sketch_one(lo, hi):
        s0 = max(0, lo - (w - 1))
        s1 = min(len(codes), hi + w - 1 + k - 1)
        pos, h, strand = minimizers(codes[s0:s1], k, w)
        pos = pos + s0
        keep = (pos >= lo) & (pos < hi)
        return pos[keep], h[keep], strand[keep]

    parts = list(_pool().map(lambda b: sketch_one(*b),
                             zip(bounds[:-1], bounds[1:])))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


class MinimizerIndex:
    """Hash-sorted minimizer table over a reference SeqStore."""

    def __init__(self, ref_store, k=19, w=10):
        self.k = k
        self.w = w
        self.chrom_names = ref_store.names()

        hash_list, chrom_list, pos_list, strand_list = [], [], [], []
        for ci, name in enumerate(self.chrom_names):
            pos, h, strand = minimizers_parallel(ref_store.get(name), k, w)
            hash_list.append(h)
            pos_list.append(pos)
            strand_list.append(strand)
            chrom_list.append(np.full(len(pos), ci, dtype=np.int32))

        h = np.concatenate(hash_list) if hash_list else np.zeros(0, dtype=np.uint64)
        order = np.argsort(h, kind='stable')
        self.hashes = h[order]
        self.chrom_ids = (np.concatenate(chrom_list)[order] if hash_list
                          else np.zeros(0, dtype=np.int32))
        self.positions = (np.concatenate(pos_list)[order] if hash_list
                          else np.zeros(0, dtype=np.int64))
        self.strands = (np.concatenate(strand_list)[order] if hash_list
                        else np.zeros(0, dtype=np.int8))

        self.uniq_hashes, self.uniq_starts, self.uniq_counts = np.unique(
            self.hashes, return_index=True, return_counts=True)
        self.max_pos = int(self.positions.max()) if len(self.positions) else 0

        # Primary lookup path: native open-addressing probe table (O(1) per
        # query vs a 25-deep random-access binary search at chromosome scale).
        from ... import native
        try:
            self._hash_index = native.HashIndex(
                self.uniq_hashes, self.uniq_starts, self.uniq_counts)
        except Exception:
            self._hash_index = None

    def n_minimizers(self):
        return len(self.hashes)

    def lookup(self, query_hashes, max_occ=64):
        """Anchor hits for an array of query minimizer hashes.

        :return: (q_idx, t_chrom, t_pos, t_strand) parallel arrays, one row per
            hit; q_idx indexes into query_hashes. Hashes with more than max_occ
            reference occurrences are dropped (repeat filter).
        """
        if len(self.uniq_hashes) == 0 or len(query_hashes) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.astype(np.int32), z, z.astype(np.int8)

        if self._hash_index is not None:
            q_idx, flat = self._hash_index.lookup(query_hashes, max_occ)
            return (q_idx, self.chrom_ids[flat], self.positions[flat],
                    self.strands[flat])

        # Fallback: binary-searching queries in sorted order keeps successive
        # search paths in cache (~2x over random order at chromosome scale).
        qorder = np.argsort(query_hashes, kind='stable')
        slot = np.empty(len(query_hashes), dtype=np.int64)
        slot[qorder] = np.searchsorted(self.uniq_hashes, query_hashes[qorder])
        slot_c = np.minimum(slot, len(self.uniq_hashes) - 1)
        found = self.uniq_hashes[slot_c] == query_hashes
        counts = np.where(found, self.uniq_counts[slot_c], 0)
        counts = np.where(counts > max_occ, 0, counts).astype(np.int64)

        starts = self.uniq_starts[slot_c]
        total = int(counts.sum())
        if total == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.astype(np.int32), z, z.astype(np.int8)

        q_idx = np.repeat(np.arange(len(query_hashes), dtype=np.int64), counts)
        cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.repeat(starts, counts) + (np.arange(total) - np.repeat(cum, counts))
        return q_idx, self.chrom_ids[flat], self.positions[flat], self.strands[flat]
