"""Minimizer extraction and reference index, fully vectorized.

Window-minimum minimizer selection over an invertible 64-bit hash of canonical
k-mers (the minimap2 seeding scheme re-implemented as whole-array numpy passes;
no per-base Python loops). The index is a hash-sorted flat table queried by
binary search — replicated or sharded per host in the multi-host path.

``build_index`` picks the aligner's index by its device: on CUDA the table
is built and kept on the card (``DeviceMinimizerIndex``, ``ops.seed``), on
the CPU it is ``MinimizerIndex`` on the host. Either seeds a contig with
``sorted_anchors``: its anchors against the table, sorted by (group, rpos,
qpos), on the index's own device (``collect_anchors`` is the host's).
"""

import contextlib
import os
import threading

import numpy as np
import torch

from ... import kmer as km
from ... import spans
from ...ops import seed
from ...parallel import pools

_SIGN_FLIP = np.uint64(0x8000000000000000)
_INVALID = np.uint64(0xFFFFFFFFFFFFFFFF)

# The shared sketching pool (the native sketcher, the anchor probe and the
# chain slabs release the GIL); the planning threads of both haplotypes feed
# it, and each map on it is one ``pool:sketch`` span row.
SKETCH_POOL = pools.Executor('sketch', min(4, os.cpu_count() or 1))


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

    parts = list(SKETCH_POOL.map(lambda b: sketch_one(*b),
                             zip(bounds[:-1], bounds[1:])))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def collect_anchors(qry_codes, index, max_occ=64):
    """Minimizer anchors of one contig against the reference index.

    :return: (qpos, rpos, chrom, rev) int arrays; qpos strand-transformed for
        reverse hits so chains ascend in both coordinates.
    """
    k, w = index.k, index.w
    with spans.span('chain.minimizers'):
        qpos, qhash, qstrand = minimizers_parallel(qry_codes, k, w)
    qlen = len(qry_codes)

    hi = getattr(index, '_hash_index', None)
    # The fused native path emits int32 anchor rows; scaffolds or contigs
    # past 2^31 take the int64 numpy path below.
    if (hi is not None
            and qlen < (1 << 31)
            and getattr(index, 'max_pos', 1 << 62) < (1 << 31)):
        # Fused native path: probe + strand transform + row assembly in one C
        # pass (skips four hit-sized numpy passes). Queries are independent ->
        # chunk-parallel over the sketch pool (the probe releases the GIL).
        def probe(sl):
            return hi.anchors(qhash[sl], qpos[sl], qstrand[sl], qlen, k,
                              max_occ, index.chrom_ids, index.positions,
                              index.strands)

        nq = len(qhash)
        if nq > 262144:
            step = (nq + 3) // 4
            slices = [slice(i, min(i + step, nq)) for i in range(0, nq, step)]
            parts = list(SKETCH_POOL.map(probe, slices))
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(4))
        return probe(slice(None))

    q_idx, t_chrom, t_pos, t_strand = index.lookup(qhash, max_occ=max_occ)

    if len(q_idx) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.int32), np.zeros(0, dtype=bool)

    a_qpos = qpos[q_idx]
    rev = (qstrand[q_idx] != t_strand)
    a_qpos = np.where(rev, qlen - a_qpos - k, a_qpos)
    return a_qpos, t_pos, t_chrom, rev


class MinimizerIndex:
    """Hash-sorted minimizer table over a reference SeqStore."""

    device = torch.device('cpu')    # the host holds the table

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

    def sorted_anchors(self, qry_codes, max_occ=64):
        """``collect_anchors``, then sorted by (group, rpos, qpos): (qpos,
        rpos, group, chrom, rev), group = chrom * 2 + rev."""
        with spans.span('chain.anchors', on='cpu') as sp:
            qpos, rpos, chrom, rev = collect_anchors(qry_codes, self, max_occ)
            sp.counts['anchors'] = len(qpos)
        if len(qpos) == 0:
            return qpos, rpos, qpos, chrom, rev     # no rows: no groups either

        from ... import native
        with spans.span('chain.sort'):
            res = native.sort_anchors(qpos, rpos, chrom, rev.astype(np.uint8))
            if res is not None:
                return res
            group = chrom.astype(np.int64) * 2 + rev.astype(np.int64)
            if (group.max() < (1 << 7) and rpos.max() < (1 << 28)
                    and qpos.max() < (1 << 28)):
                # Composite u64 key: one argsort instead of three lexsort passes.
                key = ((group.astype(np.uint64) << np.uint64(56))
                       | (rpos.astype(np.uint64) << np.uint64(28))
                       | qpos.astype(np.uint64))
                order = np.argsort(key, kind='stable')
            else:
                order = np.lexsort((qpos, rpos, group))
            return qpos[order], rpos[order], group[order], chrom[order], rev[order]


# Positions the device tables and anchor rows hold (int32).
INT32_LIMIT = 1 << 31


class DeviceMinimizerIndex:
    """``MinimizerIndex``'s tables, built and kept on a torch device.

    Each chromosome's codes are uploaded once and sketched (``seed.sketch``);
    the minimizers of all chromosomes, in chromosome then position order, are
    sorted stably by key and cut into runs (``seed.runs``), as
    ``MinimizerIndex`` does on the host, so the tables are equal. Only what
    the probe reads stays, on the device: ``uniq_keys`` and ``uniq_starts``
    (each run's first row, then the table's length) and ``chrom_ids``
    (int32), ``positions`` (int32) and ``strands`` (int8) in key order. The
    host keeps the names, k, w and ``max_pos``.
    """

    def __init__(self, ref_store, k=19, w=10, device='cuda'):
        self.k = k
        self.w = w
        self.device = torch.device(device)
        self.chrom_names = ref_store.names()
        self._ref_store = ref_store
        self._host = None
        self._host_lock = threading.Lock()

        parts = []
        for ci, name in enumerate(self.chrom_names):
            codes = torch.from_numpy(np.ascontiguousarray(ref_store.get(name), dtype=np.uint8))
            pos, key, strand = seed.sketch(codes.to(self.device), k, w)
            parts.append((key, torch.full_like(pos, ci), pos, strand))
        if not parts:
            pos, key, strand = seed.sketch(
                torch.zeros(0, dtype=torch.uint8, device=self.device), k, w)
            parts.append((key, pos, pos, strand))
        key, chrom, pos, strand = (torch.cat(p) for p in zip(*parts))
        key, order = torch.sort(key, stable=True)
        self.chrom_ids = chrom[order]
        self.positions = pos[order]
        self.strands = strand[order]
        self.uniq_keys, self.uniq_starts = seed.runs(key)
        self._n = key.numel()
        self.max_pos = int(self.positions.max()) if self._n else 0

    def n_minimizers(self):
        return self._n

    def table(self):
        """The probe's table (``seed.anchors``)."""
        return (self.uniq_keys, self.uniq_starts, self.chrom_ids, self.positions,
                self.strands)

    def host(self):
        """A ``MinimizerIndex`` of the same reference on the host, built on
        first use: the path of contigs whose positions pass int32."""
        with self._host_lock:
            if self._host is None:
                self._host = MinimizerIndex(self._ref_store, k=self.k, w=self.w)
            return self._host

    def sorted_anchors(self, qry_codes, max_occ=64):
        """``MinimizerIndex.sorted_anchors`` on the device: the contig
        uploaded and sketched, probed against the resident table, its rows
        sorted there (``ops.seed``) and downloaded once, on a CUDA stream of
        the calling thread's own. The same arrays, int32 (rev bool). A
        contig whose positions pass int32 is seeded on the host twin."""
        if len(qry_codes) >= INT32_LIMIT:
            return self.host().sorted_anchors(qry_codes, max_occ)
        dev = self.device
        stream = torch.cuda.Stream(dev) if dev.type == 'cuda' else None
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            with spans.span('chain.anchors', on=dev.type) as sp:
                with spans.span('chain.minimizers'):
                    codes = torch.from_numpy(np.ascontiguousarray(qry_codes, dtype=np.uint8))
                    qpos, qkey, qstrand = seed.sketch(codes.to(dev), self.k, self.w)
                q, key = seed.anchors(qpos, qkey, qstrand, len(qry_codes), self.k, max_occ,
                                      self.table())
                sp.counts['anchors'] = len(q)
            with spans.span('chain.sort'):
                qpos, rpos, group, chrom = seed.sort_rows(q, key).cpu().numpy()
        return qpos, rpos, group, chrom, (group & 1).astype(bool)


def build_index(ref_store, k, w, device):
    """The aligner's index on ``device``: a ``DeviceMinimizerIndex`` on a
    CUDA device where the kernels take k, w and every chromosome's
    positions, else a host ``MinimizerIndex``. Adds its size and where it
    lives to the open span (``minimizers``, ``on``)."""
    device = torch.device(device)
    if (device.type == 'cuda' and k <= seed.MAX_K and w <= seed.MAX_W
            and all(ref_store.length(c) < INT32_LIMIT for c in ref_store.names())):
        index = DeviceMinimizerIndex(ref_store, k=k, w=w, device=device)
    else:
        index = MinimizerIndex(ref_store, k=k, w=w)
    spans.add(minimizers=index.n_minimizers(), on=index.device.type)
    return index
