"""Native (C++) runtime components, loaded via ctypes.

The shared library is built on first use with the system toolchain from the
repo's native/*.cpp and cached under build/torch_native/, apart from the JAX
package's build, through the port's one build routine (``_build.build``: a
temporary file renamed into place, so that two processes building at once
never load a half-written library). Where the toolchain is missing or the
build directory cannot be written, chaining falls back to the CUDA chain
scan on the aligner's device (ops/chain_scan.py).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_REPO_ROOT, 'native', 'chain.cpp'),
         os.path.join(_REPO_ROOT, 'native', 'minimizer.cpp'),
         os.path.join(_REPO_ROOT, 'native', 'lookup.cpp'),
         os.path.join(_REPO_ROOT, 'native', 'sortanchors.cpp'),
         os.path.join(_REPO_ROOT, 'native', 'kmercodes.cpp')]
_BUILD_DIR = os.path.join(_REPO_ROOT, 'build', 'torch_native')


def _host_tag():
    # Key the cached .so by host CPU so a -march=native build from one machine
    # is never loaded on another (shared checkouts / reused container images
    # would otherwise risk SIGILL).
    import hashlib
    import platform
    cpu = platform.machine()
    try:
        with open('/proc/cpuinfo') as fh:
            for line in fh:
                if line.startswith('flags'):
                    cpu += hashlib.md5(line.encode()).hexdigest()[:12]
                    break
    except OSError:
        pass
    return cpu


_SO_PATH = os.path.join(_BUILD_DIR, f'libpavnative-{_host_tag()}.so')


def _build():
    from ._build import build
    build(_SO_PATH, lambda out: subprocess.run(
        ['g++', '-O3', '-march=native', '-shared', '-fPIC', *_SRCS, '-o', out],
        check=True, capture_output=True))


def get_lib():
    """Load (building if needed) the native library, or None when unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            if (not os.path.exists(_SO_PATH)
                    or any(os.path.getmtime(_SO_PATH) < os.path.getmtime(s)
                           for s in _SRCS)):
                _build()
            lib = ctypes.CDLL(_SO_PATH)
            lib.chain_dp.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.chain_dp.restype = None
            lib.minimizer_sketch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.minimizer_sketch.restype = ctypes.c_int64
            lib.chain_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_float, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.chain_extract.restype = ctypes.c_int64
            lib.chain_select_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.chain_select_extract.restype = ctypes.c_int64
            _u64p = ctypes.POINTER(ctypes.c_uint64)
            _i64p = ctypes.POINTER(ctypes.c_int64)
            lib.index_build.argtypes = [
                _u64p, ctypes.c_int64, _u64p, _i64p, ctypes.c_int32]
            lib.index_build.restype = None
            lib.index_count.argtypes = [
                _u64p, _i64p, ctypes.c_int32, _i64p, _i64p, _u64p,
                ctypes.c_int64, ctypes.c_int64, _i64p, _i64p]
            lib.index_count.restype = None
            lib.index_fill.argtypes = [
                _i64p, ctypes.c_int64, _i64p, _i64p, _i64p, _i64p]
            lib.index_fill.restype = None
            _i8p = ctypes.POINTER(ctypes.c_int8)
            _i32p = ctypes.POINTER(ctypes.c_int32)
            lib.index_fill_anchors.argtypes = [
                _i64p, _i64p, _i8p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _i64p, _i64p,
                _i32p, _i64p, _i8p,
                _i32p, _i32p, _i32p,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.index_fill_anchors.restype = None
            lib.sort_anchors32.argtypes = [
                _i32p, _i32p, _i32p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, _i32p, _i32p, _i32p, _i32p,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.sort_anchors32.restype = ctypes.c_int64
            lib.sort_anchors.argtypes = [
                _i64p, _i64p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                _i64p, _i64p, _i64p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8)]
            lib.sort_anchors.restype = ctypes.c_int64
            lib.kmer_codes.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int32, _u64p, ctypes.POINTER(ctypes.c_uint8)]
            lib.kmer_codes.restype = None
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def chain_dp(qpos, rpos, group, k, lookback, max_dist, max_gap_diff, gap_scale):
    """Native chain DP; returns (scores float32, parents int64) or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(qpos)
    qpos = np.ascontiguousarray(qpos, dtype=np.int32)
    rpos = np.ascontiguousarray(rpos, dtype=np.int32)
    group = np.ascontiguousarray(group, dtype=np.int32)
    f = np.zeros(n, dtype=np.float32)
    parent = np.full(n, -1, dtype=np.int64)
    lib.chain_dp(
        qpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        group.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n), ctypes.c_int32(int(k)), ctypes.c_int32(int(lookback)),
        ctypes.c_float(float(max_dist)), ctypes.c_float(float(max_gap_diff)),
        ctypes.c_float(float(gap_scale)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return f, parent


def minimizer_sketch(codes, k, w):
    """Native minimizer sketch; returns (pos, hash, strand) or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    out_pos = np.empty(max(n, 1), dtype=np.int64)
    out_hash = np.empty(max(n, 1), dtype=np.uint64)
    out_strand = np.empty(max(n, 1), dtype=np.uint8)
    count = lib.minimizer_sketch(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int32(int(k)), ctypes.c_int32(int(w)),
        out_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return (out_pos[:count].copy(), out_hash[:count].copy(),
            out_strand[:count].astype(np.int8))


def sort_anchors(qpos, rpos, chrom, rev):
    """Native radix sort of anchors by (group, rpos, qpos); emits permuted
    (qpos, rpos, group, chrom, rev) arrays directly. Returns None when the
    native library is unavailable or a field exceeds the key range.

    int32 position arrays take the 32-bit fast path (half the key-build
    traffic); anything else goes through the int64 dynamic-width variant."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(qpos)
    if (isinstance(qpos, np.ndarray) and qpos.dtype == np.int32
            and isinstance(rpos, np.ndarray) and rpos.dtype == np.int32):
        chrom32 = np.ascontiguousarray(chrom, dtype=np.int32)
        rev8 = np.ascontiguousarray(rev, dtype=np.uint8)
        out_q = np.empty(n, dtype=np.int32)
        out_r = np.empty(n, dtype=np.int32)
        out_g = np.empty(n, dtype=np.int32)
        out_c = np.empty(n, dtype=np.int32)
        out_v = np.empty(n, dtype=np.uint8)
        _i32p = ctypes.POINTER(ctypes.c_int32)
        rc = lib.sort_anchors32(
            np.ascontiguousarray(qpos).ctypes.data_as(_i32p),
            np.ascontiguousarray(rpos).ctypes.data_as(_i32p),
            chrom32.ctypes.data_as(_i32p),
            rev8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            out_q.ctypes.data_as(_i32p), out_r.ctypes.data_as(_i32p),
            out_g.ctypes.data_as(_i32p), out_c.ctypes.data_as(_i32p),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 0:
            return out_q, out_r, out_g, out_c, out_v.astype(bool)
        # fall through to the 64-bit dynamic-width variant
    qpos = np.ascontiguousarray(qpos, dtype=np.int64)
    rpos = np.ascontiguousarray(rpos, dtype=np.int64)
    chrom = np.ascontiguousarray(chrom, dtype=np.int32)
    rev = np.ascontiguousarray(rev, dtype=np.uint8)
    out_q = np.empty(n, dtype=np.int64)
    out_r = np.empty(n, dtype=np.int64)
    out_g = np.empty(n, dtype=np.int64)
    out_c = np.empty(n, dtype=np.int32)
    out_v = np.empty(n, dtype=np.uint8)
    rc = lib.sort_anchors(
        qpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        chrom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rev.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        out_q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_g.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out_q, out_r, out_g, out_c, out_v.astype(bool)


class HashIndex:
    """Open-addressing probe table over sorted unique minimizer hashes."""

    def __init__(self, uniq_hashes, uniq_starts, uniq_counts):
        lib = get_lib()
        if lib is None:
            raise RuntimeError('native library unavailable')
        self._lib = lib
        n = len(uniq_hashes)
        log2 = 3
        while (1 << log2) < 2 * max(n, 1):
            log2 += 1
        self.log2 = log2
        self.keys = np.full(1 << log2, np.uint64(0xFFFFFFFFFFFFFFFF),
                            dtype=np.uint64)
        self.vals = np.full(1 << log2, -1, dtype=np.int64)
        self.uniq_starts = np.ascontiguousarray(uniq_starts, dtype=np.int64)
        self.uniq_counts = np.ascontiguousarray(uniq_counts, dtype=np.int64)
        uniq_hashes = np.ascontiguousarray(uniq_hashes, dtype=np.uint64)
        lib.index_build(
            uniq_hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(n),
            self.keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(log2))

    def lookup(self, query_hashes, max_occ):
        """:return: (q_idx, flat) int64 arrays; flat indexes the hash-sorted
        index arrays, q_idx the query."""
        qh = np.ascontiguousarray(query_hashes, dtype=np.uint64)
        nq = len(qh)
        counts = np.empty(nq, dtype=np.int64)
        keys_p = self.keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        vals_p = self.vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        qh_p = qh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        starts = np.empty(nq, dtype=np.int64)
        self._lib.index_count(
            keys_p, vals_p, ctypes.c_int32(self.log2),
            self.uniq_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.uniq_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qh_p, ctypes.c_int64(nq), ctypes.c_int64(int(max_occ)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        offsets = np.zeros(nq, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:]) if nq > 1 else None
        total = int(counts.sum())
        q_idx = np.empty(total, dtype=np.int64)
        flat = np.empty(total, dtype=np.int64)
        if total:
            self._lib.index_fill(
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(nq),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                q_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return q_idx, flat

    def anchors(self, query_hashes, qpos, qstrand, qlen, k, max_occ,
                idx_chrom, idx_pos, idx_strand):
        """Fused anchor assembly: returns (qpos', rpos, chrom, rev) per hit,
        with qpos' already strand-transformed (q' = qlen - q - k on rev)."""
        qh = np.ascontiguousarray(query_hashes, dtype=np.uint64)
        qpos = np.ascontiguousarray(qpos, dtype=np.int64)
        qstrand = np.ascontiguousarray(qstrand, dtype=np.int8)
        nq = len(qh)
        counts = np.empty(nq, dtype=np.int64)
        keys_p = self.keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        vals_p = self.vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        qh_p = qh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        starts = np.empty(nq, dtype=np.int64)
        self._lib.index_count(
            keys_p, vals_p, ctypes.c_int32(self.log2),
            self.uniq_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.uniq_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qh_p, ctypes.c_int64(nq), ctypes.c_int64(int(max_occ)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        offsets = np.zeros(nq, dtype=np.int64)
        if nq > 1:
            np.cumsum(counts[:-1], out=offsets[1:])
        total = int(counts.sum())
        a_qpos = np.empty(total, dtype=np.int32)
        rpos = np.empty(total, dtype=np.int32)
        chrom = np.empty(total, dtype=np.int32)
        rev = np.empty(total, dtype=np.uint8)
        if total:
            self._lib.index_fill_anchors(
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                qpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                qstrand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                ctypes.c_int64(nq), ctypes.c_int64(int(qlen)),
                ctypes.c_int32(int(k)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                idx_chrom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                idx_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                idx_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                a_qpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                rpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                chrom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                rev.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return a_qpos, rpos, chrom, rev.astype(bool)


def chain_select_extract(scores, parents, min_chain_score, min_anchors):
    """Native candidate selection (score >= min, desc-stable order) plus
    greedy extraction in one call; same return shape as chain_extract, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(scores)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    parents = np.ascontiguousarray(parents, dtype=np.int64)
    out_idx = np.empty(max(n, 1), dtype=np.int64)
    n_max = n // max(int(min_anchors), 1) + 2
    out_start = np.empty(n_max, dtype=np.int64)
    out_score = np.empty(n_max, dtype=np.float32)
    n_chains = lib.chain_select_extract(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.c_float(float(min_chain_score)), ctypes.c_int64(int(min_anchors)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return (out_idx[:out_start[n_chains]].copy(),
            out_start[:n_chains + 1].copy(), out_score[:n_chains].copy())


def chain_extract(scores, parents, cand, min_chain_score, min_anchors):
    """Native greedy chain extraction from parent links.

    :return: (idx, starts, own_scores) where idx holds all chains' anchor
        indices back to back (ascending within each chain) and starts has
        n_chains+1 offsets into it; or None when the native library is
        unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(scores)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    parents = np.ascontiguousarray(parents, dtype=np.int64)
    cand = np.ascontiguousarray(cand, dtype=np.int64)
    out_idx = np.empty(max(n, 1), dtype=np.int64)
    n_max = n // max(int(min_anchors), 1) + 2
    out_start = np.empty(n_max, dtype=np.int64)
    out_score = np.empty(n_max, dtype=np.float32)
    n_chains = lib.chain_extract(
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        cand.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(cand)),
        ctypes.c_float(float(min_chain_score)), ctypes.c_int64(int(min_anchors)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return (out_idx[:out_start[n_chains]].copy(),
            out_start[:n_chains + 1].copy(), out_score[:n_chains].copy())


def kmer_codes(codes, k):
    """Native rolling k-mer extraction; returns (kmers uint64, valid bool) for
    all len(codes)-k+1 windows, or None when the native library is
    unavailable. Semantics match pav_tpu.kmer.kmer_codes' numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n_kmers = len(codes) - k + 1
    if n_kmers <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    out_kmers = np.empty(n_kmers, dtype=np.uint64)
    out_valid = np.empty(n_kmers, dtype=np.uint8)
    lib.kmer_codes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(codes)), ctypes.c_int32(int(k)),
        out_kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out_kmers, out_valid.view(bool)
