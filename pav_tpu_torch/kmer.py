"""Vectorized k-mer machinery (replaces the vendored kanapy dependency).

K-mers are 2-bit packed unsigned integers (uint64, supports k <= 31), produced in
bulk with numpy sliding windows rather than one-at-a-time streaming
(reference API surface: kanapy.util.kmer.KmerUtil / stream — SURVEY.md §2.9).
Ambiguous bases invalidate every window covering them, mirroring kanapy's
skip-over-ambiguous streaming semantics.
"""

import numpy as np

from . import seqcodec


class KmerUtil:
    """K-mer codec for a fixed k (<=31). Mirrors kanapy.util.kmer.KmerUtil's API:
    k_size, rev_complement, canonical_complement, to_string."""

    def __init__(self, k_size):
        if not (1 <= k_size <= 31):
            raise ValueError(f'k_size must be in [1, 31]: {k_size}')
        self.k_size = int(k_size)
        self.mask = (np.uint64(1) << np.uint64(2 * self.k_size)) - np.uint64(1)

    def rev_complement(self, kmer):
        """Reverse complement of an encoded k-mer (scalar or array)."""
        kmer = np.asarray(kmer, dtype=np.uint64)
        # Complement: with A=00,C=01,G=10,T=11, complement is bitwise NOT per 2-bit field.
        x = (~kmer) & self.mask
        # Reverse 2-bit fields within 2k bits.
        x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
        x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | ((x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F))
        x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | ((x >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF))
        x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | ((x >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF))
        x = (x << np.uint64(32)) | (x >> np.uint64(32))
        x = (x >> np.uint64(64 - 2 * self.k_size)) & self.mask
        if np.isscalar(kmer) or kmer.ndim == 0:
            return np.uint64(x)
        return x

    def canonical_complement(self, kmer):
        """Lexicographically smaller of (kmer, revcomp(kmer))."""
        rc = self.rev_complement(kmer)
        return np.minimum(np.asarray(kmer, dtype=np.uint64), rc)

    def to_string(self, kmer):
        kmer = int(kmer)
        out = []
        for i in range(self.k_size - 1, -1, -1):
            out.append('ACGT'[(kmer >> (2 * i)) & 3])
        return ''.join(out)

    def from_string(self, s):
        codes = seqcodec.encode(s)
        if len(codes) != self.k_size or np.any(codes > 3):
            raise ValueError(f'Bad k-mer string for k={self.k_size}: {s}')
        val = np.uint64(0)
        for c in codes:
            val = (val << np.uint64(2)) | np.uint64(c)
        return val


def kmer_codes(codes, k):
    """All k-mer values of a code array by sliding window.

    :param codes: uint8 code array (seqcodec encoding).
    :param k: k-mer size.

    :return: (kmers, valid): uint64 array of length len(codes)-k+1 and a boolean
        mask marking windows free of ambiguous bases. Invalid windows hold
        unspecified values.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)

    # Hot path: single-pass native rolling extraction (native/kmercodes.cpp);
    # the inversion density scans call this hundreds of times per haplotype.
    from . import native
    out = native.kmer_codes(codes, k)
    if out is not None:
        return out

    vals = np.where(codes > 3, 0, codes).astype(np.uint64)
    kmers = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        kmers = (kmers << np.uint64(2)) | vals[i:i + n]

    # Valid windows: no ambiguous base inside. Prefix-sum of ambiguity flags.
    ambig = (codes > 3).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(ambig)])
    valid = (cs[k:] - cs[:-k]) == 0
    return kmers, valid


def stream(codes, k_util, index=False):
    """Iterate (kmer, index) over valid windows (kanapy.util.kmer.stream-compatible)."""
    kmers, valid = kmer_codes(codes, k_util.k_size)
    idx = np.nonzero(valid)[0]
    if index:
        return list(zip(kmers[idx].tolist(), idx.tolist()))
    return kmers[idx].tolist()


def kmer_set(codes, k):
    """Unique valid k-mers of a sequence as a sorted uint64 array (set replacement
    for device/vectorized membership via searchsorted)."""
    kmers, valid = kmer_codes(codes, k)
    return np.unique(kmers[valid])


def in_sorted(sorted_arr, values):
    """Vectorized membership test of values against a sorted uint64 array."""
    if len(sorted_arr) == 0:
        return np.zeros(len(values), dtype=bool)
    pos = np.searchsorted(sorted_arr, values)
    pos = np.minimum(pos, len(sorted_arr) - 1)
    return sorted_arr[pos] == values
