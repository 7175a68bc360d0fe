"""The port's native (C++) library matches its Python/numpy fallbacks exactly.

The cases of test_native.py, run against ``pav_tpu_torch.native`` (built
into ``build/torch_native/`` through a temporary file renamed into place)
and the port's own fallbacks: the numpy minimizer sketch, the numpy hash
lookup and anchor assembly, and the chain scan's plain version on the CPU.
They skip only where there is no C++ compiler; a library that fails to
build fails them.
"""

import shutil

import numpy as np
import pytest
import torch

from pav_tpu_torch import native, seqcodec
from pav_tpu_torch.align.aligner.chain import collect_anchors
from pav_tpu_torch.align.aligner.index import MinimizerIndex, minimizers
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import chain_scan

from helpers import random_seq


@pytest.fixture(autouse=True)
def library():
    if shutil.which('g++') is None:
        pytest.skip('no g++ to build native/*.cpp')
    assert native.get_lib() is not None, 'the native library did not build or load'


def _random_parent_forest(n, seed):
    """A parent forest shaped like chain-DP output: mostly short back links."""
    rng = np.random.default_rng(seed)
    parents = np.full(n, -1, dtype=np.int64)
    scores = np.full(n, 19.0, dtype=np.float32)
    for i in range(1, n):
        if rng.random() < 0.9:
            parents[i] = i - rng.integers(1, min(i, 40) + 1)
            scores[i] = scores[parents[i]] + rng.integers(1, 20)
    return scores, parents


def _candidates(scores):
    cand = np.nonzero(scores >= 100)[0]
    return cand[np.argsort(-scores[cand], kind='stable')]


def _py_extract(scores, parents, cand, min_chain_score, min_anchors):
    used = np.zeros(len(scores), dtype=bool)
    out = []
    for i in cand:
        i = int(i)
        if used[i]:
            continue
        path = []
        j = i
        while j >= 0 and not used[j]:
            path.append(j)
            used[j] = True
            j = int(parents[j])
        if len(path) < min_anchors:
            continue
        own = float(scores[i]) - (float(scores[j]) if j >= 0 else 0.0)
        if own < min_chain_score:
            continue
        path.reverse()
        out.append((path, own))
    return out


@pytest.mark.parametrize('seed', [3, 11])
def test_chain_extract_parity(seed):
    scores, parents = _random_parent_forest(50000, seed)
    cand = _candidates(scores)
    res = native.chain_extract(scores, parents, cand, 100.0, 3)
    assert res is not None
    idx_all, starts, own = res
    expected = _py_extract(scores, parents, cand, 100.0, 3)
    assert len(expected) == len(own)
    for t, (path, s) in enumerate(expected):
        assert np.array_equal(idx_all[starts[t]:starts[t + 1]], np.array(path))
        assert abs(s - own[t]) < 1e-3


def test_chain_extract_empty():
    scores = np.array([19.0, 19.0], dtype=np.float32)
    parents = np.array([-1, -1], dtype=np.int64)
    idx_all, starts, own = native.chain_extract(scores, parents, np.zeros(0, dtype=np.int64),
                                                100.0, 3)
    assert len(own) == 0 and len(idx_all) == 0 and starts[0] == 0


@pytest.mark.parametrize('seed', [3, 11])
def test_chain_select_extract_parity(seed):
    """Fused selection+sort+extraction matches the two-step path exactly."""
    scores, parents = _random_parent_forest(50000, seed)
    a = native.chain_select_extract(scores, parents, 100.0, 3)
    b = native.chain_extract(scores, parents, _candidates(scores), 100.0, 3)
    assert a is not None and b is not None
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_minimizer_sketch_matches_numpy(monkeypatch):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[5000:5007] = 4  # ambiguity run: windows touching it never win
    n_pos, n_hash, n_strand = native.minimizer_sketch(codes, 19, 10)
    monkeypatch.setattr(native, 'minimizer_sketch', lambda *a, **k: None)
    p_pos, p_hash, p_strand = minimizers(codes, 19, 10)
    assert len(n_pos) > 1000
    assert np.array_equal(n_pos, p_pos)
    assert np.array_equal(n_hash, p_hash)
    assert np.array_equal(n_strand, p_strand)


def _anchors(seed, n):
    rng = np.random.default_rng(seed)
    qpos = np.sort(rng.integers(0, 100000, n)).astype(np.int64)
    rpos = (qpos + rng.integers(-30, 30, n)).astype(np.int64)
    return qpos, rpos, np.zeros(n, dtype=np.int64)


def test_chain_dp_matches_scan(monkeypatch):
    """The native chain DP against the chain scan's plain version on the
    CPU (the fallback the aligner takes without the library)."""
    qpos, rpos, group = _anchors(5, 3000)
    f_n, p_n = native.chain_dp(qpos, rpos, group, 19, 64, 50000.0, 10000.0, 0.05)
    monkeypatch.setattr(native, 'chain_dp', lambda *a, **k: None)
    f_s, p_s = chain_scan.chain_scores(qpos, rpos, group, 19, lookback=64, max_dist=50000,
                                       max_gap_diff=10000, gap_scale=0.05,
                                       device=torch.device('cpu'))
    np.testing.assert_allclose(f_n, f_s, rtol=1e-5, atol=1e-3)
    # Parents may differ only where scores tie; require equal scores there.
    diff = p_s != p_n
    assert np.allclose(f_n[diff], f_s[diff], atol=1e-3)
    assert f_n.max() > 19.0


def test_chain_dp_unbounded_limits():
    """max_dist/max_gap_diff >= 2^31 (or inf) mean "no limit", not a wrap
    to INT32_MIN in the native int32 comparison."""
    qpos, rpos, group = _anchors(11, 500)
    f_ref, _ = native.chain_dp(qpos, rpos, group, 19, 64, 1e9, 1e9, 0.05)
    for big in (float(1 << 33), float('inf')):
        f_big, _ = native.chain_dp(qpos, rpos, group, 19, 64, big, big, 0.05)
        np.testing.assert_allclose(f_big, f_ref, rtol=1e-5, atol=1e-3)
    assert f_ref.max() > 19.0  # chaining actually linked anchors


def test_hash_index_lookup_parity():
    """The native probe-table lookup returns the hits of the numpy
    searchsorted path, order included."""
    rng = np.random.default_rng(17)
    ref = SeqStore({'c1': random_seq(200000, rng), 'c2': random_seq(100000, rng)})
    idx = MinimizerIndex(ref, k=19, w=10)
    assert idx._hash_index is not None
    q = np.concatenate([ref.get('c1')[50000:90000], random_seq(5000, rng)])
    _, h, _ = minimizers(q, 19, 10)
    a = idx.lookup(h, max_occ=16)
    idx._hash_index = None
    b = idx.lookup(h, max_occ=16)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert len(a[0]) > 1000


def test_fused_anchor_assembly_parity():
    """Native fused anchors (probe + strand transform + row assembly) match
    the numpy composition path."""
    rng = np.random.default_rng(23)
    ref = SeqStore({'c1': random_seq(150000, rng), 'c2': random_seq(80000, rng)})
    idx = MinimizerIndex(ref, k=19, w=10)
    assert idx._hash_index is not None
    # A mixed-orientation query: a forward slice, a reverse-complement
    # slice, noise.
    q = np.concatenate([ref.get('c1')[20000:50000],
                        seqcodec.revcomp(ref.get('c2')[10000:30000]),
                        random_seq(3000, rng)])
    a = collect_anchors(q, idx, max_occ=16)
    idx._hash_index = None
    b = collect_anchors(q, idx, max_occ=16)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert len(a[0]) > 2000
    assert a[3].any() and not a[3].all()


def _check_sorted(res, qpos, rpos, chrom, rev):
    assert res is not None
    sq, sr, sg, sc, sv = res
    group = chrom.astype(np.int64) * 2 + rev.astype(np.int64)
    order = np.lexsort((qpos, rpos, group))
    assert np.array_equal(sq, qpos[order])
    assert np.array_equal(sr, rpos[order])
    assert np.array_equal(sg, group[order])
    assert np.array_equal(sc, chrom[order])
    assert np.array_equal(sv, rev[order].astype(bool))


def test_sort_anchors_parity():
    rng = np.random.default_rng(29)
    n = 100000
    qpos = rng.integers(0, 1 << 27, n)
    rpos = rng.integers(0, 1 << 27, n)
    chrom = rng.integers(0, 5, n).astype(np.int32)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    _check_sorted(native.sort_anchors(qpos, rpos, chrom, rev), qpos, rpos, chrom, rev)
    # Chromosome-scale coordinates (past 2^28) sort natively: the key's bit
    # widths adapt to the maxima.
    big_q = rng.integers(0, 1 << 28, n)
    big_r = rng.integers(0, 3_000_000_000, n)      # a 3 Gbp scaffold
    _check_sorted(native.sort_anchors(big_q, big_r, chrom, rev), big_q, big_r, chrom, rev)
    # Combined widths beyond 64 bits fall back (None).
    huge = big_q.copy()
    huge[0] = 1 << 40
    assert native.sort_anchors(huge, big_r, chrom, rev) is None


def test_sort_anchors_parallel_path_parity():
    """The chunk-parallel radix path starts at 8M anchors; its stable order
    against numpy's lexsort."""
    rng = np.random.default_rng(9)
    n = (8 << 20) + 12345
    qpos = rng.integers(0, 1 << 26, n).astype(np.int32)
    rpos = rng.integers(0, 1 << 26, n).astype(np.int32)
    chrom = rng.integers(0, 6, n).astype(np.int32)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    _check_sorted(native.sort_anchors(qpos, rpos, chrom, rev), qpos, rpos, chrom, rev)
