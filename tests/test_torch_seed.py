"""Minimizer seeding's device path on the CPU (``ops.seed``'s plain
versions) against the host path, and the aligner's choice between them.

On a CPU device the aligner keeps the host path (``MinimizerIndex``, equal
to ``pav_tpu``'s). A ``DeviceMinimizerIndex`` built on the CPU runs the
device path's logic (sketch, stable sort, runs, probe, rows, the two-pass
sort) on the plain versions, and must give the host path's tables and sorted
anchors on the cases of ``test_torch_gpu_seed.py``, which holds the kernels
to the same on the card.
"""

import numpy as np
import pytest
import torch

from pav_tpu.align.aligner.index import MinimizerIndex as RefMinimizerIndex
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu_torch import spans
from pav_tpu_torch.align.aligner import Aligner, chain, index as index_mod
from pav_tpu_torch.align.aligner.index import (DeviceMinimizerIndex, MinimizerIndex,
                                               build_index, minimizers)
from pav_tpu_torch.ops import seed

from test_torch_gpu_seed import (KW, MAX_OCC, assert_anchors_equal, assert_index_equal,
                                 assert_sketch_equal, reference_case)

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def case():
    return reference_case()


@pytest.mark.parametrize('k,w', KW + [(31, 64), (5, 3)])
def test_plain_sketch_matches_host(k, w):
    rng = np.random.default_rng(k * 100 + w)
    for n in (0, k - 1, k, k + w - 2, k + w - 1, k + w, 2048 + k, 5000):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if n > 100:
            codes[rng.integers(0, n, n // 50)] = 4
            codes[n // 3:n // 3 + 41] = 4
        assert_sketch_equal(codes, k, w, CPU)


@pytest.mark.parametrize('k,w', KW)
def test_device_index_on_cpu_matches_host(case, k, w):
    ref, _ = case
    assert_index_equal(DeviceMinimizerIndex(ref, k, w, device=CPU), MinimizerIndex(ref, k, w))


@pytest.mark.parametrize('max_occ', MAX_OCC)
@pytest.mark.parametrize('k,w', KW)
def test_device_anchors_on_cpu_match_host(case, k, w, max_occ):
    ref, contigs = case
    dev_index = DeviceMinimizerIndex(ref, k, w, device=CPU)
    host_index = MinimizerIndex(ref, k, w)
    counts = {name: assert_anchors_equal(codes, dev_index, host_index, max_occ)
              for name, codes in contigs.items()}
    assert counts['fwd'] > 1000 and counts['rev'] > 1000
    assert counts['tiny'] == 0


@pytest.mark.parametrize('k,w', KW)
def test_cpu_aligner_keeps_the_host_index(case, k, w):
    """On a CPU device the aligner builds MinimizerIndex on the host, and its
    tables equal pav_tpu's."""
    ref, _ = case
    aligner = Aligner(ref, {'aligner_k': k, 'aligner_w': w}, device='cpu')
    assert type(aligner.index) is MinimizerIndex
    want = RefMinimizerIndex(RefSeqStore(dict(ref.seqs)), k=k, w=w)
    for name in ('hashes', 'chrom_ids', 'positions', 'strands', 'uniq_hashes', 'uniq_starts',
                 'uniq_counts'):
        assert np.array_equal(getattr(aligner.index, name), getattr(want, name)), name


def test_index_span_says_where_and_how_many(case):
    ref, _ = case
    with spans.span('S:index') as sp:
        built = build_index(ref, 19, 10, 'cpu')
    assert isinstance(built, MinimizerIndex)
    assert sp.counts == {'minimizers': built.n_minimizers(), 'on': 'cpu'}
    assert built.n_minimizers() == len(built.hashes) > 0


def test_anchor_spans_say_where_and_how_many(case):
    ref, contigs = case
    rec = spans.Recorder()
    dev_index = DeviceMinimizerIndex(ref, 19, 10, device=CPU)
    with rec.active():
        n_host = len(MinimizerIndex(ref, 19, 10).sorted_anchors(contigs['fwd'], 64)[0])
        n_dev = len(dev_index.sorted_anchors(contigs['fwd'], 64)[0])
    rows = [s for s in rec.records if s.name == 'chain.anchors']
    assert [s.counts for s in rows] == [{'on': 'cpu', 'anchors': n_host},
                                        {'on': 'cpu', 'anchors': n_dev}]
    assert n_host == n_dev > 0
    assert 'anchors=' in rows[0].row()[-1] and 'on=cpu' in rows[0].row()[-1]


def test_contig_past_int32_takes_the_host_path(case, monkeypatch):
    """A contig whose positions pass int32 is seeded against the device
    index's host twin, with the same chains."""
    ref, contigs = case
    dev_index = DeviceMinimizerIndex(ref, 19, 10, device=CPU)
    host_index = MinimizerIndex(ref, 19, 10)
    want = chain.find_chains(contigs['fwd'], host_index, min_chain_score=200)
    monkeypatch.setattr(index_mod, 'INT32_LIMIT', len(contigs['fwd']))
    calls = []
    monkeypatch.setattr(seed, 'sketch', lambda *a: calls.append(a))
    got = chain.find_chains(contigs['fwd'], dev_index, min_chain_score=200)
    assert not calls and dev_index._host is not None
    assert [(c.chrom_id, c.is_rev, c.score, c.qpos.tolist()) for c in got] == \
        [(c.chrom_id, c.is_rev, c.score, c.qpos.tolist()) for c in want]


def test_build_index_picks_the_host_past_the_kernels_limits(case, monkeypatch):
    """On CUDA a reference with a chromosome past int32, or k or w past the
    kernels' limits, keeps the host index (no card is touched)."""
    ref, _ = case
    built = []
    host = MinimizerIndex(ref, 19, 10)
    monkeypatch.setattr(index_mod, 'DeviceMinimizerIndex', lambda *a, **kw: built.append(a))
    monkeypatch.setattr(index_mod, 'MinimizerIndex', lambda *a, **kw: host)
    assert build_index(ref, 32, 10, 'cuda') is host
    assert build_index(ref, 19, seed.MAX_W + 1, 'cuda') is host
    monkeypatch.setattr(index_mod, 'INT32_LIMIT', ref.length('chr1'))
    assert build_index(ref, 19, 10, 'cuda') is host
    assert not built


def test_sort_rows_orders_by_group_rpos_qpos():
    rng = np.random.default_rng(3)
    n = 5000
    q = rng.integers(0, 1 << 31, n, dtype=np.int64)
    r = rng.integers(0, 1 << 31, n, dtype=np.int64)
    g = rng.integers(0, 5000, n, dtype=np.int64)
    r[:2000] = r[0]     # ties on (group, rpos)
    g[:2000] = g[0]
    rows = seed.sort_rows(torch.from_numpy(q.astype(np.int32)),
                          torch.from_numpy((g << 31) | r)).numpy()
    order = np.lexsort((q, r, g))
    assert np.array_equal(rows, np.stack([q[order], r[order], g[order], g[order] >> 1]))


def test_wrappers_check_their_inputs():
    codes = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        seed.sketch(codes, seed.MAX_K + 1, 10)
    with pytest.raises(ValueError):
        seed.sketch(codes, 19, 0)
    with pytest.raises(ValueError):
        seed.sketch(codes.int(), 19, 10)
    with pytest.raises(ValueError):
        seed.runs(torch.zeros(3, dtype=torch.int32))
    keys = seed.runs(torch.arange(5))
    with pytest.raises(ValueError):
        seed.anchors(torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int64),
                     torch.zeros(2, dtype=torch.int8), 10, 3, 64,
                     (*keys, torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.int8)))


def test_keys_order_as_unsigned_hashes():
    keys = np.array([-(1 << 63), -1, 0, (1 << 63) - 1], dtype=np.int64)
    h = seed.to_hash(keys)
    assert h.tolist() == [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    codes = np.random.default_rng(0).integers(0, 4, 3000).astype(np.uint8)
    pos, key, _ = seed.sketch(torch.from_numpy(codes), 19, 10)
    assert np.array_equal(seed.to_hash(key.numpy()), minimizers(codes, 19, 10)[1])
