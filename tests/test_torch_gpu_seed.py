"""Minimizer seeding on the card (``csrc/seed.cu`` through ``ops.seed``)
against the host path, bit for bit: the sketch against ``minimizers``, the
device index's tables against ``MinimizerIndex``, and a contig's sorted
anchors against ``collect_anchors`` followed by ``native.sort_anchors``.

The cases: a reference of four chromosomes (N runs, a repeat under and one
past ``max_occ``, one shorter than k + w, one shorter than k), and contigs on
both strands, over the repeats, shorter than k + w, and across many sketch
tiles; then chr21's length (46.7 Mbp, uniform bases). Needs a CUDA device
and nvcc; skipped without them. Imports no jax (the CPU tests in
``test_torch_seed.py`` run the same cases on the plain versions):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_seed.py
"""

import numpy as np
import pytest
import torch

from pav_tpu_torch import seqcodec
from pav_tpu_torch.align.aligner import chain
from pav_tpu_torch.align.aligner.index import DeviceMinimizerIndex, MinimizerIndex, minimizers
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import seed

pytestmark = pytest.mark.gpu
KW = [(19, 10), (15, 6)]
MAX_OCC = [64, 8]
CHR21 = 46_709_983


def reference_case(seed_=5):
    """(SeqStore of chr1-chr4, {contig: codes}) of the cases above."""
    rng = np.random.default_rng(seed_)
    chr1 = rng.integers(0, 4, 120_000).astype(np.uint8)
    chr1[40_000:40_500] = 4
    chr1[rng.integers(0, len(chr1), 60)] = 4
    unit_a = rng.integers(0, 4, 300).astype(np.uint8)   # 40 copies: under max_occ 64
    unit_b = rng.integers(0, 4, 200).astype(np.uint8)   # 100 copies: past it
    chr2 = np.concatenate([rng.integers(0, 4, 3000).astype(np.uint8), np.tile(unit_a, 40),
                           rng.integers(0, 4, 2000).astype(np.uint8), np.tile(unit_b, 100),
                           rng.integers(0, 4, 5000).astype(np.uint8)])
    ref = SeqStore({'chr1': chr1, 'chr2': chr2, 'chr3': chr1[1000:1025],
                    'chr4': chr1[2000:2010]})
    fwd = chr1[5000:95_000].copy()
    fwd[rng.integers(0, len(fwd), 300)] = rng.integers(0, 4, 300)
    contigs = {
        'fwd': fwd,
        'rev': np.concatenate([seqcodec.revcomp(chr2[1000:20_000]), chr1[100_000:110_000]]),
        'repeats': np.concatenate([np.tile(unit_b, 5), np.tile(unit_a, 7)]),
        'short': chr1[300:320],
        'tiny': chr1[600:605],
        'with_n': np.concatenate([chr1[60_000:61_000], np.full(100, 4, np.uint8),
                                  seqcodec.revcomp(chr1[70_000:72_000])]),
    }
    return ref, contigs


def index_tables(index):
    """A DeviceMinimizerIndex's tables as MinimizerIndex holds them."""
    starts = index.uniq_starts.cpu().numpy()
    uniq = seed.to_hash(index.uniq_keys.cpu().numpy())
    return {'hashes': np.repeat(uniq, np.diff(starts)),
            'chrom_ids': index.chrom_ids.cpu().numpy(),
            'positions': index.positions.cpu().numpy().astype(np.int64),
            'strands': index.strands.cpu().numpy(),
            'uniq_hashes': uniq, 'uniq_starts': starts[:-1], 'uniq_counts': np.diff(starts),
            'max_pos': index.max_pos, 'n': index.n_minimizers()}


def assert_index_equal(dev_index, host_index):
    got = index_tables(dev_index)
    for name in ('hashes', 'chrom_ids', 'positions', 'strands', 'uniq_hashes', 'uniq_starts',
                 'uniq_counts'):
        want = getattr(host_index, name)
        assert got[name].dtype == want.dtype, name
        assert np.array_equal(got[name], want), name
    assert got['max_pos'] == host_index.max_pos
    assert got['n'] == host_index.n_minimizers()


def assert_anchors_equal(codes, dev_index, host_index, max_occ):
    want = host_index.sorted_anchors(codes, max_occ)
    got = dev_index.sorted_anchors(codes, max_occ)
    if len(want[0]) == 0:
        assert all(len(g) == 0 for g in got)
        return 0
    for name, g, w in zip(('qpos', 'rpos', 'group', 'chrom', 'rev'), got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    return len(want[0])


def assert_sketch_equal(codes, k, w, dev):
    pos, key, strand = seed.sketch(torch.from_numpy(codes).to(dev), k, w)
    want = minimizers(codes, k, w)
    assert np.array_equal(pos.cpu().numpy(), want[0])
    assert np.array_equal(seed.to_hash(key.cpu().numpy()), want[1])
    assert np.array_equal(strand.cpu().numpy(), want[2])


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('the seeding kernels run only on a CUDA device')
    return torch.device('cuda', 0)


@pytest.fixture(scope='module')
def case():
    return reference_case()


@pytest.mark.parametrize('k,w', KW + [(31, 64), (5, 3)])
def test_sketch_matches_host(dev, k, w):
    rng = np.random.default_rng(k * 100 + w)
    for n in (0, k - 1, k, k + w - 2, k + w - 1, k + w, 2048 + k, 5000, 70_001):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if n > 100:
            codes[rng.integers(0, n, n // 50)] = 4
            codes[n // 3:n // 3 + 41] = 4
        assert_sketch_equal(codes, k, w, dev)


@pytest.mark.parametrize('k,w', KW)
def test_index_matches_host(dev, case, k, w):
    ref, _ = case
    before = dict(seed.LAUNCHES)
    assert_index_equal(DeviceMinimizerIndex(ref, k, w, device=dev), MinimizerIndex(ref, k, w))
    # A chromosome with a full window takes the count pass, and the emit
    # pass where it has minimizers; the runs take both.
    passes = sum((ref.length(c) - k + 1 >= w) + (len(minimizers(ref.get(c), k, w)[0]) > 0)
                 for c in ref.names())
    assert seed.LAUNCHES['sketch'] == before['sketch'] + passes
    assert seed.LAUNCHES['runs'] == before['runs'] + 2


@pytest.mark.parametrize('max_occ', MAX_OCC)
@pytest.mark.parametrize('k,w', KW)
def test_anchors_match_host(dev, case, k, w, max_occ):
    ref, contigs = case
    dev_index = DeviceMinimizerIndex(ref, k, w, device=dev)
    host_index = MinimizerIndex(ref, k, w)
    counts = {name: assert_anchors_equal(codes, dev_index, host_index, max_occ)
              for name, codes in contigs.items()}
    assert counts['fwd'] > 1000 and counts['rev'] > 1000
    assert counts['tiny'] == 0


def test_find_chains_on_streams_matches_host(dev, case):
    """find_chains from planning threads at once, each on its own stream,
    gives the host index's chains."""
    from concurrent.futures import ThreadPoolExecutor
    ref, contigs = case
    dev_index = DeviceMinimizerIndex(ref, 19, 10, device=dev)
    host_index = MinimizerIndex(ref, 19, 10)

    def chains(index, codes):
        return [(c.chrom_id, c.is_rev, c.score, c.qpos.tolist(), c.rpos.tolist())
                for c in chain.find_chains(codes, index, min_chain_score=200)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda c: chains(dev_index, c), list(contigs.values()) * 3))
    want = [chains(host_index, c) for c in contigs.values()] * 3
    assert got == want
    assert any(got)


def test_chr21_scale(dev):
    """chr21's length: the index bit-identical to the host's, and the sorted
    anchors of a 30 Mbp contig (one third reverse-complemented) equal."""
    rng = np.random.default_rng(21)
    chrom = rng.integers(0, 4, CHR21).astype(np.uint8)
    ref = SeqStore({'chr21': chrom})
    dev_index = DeviceMinimizerIndex(ref, 19, 10, device=dev)
    host_index = MinimizerIndex(ref, 19, 10)
    assert_index_equal(dev_index, host_index)
    contig = np.concatenate([chrom[1_000_000:21_000_000],
                             seqcodec.revcomp(chrom[25_000_000:35_000_000])])
    assert assert_anchors_equal(contig, dev_index, host_index, 64) > 1_000_000
