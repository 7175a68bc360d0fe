"""The plain reference's counts on cases made by hand: events near contig
ends and duplicate calls, and where a DP item's windows may lie."""

import os

import numpy as np
import pytest

from cpu_harness import BENCH, load

R = load(os.path.join(BENCH, 'reference.py'), 'bench_reference')


def test_edge_and_duplicate_counts():
    layout = {'h1_tig1': {'hap': 'h1', 'chrom': 'c', 'ref_start': 0, 'ref_end': 60000},
              'h1_tig2': {'hap': 'h1', 'chrom': 'c', 'ref_start': 52000, 'ref_end': 100000}}
    ends = R.contig_ends(layout)
    assert list(ends['h1']['c']) == [0, 52000, 60000, 100000]
    want = {'h1': [('SNV', 'c', 3000, 'A'), ('SNV', 'c', 30000, 'C'),
                   ('SNV', 'c', 56000, 'G'), ('SNV', 'c', 66000, 'T')]}
    got = {'h1': [('SNV', 'c', 3000, 'A'), ('SNV', 'c', 30000, 'C'), ('SNV', 'c', 30000, 'C'),
                  ('SNV', 'c', 66000, 'T')]}
    c = R.compare_calls(want, got, ends)
    # edge events: 3000 (start), 56000 (inside the overlap), 66000 (6 kb past
    # an end is not); 56000 missed
    assert c == {'planted': 4, 'missed': 1, 'called': 4, 'false': 1, 'edge_planted': 2,
                 'edge_missed': 1, 'duplicate': 1}


def seq(n, seed):
    return ''.join('ACGT'[i] for i in np.random.default_rng(seed).integers(0, 4, n))


def rc(s):
    return s.translate(R._COMP)[::-1]


@pytest.fixture(scope='module')
def sample():
    ref = seq(5000, 1)
    fwd_tig, rev_tig = ref[:2600], rc(ref[2400:])
    return (R.SliceIndex({'c': ref}), R.SliceIndex({'t1': fwd_tig, 't2': rev_tig}),
            {'t1': '+', 't2': '-'}, ref)


def test_slice_index_finds_every_orientation(sample):
    ref_index, tig_index, _, ref = sample
    w = ref[3000:3100]
    assert tig_index.places(w) == {('t2', 'rc')}
    assert tig_index.places(w[::-1]) == {('t2', 'comp')}
    assert ref_index.places(w) == {('c', 'fwd')}
    assert ref_index.places(w[:40] + 'A' + w[41:]) in (set(), {('c', 'fwd')})
    assert tig_index.places(ref[2450:2550]) == {('t1', 'fwd'), ('t2', 'rc')}
    assert ref_index.places(seq(100, 9)) == set()


def test_window_ok_holds_orientation(sample):
    ref_index, tig_index, strand, ref = sample
    r_w, q_w = ref[3000:3080], ref[3005:3070]
    ok = lambda a, b: R.window_ok(a, b, ref_index, tig_index, strand)  # noqa: E731
    assert ok(q_w, r_w) is True                     # forward pair, from the '-' contig
    assert ok(q_w[::-1], r_w[::-1]) is True         # both reversed
    assert ok(r_w, q_w) is True                     # transposed
    assert ok(q_w[::-1], r_w) is False              # reversed on one side only
    assert ok(q_w.translate(R._COMP)[::-1], r_w) is False  # a '-' contig's slice unturned
    assert ok('ACG', r_w[::-1]) is True             # a short side places nothing
    assert ok('ACG', 'TTAG') is None
    # a window of the '+' contig complemented, or of the '-' one reversed
    # without its complement, is no slice as the contig lies
    assert ok('ACG', ref[100:180].translate(R._COMP)) is False
    assert ok('ACG', rc(ref[3000:3080])[::-1]) is False
    assert ok('ACG', seq(80, 5)) is False
