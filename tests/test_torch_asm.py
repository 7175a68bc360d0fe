"""Assembly-shaped samples: ``synth.asm_genome`` and the port on them.

asm_genome builds a diploid assembly the way users' phased assemblies
look: two chromosomes at GRCh38's chr21 and chr22 lengths (or 1/10, 1/200
of them), bench.py's planted events on each, and each haplotype's copy of
a chromosome cut into contigs that end inside it, some sharing 1-10 kb with
their neighbour, on either strand, in shuffled FASTA order. Held here:

* the generator: its contigs rebuild each haplotype chromosome exactly
  (strand undone, overlaps removed); no cut falls inside a planted event;
  truth records carry their chromosome; every sample has, in each
  haplotype, a reverse contig and an overlap; a seed gives one sample;
* ``synth.truth_to_df`` on two chromosomes, and unchanged on bench16's
  one-chromosome truth;
* asm_tiny through the port and ``pav_tpu`` on both ladders (the CPU
  ladder against the unforced reference, ``ladder='accel'`` against the
  reference on its accelerator branch): equal stage tables, integrated and
  merged tables and VCF text; on the accelerator ladder the resident gather
  reads reverse-strand windows (gather flags 2 and 3), the merge shards
  over the two chromosomes, and trimming removes the contigs' overlaps.
"""

import functools
import io

import numpy as np
import pandas as pd
import pytest

from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch import seqcodec, synth
from pav_tpu_torch.io.fasta import SeqStore

from test_recall import truth_to_df as recall_truth_to_df
from test_torch_reference_inputs import (LADDERS, _assert_hap_equal, _assert_merged_equal,
                                         _port, _reference, _vcf_text)

SAMPLES = ['ASM_TINY', 'ASM10', 'ASM97']


@functools.lru_cache(maxsize=None)
def _sample(name):
    return synth.asm_genome(*getattr(synth, name))


def _contigs(name, hap):
    """{chrom: [(layout, contig codes on the haplotype's strand)]} of one
    haplotype, each chromosome's contigs in order along it."""
    _, h1, h2, _, _, layout = _sample(name)
    tigs = h1 if hap == 'h1' else h2
    out = {}
    for tig, codes in tigs.items():
        where = layout[tig]
        assert where['hap'] == hap
        fwd = codes if where['strand'] == '+' else seqcodec.revcomp(codes)
        out.setdefault(where['chrom'], []).append((where, fwd))
    return {c: sorted(v, key=lambda x: x[0]['start']) for c, v in out.items()}


@pytest.mark.parametrize('hap', ['h1', 'h2'])
@pytest.mark.parametrize('name', SAMPLES)
def test_contigs_rebuild_haplotypes(name, hap):
    """Each chromosome's contigs, strand undone and overlaps removed, are
    asm_chrom's haplotype of it base for base; 1-3 cuts a chromosome,
    each contig at least a tenth of its chromosome, overlaps of 1-10 kb."""
    lens, seed = getattr(synth, name)
    contigs = _contigs(name, hap)
    assert sorted(contigs) == sorted(c for c, _ in lens)
    for index, (chrom, length) in enumerate(lens):
        want = synth.asm_chrom(length, seed, index)[1 if hap == 'h1' else 2]
        pieces = contigs[chrom]
        assert 2 <= len(pieces) <= 4
        assert pieces[0][0]['start'] == 0 and pieces[-1][0]['end'] == len(want)
        got = pieces[0][1]
        for (prev, _), (where, fwd) in zip(pieces, pieces[1:]):
            overlap = prev['end'] - where['start']
            assert overlap == 0 or 1000 <= overlap <= 10000
            assert np.array_equal(fwd[:overlap], got[len(got) - overlap:])
            got = np.concatenate([got, fwd[overlap:]])
        assert np.array_equal(got, want)
        for where, fwd in pieces:
            assert len(fwd) == where['end'] - where['start']
            assert where['ref_end'] - where['ref_start'] >= length / synth.ASM_MIN_SHARE


@pytest.mark.parametrize('name', SAMPLES)
def test_truth_chromosomes_and_cuts(name):
    """Every truth record names its chromosome, both chromosomes carry an
    h2 inversion, and no contig end falls inside a planted event."""
    lens, _ = getattr(synth, name)
    ref, _, _, t1, t2, layout = _sample(name)
    assert {c: len(s) for c, s in ref.items()} == dict(lens)
    for hap, truth in (('h1', t1), ('h2', t2)):
        assert {t['chrom'] for t in truth} == set(ref)
        invs = [t['chrom'] for t in truth if t['type'] == 'INV']
        assert sorted(invs) == (sorted(ref) if hap == 'h2' else [])
        for chrom in ref:
            spans = np.array([(t['pos'], t['pos'] + (t['len'] if t['type'] in ('DEL', 'INV')
                                                     else 1))
                              for t in truth if t['chrom'] == chrom])
            for where in layout.values():
                if where['hap'] != hap or where['chrom'] != chrom:
                    continue
                for end in (where['ref_start'], where['ref_end']):
                    assert not ((spans[:, 0] <= end) & (end < spans[:, 1])).any(), (
                        name, hap, chrom, end)


@pytest.mark.parametrize('name', SAMPLES)
def test_samples_have_both_strands_and_overlaps(name):
    """The shape each sample's seed was chosen for: each haplotype has a
    reverse-strand contig and a forward one, an overlapping pair, and its
    contig names (FASTA order) out of reference order."""
    _, h1, h2, _, _, layout = _sample(name)
    for hap, tigs in (('h1', h1), ('h2', h2)):
        assert {layout[t]['strand'] for t in tigs} == {'+', '-'}
        assert all(t.startswith(f'{hap}_tig') for t in tigs)
        assert list(tigs) == sorted(tigs)
        in_ref = sorted(tigs, key=lambda t: (layout[t]['chrom'], layout[t]['start']))
        assert in_ref != list(tigs)
        assert any(layout[a]['chrom'] == layout[b]['chrom']
                   and layout[b]['start'] < layout[a]['end']
                   for a, b in zip(in_ref, in_ref[1:]))


def test_generator_repeats_for_a_seed():
    lens, seed = synth.ASM_TINY
    a, b = synth.asm_genome(lens, seed), synth.asm_genome(lens, seed)
    other = synth.asm_genome(lens, seed + 1)
    for x, y in ((a[0], b[0]), (a[1], b[1]), (a[2], b[2])):
        assert list(x) == list(y) and all(np.array_equal(x[k], y[k]) for k in x)
    assert a[3:] == b[3:]
    assert a[5] != other[5]


def test_truth_to_df_two_chromosomes():
    _, _, _, t1, _, _ = _sample('ASM_TINY')
    df = synth.truth_to_df(t1)
    assert df.shape[0] == len(t1)
    assert list(df['#CHROM']) == [t['chrom'] for t in t1]
    assert set(df['#CHROM']) == {'chr21', 'chr22'}
    assert (synth.truth_to_df(t1, chrom='chrX')['#CHROM'] == df['#CHROM']).all()


def test_truth_to_df_default_keeps_bench16():
    """Records without a chromosome (bench_genome's) take ``chrom``, as
    tests/test_recall.py's truth_to_df: bench16's generator at 200 kb."""
    _, _, _, t1, t2 = synth.bench_genome(200_000, 11)
    pd.testing.assert_frame_equal(synth.truth_to_df(t1 + t2), recall_truth_to_df(t1 + t2))
    pd.testing.assert_frame_equal(synth.truth_to_df(t2, chrom='chr7'),
                                  recall_truth_to_df(t2, chrom='chr7'))


# ------------------------------------------------ asm_tiny on both packages

@pytest.fixture(scope='module', params=LADDERS)
def tiny_runs(request, tmp_path_factory):
    """asm_tiny through pav_tpu and the port on one ladder; the port's run
    with its merge jobs and gather flags counted."""
    from pav_tpu_torch import pipeline as port_pipeline
    from pav_tpu_torch.ops import affine_dp
    ladder = request.param
    ref, h1, h2, *_ = _sample('ASM_TINY')
    want = _reference(ladder, lambda: RefPipeline(
        RefSeqStore(ref), {}, run_dir=str(tmp_path_factory.mktemp('asm_ref')),
        log=io.StringIO()).run_sample('asm', {'h1': RefSeqStore(h1), 'h2': RefSeqStore(h2)}))
    subsets = []
    merge = port_pipeline.merge_haplotypes

    def counted(*args, subset_chrom=None, **kwargs):
        subsets.append(None if subset_chrom is None else tuple(sorted(subset_chrom)))
        return merge(*args, subset_chrom=subset_chrom, **kwargs)
    affine_dp.stats_reset()
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pipeline, 'merge_haplotypes', counted)
        pipe = _port(ladder, ref, {}, run_dir=str(tmp_path_factory.mktemp('asm_port')))
        pipe.log = log
        got = pipe.run_sample('asm', {'h1': SeqStore(h1), 'h2': SeqStore(h2)})
    stats = dict(affine_dp.STATS)
    return ladder, want, got, subsets, stats, log.getvalue()


@pytest.mark.parametrize('hap', ['h1', 'h2'])
def test_asm_tiny_stage_tables_match_reference(tiny_runs, hap):
    _, want, got, *_ = tiny_runs
    _assert_hap_equal(got['haps'][hap], want['haps'][hap], hap)


def test_asm_tiny_vcf_matches_reference(tiny_runs):
    _, want, got, *_ = tiny_runs
    _assert_merged_equal(got['merged'], want['merged'])
    lines = _vcf_text(got['vcf'])
    assert lines == _vcf_text(want['vcf'])
    chroms = [line.split('\t')[0] for line in lines if line and not line.startswith('#')]
    assert set(chroms) == {'chr21', 'chr22'}
    assert sum('<INV>' in line for line in lines) == 2


def test_asm_tiny_paths(tiny_runs):
    """What the slice is for: every haplotype aligned several contigs, the
    merge sharded over the two chromosome batches, trimming in reference
    space removed the overlaps, and on the accelerator ladder the resident
    gather read reverse-strand windows (flags 2 and 3), two windows an
    item."""
    ladder, _, got, subsets, stats, log = tiny_runs
    for hap in ('h1', 'h2'):
        res = got['haps'][hap]
        assert res.align_none['QRY_ID'].nunique() >= 4
        trimmed = ((res.align_qry['END'] - res.align_qry['POS']).sum()
                   - (res.align_qryref['END'] - res.align_qryref['POS']).sum())
        assert trimmed >= 1000
    assert '(2 chromosome batches)' in log
    assert {('chr21',), ('chr22',)} <= set(subsets)
    flags = stats['gather_flags']
    if ladder == 'accel':
        assert flags[2] > 0 and flags[3] > 0
        assert sum(flags) == 2 * stats['items']
    else:
        assert flags == (0, 0, 0, 0)
