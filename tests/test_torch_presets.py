"""The port against pav_tpu on the two reference configurations no other
port test sets: the ``lra`` aligner preset and ``FILTER_<hap>`` columns
read by ``pipeline.run``.

``aligner: lra`` maps to the ``native-sensitive`` preset (k 15, w 6, a
higher max_occ), which runs through the port's own aligner
(``pav_tpu_torch/align/aligner/core.py``). On the inputs of
test_aligner_presets.py (the clean diploid, seed 202; the repeat-rich
haplotype, seed 77) the port's stage tables (the alignment tables among
them) and merged calls equal the reference's: on the CPU ladder against the
unforced reference, and with ``ladder='accel'`` against the reference forced
onto its accelerator branch; never across ladders.

``FILTER_h1`` goes through the port's own ``pipeline.run`` on the inputs of
test_qry_filter.py's ``filtered_run`` (seed 55, 60 kb, a filter region
around the second SNV), rebuilt here: the VCF (FILTER column included) and
the merged tables equal the reference's.
"""

import contextlib
import gzip

import numpy as np
import pandas as pd
import pytest

from pav_tpu.align.aligner.core import Aligner as RefAligner
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import _HAP_ARTIFACTS
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu.pipeline import run as ref_run
from pav_tpu_torch.align.aligner.core import Aligner
from pav_tpu_torch.io.fasta import SeqStore, write_fasta
from pav_tpu_torch.pipeline import Pipeline
from pav_tpu_torch.pipeline import run as port_run

from helpers import Mutator, random_seq, repeat_rich_ref
from test_torch_pipeline import reference_accel_branch

LRA = {'aligner_min_chain_score': 500, 'aligner': 'lra'}


def _clean_diploid():
    """test_aligner_presets.py's clean diploid: {hap: codes} and the ref."""
    rng = np.random.default_rng(202)
    ref = random_seq(120000, rng)
    m1 = Mutator(ref)
    m1.snv(15000, rng=rng)
    m1.ins(30000, random_seq(180, rng))
    m1.dele(55000, 320)
    m1.snv(80000, rng=rng)
    h1 = m1.finish()
    m2 = Mutator(ref)
    m2.snv(20000, rng=rng)
    m2.dele(40000, 12)
    m2.inv(90000, 4000)
    return ref, {'h1': h1, 'h2': m2.finish()}


def _repeat_haplotype():
    """test_aligner_presets.py's repeat-rich haplotype: an SNV every 6 kb
    outside N gaps."""
    rng = np.random.default_rng(77)
    ref, _ = repeat_rich_ref(150000, rng)
    mut = Mutator(ref)
    pos = 5000
    while pos < len(ref) - 10000:
        if ref[pos] < 4:
            mut.snv(pos, rng=rng)
        pos += 6000
    return ref, {'h1': mut.finish()}


GENOMES = {'clean': _clean_diploid, 'repeat': _repeat_haplotype}


def _runs(genome, ladder):
    """(reference result, port result) under ``aligner: lra``; the reference
    forced onto its accelerator branch for ``ladder='accel'``."""
    ref, haps = GENOMES[genome]()
    ref_haps = {h: RefSeqStore({f'tig_{h}': seq}) for h, seq in haps.items()}
    with reference_accel_branch() if ladder == 'accel' else contextlib.nullcontext():
        want = RefPipeline(RefSeqStore({'chr1': ref}), dict(LRA), log=None).run_sample(
            's1', ref_haps, write_vcf=False)
    port_haps = {h: SeqStore({f'tig_{h}': seq}) for h, seq in haps.items()}
    got = Pipeline(SeqStore({'chr1': ref}), dict(LRA), log=None, device='cpu',
                   ladder=None if ladder == 'cpu' else ladder).run_sample(
        's1', port_haps, write_vcf=False)
    return want, got


def test_lra_alias_parameters_equal():
    """``aligner: lra`` gives the same k, w, max_occ and minimum chain score
    in both packages; an explicit ``aligner_k`` still wins in both."""
    ref = random_seq(50000, np.random.default_rng(0))
    for config in ({'aligner': 'lra'}, {'aligner': 'minimap2'},
                   {'aligner': 'lra', 'aligner_k': 21}):
        want = RefAligner(RefSeqStore({'chr1': ref}), dict(config))
        got = Aligner(SeqStore({'chr1': ref}), dict(config), device='cpu')
        assert ((got.k, got.w, got.max_occ, got.min_chain_score)
                == (want.k, want.w, want.max_occ, want.min_chain_score)), config
    lra = Aligner(SeqStore({'chr1': ref}), {'aligner': 'lra'}, device='cpu')
    assert (lra.k, lra.w) == (15, 6) and lra.max_occ > 64
    assert Aligner(SeqStore({'chr1': ref}), {'aligner': 'lra', 'aligner_k': 21},
                   device='cpu').k == 21


@pytest.mark.parametrize('ladder', ['cpu', 'accel'])
@pytest.mark.parametrize('genome', ['clean', 'repeat'])
def test_lra_tables_and_calls_equal(genome, ladder):
    want, got = _runs(genome, ladder)
    assert sorted(got['haps']) == sorted(want['haps'])
    for hap in want['haps']:
        assert want['haps'][hap].align_none.shape[0] > 0
        for _, attr in _HAP_ARTIFACTS:
            pd.testing.assert_frame_equal(getattr(got['haps'][hap], attr),
                                          getattr(want['haps'][hap], attr),
                                          obj=f'{genome} {ladder} {hap}.{attr}')
    assert sorted(got['merged']) == sorted(want['merged'])
    assert want['merged'][('snv_snv', 'pass')].shape[0] >= 3
    for key, df in want['merged'].items():
        pd.testing.assert_frame_equal(got['merged'][key], df, obj=f'{genome} {ladder} {key}')


@pytest.fixture(scope='module')
def filtered_runs(tmp_path_factory):
    """test_qry_filter.py's ``filtered_run`` inputs through both packages'
    ``pipeline.run``: (reference results, port results)."""
    base = tmp_path_factory.mktemp('qf')
    rng = np.random.default_rng(55)
    ref = random_seq(60000, rng)
    write_fasta({'chr1': ref}, str(base / 'ref.fa.gz'))
    m = Mutator(ref)
    m.snv(10000, rng=rng)
    m.snv(30000, rng=rng)
    write_fasta({'tig1': m.finish()}, str(base / 'h1.fa'))
    (base / 'filter_h1.bed').write_text('tig1\t29000\t31000\n')
    (base / 'assemblies.tsv').write_text(
        f'NAME\tHAP_h1\tFILTER_h1\nsamp\t{base}/h1.fa\t{base}/filter_h1.bed\n')
    config = {'aligner_min_chain_score': 300}
    want = ref_run(str(base / 'ref.fa.gz'), str(base / 'assemblies.tsv'), config=dict(config),
                   run_dir=str(base / 'ref_run'))
    got = port_run(str(base / 'ref.fa.gz'), str(base / 'assemblies.tsv'), config=dict(config),
                   run_dir=str(base / 'port_run'), device='cpu')
    return want, got


def _vcf_lines(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines() if not line.startswith('##fileDate')]


def test_filter_vcf_equal(filtered_runs):
    want, got = filtered_runs
    lines = _vcf_lines(got['samp']['vcf'])
    assert lines == _vcf_lines(want['samp']['vcf'])
    flt = {int(f[1]): f[6] for f in (line.split('\t') for line in lines
                                     if not line.startswith('#'))}
    assert flt[10001] == 'PASS' and 'QRY_FILTER' in flt[30001]


def test_filter_merged_tables_equal(filtered_runs):
    want, got = filtered_runs
    assert sorted(got['samp']['merged']) == sorted(want['samp']['merged'])
    for key, df in want['samp']['merged'].items():
        pd.testing.assert_frame_equal(got['samp']['merged'][key], df, obj=str(key))
    fail = got['samp']['merged'][('snv_snv', 'fail')]
    assert 'QRY_FILTER' in fail.loc[fail['POS'] == 30000, 'FILTER'].iloc[0]
