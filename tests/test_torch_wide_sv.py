"""Kilobase SVs through the torch port on the CPU, against the JAX reference
and planted truth.

The genome is chip_smoke.py's phase-13a genome, ``synth.wide_genome`` at
``synth.WIDE_SMALL`` (400 kb, seed 29): bench.py's generator with 30%
of its SVs of 2-10 kb, ten of them, an INS of 9109 and a DEL of 9262 bp
among them. Their DP segments take the accelerator ladder's full-width
classes of widths 8193 and 32769: dp_full's wide path on the card, its
plain version here. Held:

* the port with ``ladder='accel'`` (the CUDA path's classes, the kernels'
  plain versions) against ``pav_tpu`` forced onto its accelerator branch:
  identical VCF text apart from ``##fileDate``, identical per-haplotype
  stage artifacts and merged tables, and a class table with both widths;
* the port on the CPU ladder against the unforced reference: identical
  merged tables;
* both packages' VCFs against the planted truth in the >= 2 kb bin, at
  tests/test_recall.py's INS and DEL floors;
* the generator plants what it says, and the size bin finds a miss.
"""

import gzip
import io

import numpy as np
import pandas as pd
import pytest

from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import _HAP_ARTIFACTS
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch import synth
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import affine_dp
from pav_tpu_torch.parallel import pools
from pav_tpu_torch.pipeline import Pipeline

from test_torch_pipeline import reference_accel_branch

CONFIG = {}     # the CLI's defaults, as phase 13a runs it


@pytest.fixture(scope='module')
def genome():
    return synth.wide_genome(*synth.WIDE_SMALL)


def _haps(genome, store):
    _, h1, h2, _, _ = genome
    return {'h1': store({'wtig1': h1}), 'h2': store({'wtig2': h2})}


def _vcf_text(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines() if not line.startswith('##fileDate')]


@pytest.fixture(scope='module')
def accel_runs(genome, tmp_path_factory):
    """(reference on its accelerator branch, port with ladder='accel', the
    port's DP class table)."""
    ref = genome[0]
    with reference_accel_branch():
        want = RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG),
                           run_dir=str(tmp_path_factory.mktemp('ref_accel')),
                           log=io.StringIO()).run_sample('w', _haps(genome, RefSeqStore))
    affine_dp.stats_reset()
    got = Pipeline(SeqStore({'chr1': ref}), dict(CONFIG),
                   run_dir=str(tmp_path_factory.mktemp('port_accel')), device='cpu',
                   ladder='accel', log=io.StringIO()).run_sample('w', _haps(genome, SeqStore))
    classes = dict(affine_dp.STATS['classes'])
    return want, got, classes


def test_port_vcf_matches_reference(accel_runs):
    want, got, _ = accel_runs
    lines = _vcf_text(got['vcf'])
    assert sum(1 for line in lines if not line.startswith('#')) >= 500
    assert lines == _vcf_text(want['vcf'])


@pytest.mark.parametrize('hap', ['h1', 'h2'])
def test_port_stage_artifacts_match_reference(accel_runs, hap):
    want, got, _ = accel_runs
    for _, attr in _HAP_ARTIFACTS:
        pd.testing.assert_frame_equal(getattr(got['haps'][hap], attr),
                                      getattr(want['haps'][hap], attr), obj=f'{hap}.{attr}')


def test_port_merged_tables_match_reference(accel_runs):
    want, got, _ = accel_runs
    assert set(got['merged']) == set(want['merged'])
    for key, table in want['merged'].items():
        pd.testing.assert_frame_equal(got['merged'][key], table, obj=str(key))


def test_class_table_holds_the_wide_widths(accel_runs):
    """The accelerator ladder ran full-width classes of widths 8193 and
    32769 (the plain version of dp_full's wide path: on the CPU there is no
    launch to count), as phase 13a requires of the card's run."""
    *_, classes = accel_runs
    widths = {k[2] for k, v in classes.items() if k[2] == k[1] + 1 and v[0] > 0}
    assert set(synth.WIDE_WIDTHS) <= widths, sorted(classes)


def test_cpu_ladder_matches_reference(genome):
    """The CPU ladder against the unforced reference: identical merged
    tables. The port's pools run inline (parallel/pools.py: the same
    results): the plain kernels' small tensor ops on two haplotype threads
    take twice as long as in turn."""
    ref = genome[0]
    want = RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG), log=io.StringIO()).run_sample(
        'w', _haps(genome, RefSeqStore), write_vcf=False)['merged']
    with pools.inline():
        got = Pipeline(SeqStore({'chr1': ref}), dict(CONFIG), device='cpu',
                       log=io.StringIO()).run_sample(
            'w', _haps(genome, SeqStore), write_vcf=False)['merged']
    assert sorted(got) == sorted(want)
    assert sum(df.shape[0] for df in want.values()) >= 500
    for key in want:
        pd.testing.assert_frame_equal(got[key].reset_index(drop=True),
                                      want[key].reset_index(drop=True), obj=str(key))


@pytest.mark.parametrize('package', ['reference', 'port'])
def test_size_bin_meets_the_floors(genome, accel_runs, package):
    """Each package's VCF in the >= 2 kb bin: INS and DEL recall >= 0.97
    and precision >= 0.95 (tests/test_recall.py's floors), all ten wide
    events planted."""
    want, got, _ = accel_runs
    vcf = (want if package == 'reference' else got)['vcf']
    rep, misses = synth.truth_report(vcf, genome[3] + genome[4], min_len=synth.WIDE_MIN)
    print(f'{package} SVs of >= {synth.WIDE_MIN} bp:\n{rep.to_string()}')
    assert rep['N_TRUTH'].sum() == 10
    assert misses == [], rep


def test_wide_genome_plants_what_it_says(genome):
    """>= 30% of the SVs are of 2000-10000 bp, at least two above 8192 bp,
    and h2 carries the one inversion."""
    _, _, _, t1, t2 = genome
    svs = [t['len'] for t in t1 + t2 if t['type'] in ('INS', 'DEL') and t['len'] >= 50]
    wide = [x for x in svs if x >= synth.WIDE_MIN]
    assert all(x <= 10000 for x in svs)
    assert len(wide) >= 0.3 * len(svs) and 8 <= len(wide) <= 12
    assert sum(x > 8192 for x in wide) >= 2
    assert [t['type'] for t in t2 if t['type'] == 'INV'] == ['INV']
    assert not any(t['type'] == 'INV' for t in t1)


def test_wide_sv_len_spectrum():
    """wide_sv_len draws 30% of lengths uniformly from 2000-10000 bp and the
    rest from bench.py's 50-1499."""
    rng = np.random.default_rng(5)
    lens = np.array([synth.wide_sv_len(rng) for _ in range(20000)])
    wide = lens >= synth.WIDE_MIN
    assert abs(wide.mean() - 0.3) < 0.015
    assert lens[wide].min() >= 2000 and lens[wide].max() <= 10000
    assert lens[~wide].min() >= 50 and lens[~wide].max() < 1500
    assert abs(np.median(lens[wide]) - 6000) < 200


def test_size_bin_finds_a_miss(genome, accel_runs, tmp_path):
    """The port's VCF without its largest insertion: the bin's INS recall
    falls below its floor; the whole-class report may still meet it."""
    _, got, _ = accel_runs
    with gzip.open(got['vcf'], 'rt') as fh:
        lines = fh.read().splitlines(keepends=True)
    ins = [line for line in lines if not line.startswith('#')
           and len(line.split('\t')[4]) > len(line.split('\t')[3])]
    largest = max(ins, key=lambda line: len(line.split('\t')[4]))
    assert len(largest.split('\t')[4]) > 9000
    path = tmp_path / 'cut.vcf.gz'
    with gzip.open(path, 'wt') as fh:
        fh.writelines(line for line in lines if line is not largest)
    truth = genome[3] + genome[4]
    rep, misses = synth.truth_report(str(path), truth, min_len=synth.WIDE_MIN)
    assert [m.split()[:2] for m in misses] == [['INS', 'RECALL']], rep
    assert rep.loc['INS', 'RECALL'] == 5 / 6
    full, _ = synth.truth_report(str(path), truth)
    assert full.loc['INS', 'N_TRUTH'] > 6
