"""The port on the reference tests' own inputs, held against pav_tpu.

Each case builds the inputs of a reference test from the same seeds with
numpy and runs both packages on the CPU in this process:

* the inversion size sweep of test_inversion_sweep.py (300 bp by FLAG-DEN,
  500 and 2000 bp by ALNTRUNC-DEN, on an 80 kb genome);
* the multi-chromosome cases of test_multichrom.py (two chromosomes with
  their VCF header, an N-gap reference, a contig split across
  chromosomes);
* resume from artifacts on the workspace of test_cli_multisample.py.

Two comparisons: ``cpu``, the port on ``device='cpu'`` (its CPU class
ladder) against the unforced reference, and ``accel``, the port with
``ladder='accel'`` (the classes of its CUDA path) against the reference
forced onto its accelerator branch. Held: every stage artifact table, the
integrated tables, and, where the reference test writes one, the VCF text.
The 3 Mbp repeat stress is in test_torch_reference_repeat.py.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest

from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.io.fasta import write_fasta as ref_write_fasta
from pav_tpu.pipeline import _HAP_ARTIFACTS
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu.pipeline import run as ref_pipeline_run
from pav_tpu_torch.__main__ import main as port_main
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.pipeline import Pipeline

from helpers import Mutator, random_seq
from test_torch_pipeline import reference_accel_branch

LADDERS = ['cpu', 'accel']


def _null_log():
    return open(os.devnull, 'w')


def _port(ladder, ref_seqs, cfg, run_dir=None):
    return Pipeline(SeqStore(ref_seqs), dict(cfg), run_dir=run_dir, log=_null_log(),
                    device='cpu', ladder='accel' if ladder == 'accel' else None)


def _reference(ladder, run):
    """``run()`` on the reference, forced onto its accelerator branch for
    the ``accel`` comparison."""
    if ladder == 'accel':
        with reference_accel_branch():
            return run()
    return run()


def _assert_hap_equal(got, want, label):
    for _, attr in _HAP_ARTIFACTS:
        pd.testing.assert_frame_equal(getattr(got, attr), getattr(want, attr),
                                      obj=f'{label}.{attr}')
    assert set(got.integrated) == set(want.integrated)
    for key, (want_pass, want_fail) in want.integrated.items():
        got_pass, got_fail = got.integrated[key]
        pd.testing.assert_frame_equal(got_pass, want_pass, obj=f'{label} {key} pass')
        pd.testing.assert_frame_equal(got_fail, want_fail, obj=f'{label} {key} fail')


def _assert_merged_equal(got, want):
    assert set(got) == set(want)
    for key, df in want.items():
        pd.testing.assert_frame_equal(got[key], df, obj=str(key))


def _vcf_text(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith('##fileDate')]


# ---------------------------------------------------- the inversion sweep

@pytest.mark.parametrize('ladder', LADDERS)
@pytest.mark.parametrize('inv_len,route', [
    (300, 'FLAG-DEN'),
    (500, 'ALNTRUNC-DEN'),
    (2000, 'ALNTRUNC-DEN'),
])
def test_inversion_sizes(inv_len, route, ladder):
    """test_inversion_sweep.py's genome: the same tables on both packages,
    and the inversion called by the route the reference test names."""
    rng = np.random.default_rng(91)
    ref = random_seq(80000, rng)
    m = Mutator(ref)
    m.inv(40000, inv_len)
    h = m.finish()
    cfg = {'aligner_min_chain_score': 500}

    want = _reference(ladder, lambda: RefPipeline(
        RefSeqStore({'c': ref}), dict(cfg), log=_null_log()).run_haplotype(
            RefSeqStore({'t': h}), 'h1'))
    got = _port(ladder, {'c': ref}, cfg).run_haplotype(SeqStore({'t': h}), 'h1')
    _assert_hap_equal(got, want, f'{inv_len} bp')
    for res in (want, got):
        inv_pass = res.integrated['sv_inv'][0]
        assert inv_pass.shape[0] == 1, f'{inv_len} bp inversion not called'
        assert inv_pass.iloc[0]['CALL_SOURCE'] == route


# ------------------------------------------------------ several chromosomes

def _two_chromosomes():
    rng = np.random.default_rng(101)
    chr1 = random_seq(60000, rng)
    chr2 = random_seq(50000, rng)
    m1 = Mutator(chr1)
    m1.snv(10000, rng=rng)
    m1.ins(30000, random_seq(120, rng))
    h_chr1 = m1.finish()
    m2 = Mutator(chr2)
    m2.dele(20000, 200)
    m2.snv(40000, rng=rng)
    h_chr2 = m2.finish()
    return {'chr1': chr1, 'chr2': chr2}, {'t1': h_chr1, 't2': h_chr2}


@pytest.mark.parametrize('ladder', LADDERS)
def test_multichrom_calls_and_vcf(tmp_path, ladder):
    """test_multichrom.py's two-chromosome sample: equal stage tables,
    merged tables and VCF text, whose header has both ``##contig`` lines
    and whose records are sorted by chromosome."""
    refs, tigs = _two_chromosomes()
    cfg = {'aligner_min_chain_score': 500}
    want = _reference(ladder, lambda: RefPipeline(
        RefSeqStore(refs), dict(cfg), run_dir=str(tmp_path / 'ref'),
        log=_null_log()).run_sample('s', {'h1': RefSeqStore(tigs)}))
    got = _port(ladder, refs, cfg, run_dir=str(tmp_path / 'port')).run_sample(
        's', {'h1': SeqStore(tigs)})
    _assert_hap_equal(got['haps']['h1'], want['haps']['h1'], 'h1')
    _assert_merged_equal(got['merged'], want['merged'])
    lines = _vcf_text(got['vcf'])
    assert lines == _vcf_text(want['vcf'])
    assert any('##contig=<ID=chr1,length=60000' in line for line in lines)
    assert any('##contig=<ID=chr2,length=50000' in line for line in lines)
    chroms = [line.split('\t')[0] for line in lines if line and not line.startswith('#')]
    assert set(chroms) == {'chr1', 'chr2'} and chroms == sorted(chroms)
    snv = got['merged'][('snv_snv', 'pass')]
    assert (snv.loc[snv['#CHROM'] == 'chr2', 'POS'] == 40000).any()


@pytest.mark.parametrize('ladder', LADDERS)
def test_n_gap_reference(ladder):
    """test_multichrom.py's N-gap reference: the same N-gap table and
    tables; the removed region (N run included) is a deletion, with no SNV
    inside the Ns."""
    rng = np.random.default_rng(103)
    ref_codes = random_seq(60000, rng)
    ref_codes[30000:30500] = 4
    contig = np.concatenate([ref_codes[5000:29000], ref_codes[31000:55000]])
    cfg = {'aligner_min_chain_score': 500}

    ref_pipe = RefPipeline(RefSeqStore({'c': ref_codes}), dict(cfg), log=_null_log())
    port_pipe = _port(ladder, {'c': ref_codes}, cfg)
    pd.testing.assert_frame_equal(port_pipe.n_gaps, ref_pipe.n_gaps)
    assert port_pipe.n_gaps.shape[0] == 1
    want = _reference(ladder, lambda: ref_pipe.run_haplotype(RefSeqStore({'t': contig}), 'h1'))
    got = port_pipe.run_haplotype(SeqStore({'t': contig}), 'h1')
    _assert_hap_equal(got, want, 'n gap')
    dels = got.integrated['svindel_del'][0]
    assert ((dels['POS'] <= 30000) & (dels['END'] >= 30500)).any()
    snv = got.integrated['snv_snv'][0]
    assert not ((snv['POS'] >= 30000) & (snv['POS'] < 30500)).any()


@pytest.mark.parametrize('ladder', LADDERS)
def test_contig_split_across_chromosomes(ladder):
    """test_multichrom.py's chimeric contig: one record per chromosome on
    both packages, and the same tables."""
    rng = np.random.default_rng(104)
    chr1 = random_seq(40000, rng)
    chr2 = random_seq(40000, rng)
    chimera = np.concatenate([chr1[5000:25000], chr2[10000:30000]])
    refs = {'chr1': chr1, 'chr2': chr2}
    cfg = {'aligner_min_chain_score': 500}
    want = _reference(ladder, lambda: RefPipeline(
        RefSeqStore(refs), dict(cfg), log=_null_log()).run_haplotype(
            RefSeqStore({'t': chimera}), 'h1'))
    got = _port(ladder, refs, cfg).run_haplotype(SeqStore({'t': chimera}), 'h1')
    _assert_hap_equal(got, want, 'chimera')
    assert set(got.align_qryref['#CHROM']) == {'chr1', 'chr2'}
    assert got.align_qryref.shape[0] == 2


# ------------------------------------------------------------------ resume

def _workspace(base):
    """test_cli_multisample.py's workspace: a 60 kb reference; sample s1
    with two haplotypes, s2 with one and an empty cell."""
    rng = np.random.default_rng(81)
    ref = random_seq(60000, rng)
    ref_write_fasta({'chr1': ref}, str(base / 'ref.fa.gz'))

    def hap(seed):
        rng2 = np.random.default_rng(seed)
        m = Mutator(ref)
        m.snv(10000, rng=rng2)
        m.ins(30000, random_seq(80, rng2))
        return m.finish()

    ref_write_fasta({'s1h1': hap(1)}, str(base / 's1_h1.fa'))
    ref_write_fasta({'s1h2': hap(2)}, str(base / 's1_h2.fa'))
    ref_write_fasta({'s2h1': hap(3)}, str(base / 's2_h1.fa'))
    with open(base / 'assemblies.tsv', 'w') as fh:
        fh.write('NAME\tHAP1\tHAP2\n')
        fh.write(f's1\t{base}/s1_h1.fa\t{base}/s1_h2.fa\n')
        fh.write(f's2\t{base}/s2_h1.fa\t\n')


def _merged_files(run_dir, sample):
    base = os.path.join(run_dir, sample)
    return {name: gzip.open(os.path.join(base, name)).read()
            for name in sorted(os.listdir(base)) if name.startswith('merged_')}


def test_resume_from_artifacts(tmp_path):
    """One CLI run of the port (CPU ladder), then ``run_sample(...,
    resume=True)`` on its run directory: no aligner is built, the merged
    tables and VCF equal the first run's, and the merged tables equal the
    reference's resumed run's."""
    from pav_tpu.config import load_config as ref_load_config
    from pav_tpu_torch.config import load_config

    _workspace(tmp_path)
    haps = {'h1': str(tmp_path / 's1_h1.fa'), 'h2': str(tmp_path / 's1_h2.fa')}
    port_dir = str(tmp_path / 'port_run')
    assert port_main(['--ref', str(tmp_path / 'ref.fa.gz'),
                      '--assemblies', str(tmp_path / 'assemblies.tsv'),
                      '--run-dir', port_dir, '--device', 'cpu',
                      '--set', 'aligner_min_chain_score=300']) == 0
    first_merged = _merged_files(port_dir, 's1')
    first_vcf = _vcf_text(os.path.join(port_dir, 's1.vcf.gz'))
    assert len(first_merged) == 8 and len(first_vcf) > 0

    pipe = Pipeline(str(tmp_path / 'ref.fa.gz'), load_config({'aligner_min_chain_score': 300}),
                    run_dir=port_dir, log=_null_log(), device='cpu')
    got = pipe.run_sample('s1', haps, resume=True)
    assert pipe._aligner is None
    assert _merged_files(port_dir, 's1') == first_merged
    assert _vcf_text(got['vcf']) == first_vcf
    assert got['merged'][('snv_snv', 'pass')].shape[0] >= 1

    ref_dir = str(tmp_path / 'ref_run')
    ref_pipeline_run(str(tmp_path / 'ref.fa.gz'), str(tmp_path / 'assemblies.tsv'),
                     config={'aligner_min_chain_score': 300}, run_dir=ref_dir)
    ref_pipe = RefPipeline(str(tmp_path / 'ref.fa.gz'),
                           ref_load_config({'aligner_min_chain_score': 300}),
                           run_dir=ref_dir, log=_null_log())
    want = ref_pipe.run_sample('s1', haps, resume=True)
    assert ref_pipe._aligner is None
    _assert_merged_equal(got['merged'], want['merged'])
    assert _vcf_text(got['vcf']) == _vcf_text(want['vcf'])
