"""The torch port end to end on the CPU against the JAX reference.

The genome is the one of test_pipeline_e2e.py (SNVs, indels, a 250 bp INS,
a 400 bp DEL and a 4 kb inversion, so the density scan runs). The reference
runs on its accelerator branch (the class ladder, transposed DP, resident
gather and wavefront band kernel the port implements), forced on the CPU
backend as test_aligner.py does; the port runs with device='cpu', i.e. the
plain versions of its kernels, and ladder='accel', the classes of its CUDA
path. Held: identical VCF text (apart from the fileDate line), identical
per-haplotype stage artifact tables (pipeline.py _HAP_ARTIFACTS) and
identical merged tables. The CLI case runs ``--device cpu``, which takes the
CPU ladder, against the reference on its own (unforced) CPU branch.
"""

import contextlib
import gzip
import os

import jax
import numpy as np
import pandas as pd
import pytest

from pav_tpu import seqcodec as ref_seqcodec
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import _HAP_ARTIFACTS
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch import __main__ as cli
from pav_tpu_torch import seqcodec
from pav_tpu_torch.io.fasta import SeqStore, write_fasta
from pav_tpu_torch.ops import dp_kernels
from pav_tpu_torch.pipeline import Pipeline

from helpers import Mutator, random_seq

CONFIG = {'aligner_min_chain_score': 500, 'artifacts': 'full'}


@contextlib.contextmanager
def reference_accel_branch():
    """Run the JAX reference on its accelerator branch on the CPU backend."""
    from pav_tpu.align.aligner import core as core_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, 'default_backend', lambda: 'fake-accel')
        mp.setattr(core_mod, '_shape_batch', lambda m_b, w_b, n_b=None: 16)
        mp.setenv('PAV_TPU_PALLAS', '0')
        yield


def _genome():
    rng = np.random.default_rng(71)
    ref = random_seq(150000, rng)
    m1 = Mutator(ref)
    m1.snv(10000, rng=rng)
    m1.ins(20000, random_seq(12, rng))
    m1.dele(30000, 7)
    m1.ins(50000, random_seq(250, rng))
    m1.dele(70000, 400)
    m1.snv(90000, rng=rng)
    h1 = m1.finish()
    m2 = Mutator(ref)
    m2.snv(10000, alt=int(m1.truth[0]['alt'] == 'A'), rng=rng)
    m2.truth[-1]['alt'] = m1.truth[0]['alt']
    m2.pieces[-1] = np.array([ref_seqcodec.encode(m1.truth[0]['alt'])[0]], dtype=np.uint8)
    m2.ins(50000, ref_seqcodec.encode(m1.truth[3]['seq']))
    m2.snv(60000, rng=rng)
    m2.inv(100000, 4000)
    h2 = m2.finish()
    return ref, h1, h2


def _vcf_text(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith('##fileDate')]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    ref, h1, h2 = _genome()
    ref_haps = {'h1': RefSeqStore({'tig1_1': h1}), 'h2': RefSeqStore({'tig2_1': h2})}
    ref_dir = str(tmp_path_factory.mktemp('ref_run'))
    with reference_accel_branch():
        ref_res = RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG),
                              run_dir=ref_dir).run_sample('samp1', ref_haps)
    dp_kernels.launches_reset()
    port_dir = str(tmp_path_factory.mktemp('port_run'))
    haps = {'h1': SeqStore({'tig1_1': h1}), 'h2': SeqStore({'tig2_1': h2})}
    port_res = Pipeline(SeqStore({'chr1': ref}), dict(CONFIG), run_dir=port_dir,
                        device='cpu', ladder='accel').run_sample('samp1', haps)
    return (ref, h1, h2), ref_res, port_res, ref_dir, port_dir


@pytest.fixture(scope='module')
def reference_cpu_vcf(tmp_path_factory):
    """The reference's VCF of the genome on its own CPU branch (unforced)."""
    ref, h1, h2 = _genome()
    ref_haps = {'h1': RefSeqStore({'tig1_1': h1}), 'h2': RefSeqStore({'tig2_1': h2})}
    run_dir = str(tmp_path_factory.mktemp('ref_cpu_run'))
    return RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG),
                       run_dir=run_dir).run_sample('samp1', ref_haps)['vcf']


def test_port_vcf_matches_reference(runs):
    _, ref_res, port_res, _, _ = runs
    want = _vcf_text(ref_res['vcf'])
    got = _vcf_text(port_res['vcf'])
    assert sum(1 for line in got if not line.startswith('#')) >= 7
    assert any('<INV>' in line for line in got), 'the inversion must be called'
    assert got == want


@pytest.mark.parametrize('hap', ['h1', 'h2'])
def test_port_stage_artifacts_match_reference(runs, hap):
    _, ref_res, port_res, _, _ = runs
    for _, attr in _HAP_ARTIFACTS:
        want = getattr(ref_res['haps'][hap], attr)
        got = getattr(port_res['haps'][hap], attr)
        pd.testing.assert_frame_equal(got, want, obj=f'{hap}.{attr}')


def test_port_merged_tables_match_reference(runs):
    _, ref_res, port_res, _, _ = runs
    assert set(port_res['merged']) == set(ref_res['merged'])
    for key, want in ref_res['merged'].items():
        pd.testing.assert_frame_equal(port_res['merged'][key], want, obj=str(key))


def _run_files(run_dir):
    out = {}
    for root, _, files in os.walk(run_dir):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, run_dir)] = path
    return out


def _content(path):
    """File bytes; gzip and BGZF files decompressed (their headers may hold
    a time stamp)."""
    with open(path, 'rb') as fh:
        data = fh.read()
    return gzip.decompress(data) if data[:2] == b'\x1f\x8b' else data


def test_port_side_outputs_match_reference(runs):
    """artifacts=full: the port writes the reference's files (BAM, BigBed
    tracks, inversion density tables, figures) with the same contents; the
    port adds only its per-sample timings.tsv and spans.tsv."""
    *_, ref_dir, port_dir = runs
    want = _run_files(ref_dir)
    got = _run_files(port_dir)
    assert set(got) - set(want) == {os.path.join('samp1', f) for f in ('timings.tsv', 'spans.tsv')}
    assert set(want) <= set(got)
    assert any(p.endswith('.bam') for p in want)
    assert any(p.endswith('.bb') for p in want)
    for rel, path in want.items():
        if rel.endswith('.png') or rel.endswith('.vcf.gz'):
            continue    # figures: checked by name; VCF: by text above
        assert _content(got[rel]) == _content(path), rel


def test_port_runs_its_dp_paths(runs):
    """The port's main path went through the full-width DP and the walker
    (on the CPU: their plain versions, which count no kernel launch)."""
    from pav_tpu_torch.ops import affine_dp
    assert affine_dp.STATS['launches'] > 0
    assert dp_kernels.LAUNCHES == {'full': 0, 'wave': 0, 'band': 0, 'traceback': 0}


def test_cli_matches_reference(runs, reference_cpu_vcf, tmp_path):
    """``--device cpu`` takes the CPU ladder: the VCF of the reference on
    its own CPU branch."""
    (ref, h1, h2), _, _, _, _ = runs
    write_fasta({'chr1': seqcodec.decode(ref)}, str(tmp_path / 'ref.fa'))
    write_fasta({'tig1_1': seqcodec.decode(h1)}, str(tmp_path / 'h1.fa'))
    write_fasta({'tig2_1': seqcodec.decode(h2)}, str(tmp_path / 'h2.fa'))
    (tmp_path / 'asm.tsv').write_text(
        f'NAME\tHAP_h1\tHAP_h2\nsamp1\t{tmp_path / "h1.fa"}\t{tmp_path / "h2.fa"}\n')
    run_dir = tmp_path / 'run'
    rc = cli.main(['--ref', str(tmp_path / 'ref.fa'),
                   '--assemblies', str(tmp_path / 'asm.tsv'),
                   '--run-dir', str(run_dir), '--device', 'cpu',
                   '--set', 'aligner_min_chain_score=500'])
    assert rc == 0
    assert _vcf_text(str(run_dir / 'samp1.vcf.gz')) == _vcf_text(reference_cpu_vcf)
    assert os.path.isfile(run_dir / 'samp1' / 'h2' / 'sv_inv.tsv.gz')


def test_cli_retains_heap_before_any_work(monkeypatch):
    """The CLI sets the reference's heap retention (pav_tpu/__main__.py
    calls runtime.retain_heap(0) first) once, before the pipeline runs,
    through the port's own copy of ``runtime.retain_heap``."""
    import pav_tpu_torch.pipeline
    import pav_tpu_torch.runtime
    calls = []
    monkeypatch.setattr(pav_tpu_torch.runtime, 'retain_heap',
                        lambda *a, **k: calls.append(('retain_heap', a, k)))
    monkeypatch.setattr(pav_tpu_torch.pipeline, 'run',
                        lambda *a, **k: calls.append(('run',)) or {})
    assert cli.main(['--ref', 'r.fa', '--assemblies', 'a.tsv',
                     '--device', 'cpu']) == 0
    assert calls == [('retain_heap', (0,), {}), ('run',)]


def test_profile_dir_writes_trace(tmp_path):
    """--profile-dir maps to torch.profiler (one tiny sample)."""
    rng = np.random.default_rng(5)
    ref = random_seq(30000, rng)
    mut = Mutator(ref)
    mut.snv(8000, rng=rng)
    mut.dele(15000, 40)
    write_fasta({'chr1': seqcodec.decode(ref)}, str(tmp_path / 'ref.fa'))
    write_fasta({'tig1': seqcodec.decode(mut.finish())}, str(tmp_path / 'h1.fa'))
    (tmp_path / 'asm.tsv').write_text(f'NAME\tHAP_h1\ns1\t{tmp_path / "h1.fa"}\n')
    prof = tmp_path / 'prof'
    rc = cli.main(['--ref', str(tmp_path / 'ref.fa'),
                   '--assemblies', str(tmp_path / 'asm.tsv'),
                   '--run-dir', str(tmp_path / 'run'), '--device', 'cpu',
                   '--set', 'aligner_min_chain_score=500',
                   '--profile-dir', str(prof)])
    assert rc == 0
    assert (prof / 'trace.json').stat().st_size > 0
