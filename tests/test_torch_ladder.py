"""The port's CPU class ladder and row-banded DP against pav_tpu's CPU branch.

On a CPU device the port's aligner takes the reference's CPU ladder (fine
pow2 classes, no transposition, row-banded DP through
``dp_kernels.align_band_ref``), as ``pav_tpu`` does on JAX's CPU backend.
Nothing is forced on either side here: the reference runs its own CPU
branch. Held: the same classes for the same segments, bit-identical
row-band tapes, offsets and walker output (``affine_dp._align_batch`` and
``_align_and_trace``), equal alignment tables, and a CLI run of
``python -m pav_tpu_torch --device cpu`` writing the VCF records and stage
tables of ``python -m pav_tpu`` on the verify recipe's 200 kb sample and
on the genome of test_pipeline_e2e.py.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest
import torch

from pav_tpu.__main__ import main as ref_main
from pav_tpu.align.aligner import Aligner as RefAligner
from pav_tpu.align.aligner import core as ref_core
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.ops import affine_dp as ref_affine_dp
from pav_tpu_torch import seqcodec
from pav_tpu_torch.__main__ import main as port_main
from pav_tpu_torch.align.aligner import Aligner
from pav_tpu_torch.align.aligner import core
from pav_tpu_torch.io.fasta import SeqStore, write_fasta
from pav_tpu_torch.ops import affine_dp, dp_kernels
from pav_tpu_torch.pipeline import Pipeline

from helpers import Mutator, random_seq, repeat_rich_ref
from test_torch_pipeline import _genome as e2e_genome

SC = (1, -5, 5, 56, 4, 1)
CPU = torch.device('cpu')


def skill_genome():
    """The verify recipe's sample: 200 kb reference, an SNV, a 300 bp DEL
    and a second SNV, the same contig on both haplotypes."""
    rng = np.random.default_rng(7)
    ref = random_seq(200000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.dele(50000, 300)
    mut.snv(120000, rng=rng)
    hap = mut.finish()
    return ref, hap, hap


GENOMES = {'skill': (skill_genome, {}),
           'e2e': (e2e_genome, {'aligner_min_chain_score': 500})}


# ------------------------------------------------------------ the classes

@pytest.mark.parametrize('m,n', [(0, 5), (10, 12), (12, 10), (16, 40), (100, 90),
                                 (200, 260), (300, 310), (900, 1500), (16, 9000),
                                 (5000, 5000), (40000, 41000)])
def test_cpu_bucket_follows_reference_rules(m, n):
    """``_cpu_bucket`` is the bucketing of the reference's CPU branch
    (``_run_segments``), built here from the reference's own helpers."""
    pow2 = ref_core._bucket_pow2
    m_b, n_b = pow2(m, lo=16), pow2(n, lo=16)
    if max(m_b, n_b) <= 256:
        width_b = min(pow2(2 * abs(m - n) + 17, lo=16) + 1, n_b + 1)
    else:
        width = min(2 * abs(m - n) + ref_core._MIN_WIDTH, n + 1)
        width_b = min(pow2(width, lo=256) + 1, n_b + 1)
    assert core._cpu_bucket(m, n) == (m_b, n_b, width_b)
    assert core._bucket_pow2(m, lo=16) == m_b
    assert core._cpu_shape_batch(m_b, width_b) == max(
        8, min(4096, (128 << 20) // (m_b * width_b)))


def _recorder(cls, log):
    orig = cls.align_batch_async

    def record(self, pairs, width, pad_to=None, pad_batch=None, **kw):
        log.append((tuple(pad_to), int(width), pad_batch,
                    tuple((len(q), len(r)) for q, r in pairs)))
        return orig(self, pairs, width, pad_to=pad_to, pad_batch=pad_batch, **kw)
    return record


@pytest.mark.parametrize('genome', sorted(GENOMES))
def test_cpu_classes_match_reference(monkeypatch, genome):
    """Every DP launch of the port's CPU ladder has the class, band width,
    batch padding and items of the reference's CPU branch, on the segments
    of both genomes; the alignment tables are equal."""
    make, cfg = GENOMES[genome]
    ref, h1, h2 = make()
    want_log, got_log = [], []
    monkeypatch.setattr(ref_affine_dp.BandedAligner, 'align_batch_async',
                        _recorder(ref_affine_dp.BandedAligner, want_log))
    monkeypatch.setattr(affine_dp.BandedAligner, 'align_batch_async',
                        _recorder(affine_dp.BandedAligner, got_log))
    ref_aligner = RefAligner(RefSeqStore({'chr1': ref}), dict(cfg))
    aligner = Aligner(SeqStore({'chr1': ref}), dict(cfg), device='cpu')
    assert aligner.ladder == 'cpu'
    for hap, tig in (('h1', h1), ('h2', h2)):
        want = ref_aligner.align_store(RefSeqStore({'t': tig}), hap)
        got = aligner.align_store(SeqStore({'t': tig}), hap)
        pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                      want.reset_index(drop=True))
    assert got_log and got_log == want_log


# ----------------------------------------------------------- the row band

def _band_cases():
    """(q, r, max_m, max_n, width) of test_affine_dp.py's banded cases at the
    width they pass: the large insertion, the leading deletion, the band
    escape (opposing gaps) at widths 17 and 33; and a band exit, 10 query
    bases spread over 250 reference bases in a 17-column band, whose rows'
    windows do not overlap, so the walk leaves the band (err)."""
    rng = np.random.default_rng(10)
    r = random_seq(300, rng)
    ins = random_seq(120, rng)
    q = np.concatenate([r[:150], ins, r[150:]])
    cases = {'large insertion': (q, r, 512, 512, 2 * 120 + 129)}
    rng = np.random.default_rng(12)
    q = random_seq(200, rng)
    r = np.concatenate([random_seq(90, rng), q])
    cases['leading deletion'] = (q, r, 256, 512, 2 * 90 + 129)
    rng = np.random.default_rng(41)
    s1 = rng.integers(0, 4, 60).astype(np.uint8)
    s2 = rng.integers(0, 4, 60).astype(np.uint8)
    ins = rng.integers(0, 4, 40).astype(np.uint8)
    dele = rng.integers(0, 4, 40).astype(np.uint8)
    q = np.concatenate([s1, ins, s2])
    r = np.concatenate([s1, dele, s2])
    cases['band escape w17'] = (q, r, 256, 256, 17)
    cases['band escape w33'] = (q, r, 256, 256, 33)
    rng = np.random.default_rng(44)
    r = random_seq(250, rng)
    cases['band exit'] = (r[np.sort(rng.choice(250, 10, replace=False))], r, 16, 256, 17)
    return cases


BAND_CASES = _band_cases()


def _padded(q, r, max_m, max_n, B=8, seed=0):
    """Item 0 is the case; items 1.. are random pairs inside the class
    (lengths 0 included), as a launch pads its batch."""
    rng = np.random.default_rng(seed)
    qp = np.full((B, max_m), 4, np.int8)
    rp = np.full((B, max_n), 4, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        qq, rr = (q, r) if b == 0 else (
            random_seq(int(rng.integers(0, max_m + 1)), rng),
            random_seq(int(rng.integers(0, max_n + 1)), rng))
        qp[b, :len(qq)], rp[b, :len(rr)] = qq, rr
        m[b], n[b] = len(qq), len(rr)
    return qp, rp, m, n


@pytest.mark.parametrize('case', sorted(BAND_CASES))
def test_align_band_ref_matches_align_batch(case):
    """Tape and offsets bit-identical to ``affine_dp._align_batch``, and the
    walked fused buffer (codes, path length, err) to ``_align_and_trace``
    on the reference's CPU kernel."""
    q, r, max_m, max_n, width = BAND_CASES[case]
    arrays = _padded(q, r, max_m, max_n)
    _, tb_want, offs_want = ref_affine_dp._align_batch(*arrays, max_m, width, *SC)
    fused_want = np.asarray(ref_affine_dp._align_and_trace(
        *arrays, max_m, width, *SC, backend_kind='xla'))
    t = [torch.from_numpy(a) for a in arrays]
    tb, offs = dp_kernels.align_band_ref(*t, width, SC)
    assert tb.shape == (8, max_m, width) and offs.dtype == torch.int32
    assert np.array_equal(tb.numpy(), np.asarray(tb_want))
    assert np.array_equal(offs.numpy(), np.asarray(offs_want))
    fused = dp_kernels.traceback(tb, offs, *t, False)
    assert np.array_equal(fused.numpy(), fused_want)
    assert np.array_equal(affine_dp.align_and_trace(*t, max_m, width,
                                                    affine_dp.DEFAULT_SCORING,
                                                    band='row').numpy(), fused_want)
    if case == 'band exit':
        assert fused[0, -1] == 1, 'the walk must leave the band'


def test_row_band_cigars_match_reference():
    """BandedAligner with band='row' returns the reference's CIGARs, with
    None for the items that left the band."""
    q, r, _, _, _ = BAND_CASES['band exit']
    rng = np.random.default_rng(3)
    pairs = [(q, r)] + [(random_seq(int(rng.integers(0, 16)), rng),
                         random_seq(int(rng.integers(0, 256)), rng)) for _ in range(6)]
    # width 16 launches at 17 columns (the next power of two, plus one)
    want = ref_affine_dp.BandedAligner().align_batch(pairs, width=16, pad_to=(16, 256))
    got = affine_dp.BandedAligner(device='cpu').align_batch(pairs, width=16,
                                                            pad_to=(16, 256), band='row')
    assert got[0] is None and want[0] is None
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ---------------------------------------------------------- the aligner

def _repeat_rich():
    rng = np.random.default_rng(3)
    ref, _ = repeat_rich_ref(250000, rng)
    mut = Mutator(ref)
    pos = 2000
    while pos < len(ref) - 20000:
        x = rng.random()
        if x < 0.8:
            if ref[pos] < 4:
                mut.snv(pos, rng=rng)
        else:
            ln = int(rng.integers(1, 40)) if x < 0.97 else int(rng.integers(50, 1200))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        pos = max(pos + int(rng.integers(900, 2000)), mut.cursor + 200)
    return ref, mut.finish(), {'aligner_min_chain_score': 1000}


def _indels():
    rng = np.random.default_rng(33)
    ref = random_seq(400000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.ins(40000, random_seq(800, rng))
    mut.dele(80000, 700)
    mut.ins(120000, random_seq(30, rng))
    mut.dele(160000, 25)
    mut.snv(200000, rng=rng)
    return ref, mut.finish(), {'aligner_min_chain_score': 500}


@pytest.mark.parametrize('genome', ['indels', 'repeat_rich'])
def test_aligner_cpu_ladder_matches_reference(genome):
    """``Aligner(ladder='cpu')`` writes the table of the reference's
    ``align_store`` on its CPU branch: test_torch_aligner.py's genomes,
    whose repeat-rich one runs a row-banded class."""
    ref, hap, cfg = {'indels': _indels, 'repeat_rich': _repeat_rich}[genome]()
    want = RefAligner(RefSeqStore({'chr1': ref}), cfg).align_store(
        RefSeqStore({'c1': hap}), 'h1')
    affine_dp.stats_reset()
    got = Aligner(SeqStore({'chr1': ref}), cfg, device='cpu',
                  ladder='cpu').align_store(SeqStore({'c1': hap}), 'h1')
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))
    banded = [k for k in affine_dp.STATS['classes'] if k[2] < k[1] + 1]
    if genome == 'repeat_rich':
        assert banded, 'no row-banded class ran'
    assert dp_kernels.LAUNCHES == {'full': 0, 'wave': 0, 'band': 0, 'traceback': 0}


# ---------------------------------------------------------------- the CLI

def _run_files(run_dir):
    out = {}
    for root, _, files in os.walk(run_dir):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, run_dir)] = path
    return out


def _content(path):
    with open(path, 'rb') as fh:
        data = fh.read()
    if path.endswith('.tbi'):
        return b''      # a tabix index: the VCF text is compared instead
    data = gzip.decompress(data) if data[:2] == b'\x1f\x8b' else data
    return b'\n'.join(line for line in data.splitlines()
                      if not line.startswith(b'##fileDate'))


@pytest.mark.parametrize('genome', sorted(GENOMES))
def test_cli_matches_unforced_reference(tmp_path, genome):
    """``python -m pav_tpu_torch --device cpu`` against ``python -m
    pav_tpu`` on JAX's CPU backend, neither forced: the same VCF records
    (apart from fileDate) and the same stage tables, file for file; the
    port adds only its timings.tsv and spans.tsv."""
    make, cfg = GENOMES[genome]
    ref, h1, h2 = make()
    write_fasta({'chr1': seqcodec.decode(ref)}, str(tmp_path / 'ref.fa'))
    write_fasta({'tig1': seqcodec.decode(h1)}, str(tmp_path / 'h1.fa'))
    write_fasta({'tig2': seqcodec.decode(h2)}, str(tmp_path / 'h2.fa'))
    (tmp_path / 'asm.tsv').write_text(
        f'NAME\tHAP_h1\tHAP_h2\nS1\t{tmp_path / "h1.fa"}\t{tmp_path / "h2.fa"}\n')
    common = ['--ref', str(tmp_path / 'ref.fa'), '--assemblies', str(tmp_path / 'asm.tsv')]
    for key, val in cfg.items():
        common += ['--set', f'{key}={val}']
    assert ref_main(common + ['--run-dir', str(tmp_path / 'ref')]) == 0
    assert port_main(common + ['--run-dir', str(tmp_path / 'port'), '--device', 'cpu']) == 0
    want = _run_files(tmp_path / 'ref')
    got = _run_files(tmp_path / 'port')
    assert set(got) - set(want) == {os.path.join('S1', f) for f in ('timings.tsv', 'spans.tsv')}
    assert set(want) <= set(got)
    assert sum(p.endswith('.tsv.gz') for p in want) >= 20
    for rel, path in want.items():
        assert _content(got[rel]) == _content(path), rel
    with gzip.open(tmp_path / 'port' / 'S1.vcf.gz', 'rt') as fh:
        assert sum(1 for line in fh if not line.startswith('#')) >= 3


# ------------------------------------------------------------ the switch

def test_ladder_resolves_by_device():
    store = SeqStore({'chr1': np.zeros(100, dtype=np.uint8)})
    assert core.resolve_ladder(None, CPU) == 'cpu'
    assert core.resolve_ladder(None, torch.device('cuda', 0)) == 'accel'
    assert core.resolve_ladder('accel', CPU) == 'accel'
    with pytest.raises(ValueError, match='ladder'):
        core.resolve_ladder('tpu', CPU)
    with pytest.raises(ValueError, match='row band'):
        core.resolve_ladder('cpu', torch.device('cuda', 0))
    assert Aligner(store, {}, device='cpu').ladder == 'cpu'
    assert Aligner(store, {}, device='cpu', ladder='accel').ladder == 'accel'
    assert Pipeline(store, {}, device='cpu').aligner.ladder == 'cpu'
    assert Pipeline(store, {}, device='cpu', ladder='accel').aligner.ladder == 'accel'


@pytest.mark.parametrize('call', ['align_band_ref', 'traceback'])
def test_row_band_never_reaches_a_card(monkeypatch, call):
    """With the inputs taken for CUDA tensors, the row-band DP and the walk
    of a row-banded tape raise before any kernel library is asked for; no
    plain version runs and no launch is counted."""
    monkeypatch.setattr(dp_kernels, '_check_seqs', lambda q, r, m, n: torch.device('cuda', 0))
    monkeypatch.setattr(dp_kernels, '_check', lambda *a: None)
    monkeypatch.setattr(dp_kernels._build, 'lib', lambda: (_ for _ in ()).throw(
        AssertionError('the kernel library was asked for')))

    def plain(*a, **k):
        raise AssertionError('plain version ran for a CUDA tensor')
    monkeypatch.setattr(dp_kernels, 'traceback_ref', plain)
    q = torch.zeros((2, 16), dtype=torch.int8)
    r = torch.zeros((2, 64), dtype=torch.int8)
    m = torch.full((2,), 16, dtype=torch.int32)
    before = dict(dp_kernels.LAUNCHES)
    with pytest.raises(ValueError, match='row band'):
        if call == 'align_band_ref':
            dp_kernels.align_band_ref(q, r, m, m, 17, SC)
        else:
            dp_kernels.traceback(torch.zeros((2, 16, 17), dtype=torch.uint8),
                                 torch.zeros((2, 16), dtype=torch.int32), q, r, m, m, False)
    assert dp_kernels.LAUNCHES == before
