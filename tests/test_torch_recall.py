"""The port held to planted truth on the CPU, at tests/test_recall.py's floors.

The genome is bench.py's chromosome-scale generator (``build_genome``, seed
28, the seed of chip_smoke.py's phase 11) without its cache, at the
smallest size where it plants its inversion and every class has at least
20 truth events (200 kb: 206 SNVs, 27 insertions, 27 deletions, one
inversion). Held here:

* the port's VCF meets the floors, on the CPU ladder and on the CUDA path's
  classes (``ladder='accel'``, the kernels' plain versions), judged by
  ``pav_tpu_torch.synth.truth_report`` (what chip_smoke.py's phase 11 runs
  on the card),
  which reads the VCF as tests/test_recall.py reads the merged tables;
* the port's merged tables equal ``pav_tpu``'s, CPU ladder against the
  unforced reference;
* the port's generators and truth table (``pav_tpu_torch.synth``, which
  chip_smoke.py runs) equal bench.py's and tests/test_recall.py's.
"""

import gzip
import io

import numpy as np
import pandas as pd
import pytest

import bench
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch import eval as ev
from pav_tpu_torch import synth
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.pipeline import Pipeline

from test_recall import calls_to_df, truth_to_df

REF_LEN = 200_000
SEED = 28
CONFIG = {'aligner_min_chain_score': 1000}


def _build_genome(ref_len, seed):
    """bench.build_genome with its cache out of the way: no file is read
    or written, so the truth always comes back."""
    def no_cache(*a, **k):
        raise OSError('no genome cache')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench.np, 'load', no_cache)
        mp.setattr(bench.np, 'savez', lambda *a, **k: None)
        return bench.build_genome(ref_len, seed)


@pytest.fixture(scope='module')
def genome():
    ref, h1, h2, t1, t2 = _build_genome(REF_LEN, SEED)
    assert t1 is not None and t2 is not None
    return ref, h1, h2, t1 + t2


def _run_port(genome, run_dir, ladder):
    ref, h1, h2, _ = genome
    return Pipeline(SeqStore({'chr1': ref}), dict(CONFIG), run_dir=str(run_dir), device='cpu',
                    ladder=ladder, log=io.StringIO()).run_sample(
        'r', {'h1': SeqStore({'c1': h1}), 'h2': SeqStore({'c2': h2})})


@pytest.fixture(scope='module')
def port_cpu(genome, tmp_path_factory):
    return _run_port(genome, tmp_path_factory.mktemp('cpu'), None)


def test_genome_has_every_class(genome):
    truth = synth.truth_to_df(genome[3]).drop_duplicates(
        subset=['POS', 'SVTYPE', 'SVLEN', 'ALT'])
    counts = truth['SVTYPE'].value_counts()
    assert counts['INV'] == 1
    assert min(counts['SNV'], counts['INS'], counts['DEL']) >= 20, counts


@pytest.mark.parametrize('ladder', ['cpu', 'accel'])
def test_port_meets_recall_floors(genome, port_cpu, tmp_path, ladder):
    """The VCF meets every floor of tests/test_recall.py, as phase 11 holds
    the card's VCF; the report equals test_recall.py's concordance of the
    merged tables."""
    res = port_cpu if ladder == 'cpu' else _run_port(genome, tmp_path, 'accel')
    rep, misses = synth.truth_report(res['vcf'], genome[3])
    assert misses == [], rep
    truth = truth_to_df(genome[3]).drop_duplicates(subset=['POS', 'SVTYPE', 'SVLEN', 'ALT'])
    merged = ev.concordance(truth, calls_to_df(res['merged'])).set_index('SVTYPE')
    pd.testing.assert_frame_equal(rep, merged)


def test_truth_report_finds_a_miss(genome, port_cpu, tmp_path):
    """A VCF without every fifth SNV and without its inversion misses the
    SNV recall floor and the INV floor."""
    with gzip.open(port_cpu['vcf'], 'rt') as fh:
        lines = fh.read().splitlines(keepends=True)
    kept, snvs = [], 0
    for line in lines:
        fields = line.split('\t')
        if not line.startswith('#') and len(fields[3]) == 1 and len(fields[4]) == 1:
            snvs += 1
            if snvs % 5 == 0:
                continue
        if not line.startswith('#') and 'SVTYPE=INV' in line:
            continue
        kept.append(line)
    path = tmp_path / 'cut.vcf.gz'
    with gzip.open(path, 'wt') as fh:
        fh.writelines(kept)
    rep, misses = synth.truth_report(str(path), genome[3])
    assert [m.split()[:2] for m in misses] == [['SNV', 'RECALL'], ['INV', 'RECALL']], rep


def test_merged_tables_equal_reference(genome, port_cpu):
    """The port on the CPU ladder against ``pav_tpu`` unforced on JAX's CPU
    backend: the same merged tables."""
    ref, h1, h2, _ = genome
    want = RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG), log=io.StringIO()).run_sample(
        'r', {'h1': RefSeqStore({'c1': h1}), 'h2': RefSeqStore({'c2': h2})},
        write_vcf=False)['merged']
    got = port_cpu['merged']
    assert sorted(got) == sorted(want)
    assert sum(df.shape[0] for df in want.values()) >= 250
    for key in want:
        pd.testing.assert_frame_equal(got[key].reset_index(drop=True),
                                      want[key].reset_index(drop=True), obj=str(key))


def test_chip_smoke_generator_equals_bench():
    """synth.bench_genome at its default SV spectrum, truth included,
    replays bench.py's build_genome (tests/helpers.py's Mutator)."""
    got = synth.bench_genome(REF_LEN, SEED)
    want = _build_genome(REF_LEN, SEED)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3] and got[4] == want[4]
    assert any(t['type'] == 'INV' for t in got[4])


class _Captured(Exception):
    pass


def test_chip_smoke_repeat_genome_equals_bench(monkeypatch):
    """bench.py's repeat_child, stopped at its first run_sample, builds the
    same reference and haplotype from tests/helpers.py as synth.repeat_genome
    at the same length and seed (bench.py's SEED + 7, chip_smoke.py's phase
    5 seed)."""
    import pav_tpu.pipeline
    import pav_tpu.runtime
    seen = {}

    class Pipeline:
        def __init__(self, ref_store, config, log=None):
            seen['ref'] = ref_store.get('chr1')

        def run_sample(self, name, haps, write_vcf=True):
            seen['hap'] = haps['h1'].get('rtig1')
            raise _Captured()
    monkeypatch.setattr(pav_tpu.pipeline, 'Pipeline', Pipeline)
    monkeypatch.setattr(pav_tpu.runtime, 'enable_compile_cache', lambda: None)
    monkeypatch.setattr(pav_tpu.runtime, 'retain_heap', lambda *a: None)
    monkeypatch.setattr(bench, 'REF_MBP', 0.3)
    with pytest.raises(_Captured):
        bench.repeat_child()
    rref, rhap = synth.repeat_genome(150_000, bench.SEED + 7)
    assert len(rhap) > 100_000
    assert np.array_equal(rref, seen['ref']) and np.array_equal(rhap, seen['hap'])


def test_chip_smoke_truth_table_equals_test_recall(genome):
    pd.testing.assert_frame_equal(synth.truth_to_df(genome[3]), truth_to_df(genome[3]))
