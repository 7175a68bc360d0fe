"""A sample of two chromosomes, GRCh38 chr21 + chr22 cut as the HPRC
assemblies are (the benchmark's ``hprc_chr21_chr22.pub_mix``), through the
benchmark's harness on the CPU at 1/200 of its length
(``benchmark/tests/cpu_harness.py``).

One run is judged ``correct``; its spans show the diploid merge sharded
over both chromosomes and the index built over both; the benchmark's
readers of the merge and of memory read it. Every tier the merge shards
equals, record for record, one unsharded ``merge_haplotypes`` on the same
calls. A run whose second chromosome batch loses its merged rows reads
``correct`` false.
"""

import csv
import importlib.util
import io
import json
import os

import pandas as pd
import pytest

from pav_tpu_torch import pipeline
from pav_tpu_torch.call.batching import merge_batch_table
from pav_tpu_torch.call.integrate import get_merge_params, merge_haplotypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'hprc_chr21_chr22.pub_mix'
SEED = 2**31 + 4242
CHROMS = {'chr21', 'chr22'}
NEW_READERS = ('merge.shard_ms_per_mbp', 'merge.critical_share', 'memory.sample_rise_gib')


def _cpu_harness():
    path = os.path.join(ROOT, 'benchmark', 'tests', 'cpu_harness.py')
    spec = importlib.util.spec_from_file_location('cpu_harness_two_chromosomes', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts(row):
    return dict(kv.split('=', 1) for kv in row['COUNTS'].split(',')) if row['COUNTS'] else {}


def _measure(mp, fault=None):
    """One run of the cell at 1/200 on the CPU. Returns (result, readings,
    {sample: spans rows}, [(merge inputs, merged)] of the window)."""
    run = _cpu_harness().harness(mp)
    # This suite's conftest loads JAX for the reference's tests; the
    # harness's own tests (benchmark/tests) hold the import boundary.
    mp.setattr(run, 'forbidden_modules', lambda names=None: [])
    rows, merges = {}, []
    judge = run.judge

    def keep_spans(workdir, done, *args, **kw):
        for s in done:
            path = os.path.join(s['run_dir'], s['name'], 'spans.tsv')
            with open(path, newline='') as fh:
                rows[s['name']] = list(csv.DictReader(fh, delimiter='\t'))
        return judge(workdir, done, *args, **kw)

    merge_all = pipeline.Pipeline._merge_all

    def kept_merge(self, asm_name, hap_results, hap_list, cfg):
        merged = merge_all(self, asm_name, hap_results, hap_list, cfg)
        if asm_name != 'WARMUP':
            merges.append(((dict(self.ref_store.fai()), hap_results, hap_list, cfg), merged))
        return merged

    mp.setattr(run, 'judge', keep_spans)
    mp.setattr(pipeline.Pipeline, '_merge_all', kept_merge)
    if fault is not None:
        window = run.run_window

        def faulty_window(*args, **kw):
            fault(mp)
            return window(*args, **kw)

        mp.setattr(run, 'run_window', faulty_window)
    log = io.StringIO()
    res = run.measure(CELL, SEED, 1, False, log=log)
    said = next(line for line in log.getvalue().splitlines()
                if line.startswith('benchmark: readings '))
    return res, json.loads(said[len('benchmark: readings '):]), rows, merges


@pytest.fixture(scope='module')
def sound():
    mp = pytest.MonkeyPatch()
    try:
        yield _measure(mp)
    finally:
        mp.undo()


def test_two_chromosome_sample_is_correct(sound):
    res, _, rows, _ = sound
    assert res['correct'] is True and res['failed'] == 0 and res['attempted'] == 1
    for name, c in res['checks'].items():
        assert c['value'] <= c['limit'], name
    assert list(rows) == ['IND1']


def test_merge_shards_over_both_chromosomes(sound):
    """Some callset tiers hold calls on both chromosomes and shard: one
    ``merge.shard`` a chromosome, under its ``merge.job``."""
    _, _, rows, _ = sound
    rows = rows['IND1']
    by_id = {r['ID']: r for r in rows}
    shards = [r for r in rows if r['NAME'] == 'merge.shard']
    assert {_counts(r)['chroms'] for r in shards} == CHROMS
    jobs = [r for r in rows if r['NAME'] == 'merge.job']
    assert len(jobs) == 8
    sharded = [j for j in jobs if _counts(j)['shards'] == '2']
    assert {_counts(j)['type'] for j in sharded} >= {'snv_snv', 'svindel_ins', 'svindel_del'}
    for r in shards:
        assert by_id[r['PARENT']]['NAME'] == 'merge.job'
        assert int(_counts(r)['calls']) > 0


def test_index_spans_both_chromosomes(sound):
    _, _, rows, _ = sound
    index = _counts(next(r for r in rows['IND1'] if r['NAME'] == 'IND1:index'))
    assert index['chroms'] == '2' and index['on'] == 'cpu'
    assert int(index['minimizers']) > 0 and int(index['index_bytes']) > 0


def test_new_readers_read_the_run(sound):
    _, said, _, _ = sound
    for name in NEW_READERS:
        assert isinstance(said[name], float), (name, said[name])
    assert said['merge.shard_ms_per_mbp'] > 0
    assert 0 < said['merge.critical_share'] <= 100
    assert said['memory.sample_rise_gib'] >= 0


def test_sharded_merge_equals_one_unsharded_merge(sound):
    """``_merge_all``'s sharded tiers against ``merge_haplotypes`` run once on
    the same calls with no ``subset_chrom``: the same records, in order."""
    _, _, _, merges = sound
    assert len(merges) == 1
    (fai, hap_results, hap_list, cfg), merged = merges[0]
    assert merge_batch_table(fai)['BATCH'].to_dict() == {'chr22': 0, 'chr21': 1}
    compared = 0
    for (varsvtype, tier), got in merged.items():
        tier_i = ('pass', 'fail').index(tier)
        beds = [hap_results[h].integrated[varsvtype][tier_i] for h in hap_list]
        if not CHROMS <= {c for bed in beds if bed.shape[0] for c in bed['#CHROM'].unique()}:
            continue
        want = merge_haplotypes(beds, [hap_results[h].callable for h in hap_list], hap_list,
                                get_merge_params(varsvtype.split('_')[1], cfg))
        want = want.sort_values(['#CHROM', 'POS', 'END', 'ID'])
        assert got.shape[0] > 0 and set(got['#CHROM']) == CHROMS
        # The concatenation gives the index pandas' string dtype, the
        # single merge an object one: the labels and every record agree.
        pd.testing.assert_frame_equal(got, want, check_index_type=False)
        compared += 1
    assert compared >= 3


def _second_shard_dropped(mp):
    """Every sharded tier loses the rows of its second chromosome batch,
    chr21's (``merge_batch_table`` puts the longer chr22 first)."""
    good = pipeline.merge_haplotypes

    def dropped(bed_list, callable_list, hap_list, strategy, subset_chrom=None):
        out = good(bed_list, callable_list, hap_list, strategy, subset_chrom=subset_chrom)
        return out.iloc[0:0] if subset_chrom == {'chr21'} else out

    mp.setattr(pipeline, 'merge_haplotypes', dropped)


def test_second_shard_dropped_fails_the_check():
    mp = pytest.MonkeyPatch()
    try:
        res, _, rows, _ = _measure(mp, fault=_second_shard_dropped)
    finally:
        mp.undo()
    assert res['correct'] is False
    assert res['checks']['missed_share']['value'] > res['checks']['missed_share']['limit']
    assert any(r['NAME'] == 'merge.shard' for r in rows['IND1'])
