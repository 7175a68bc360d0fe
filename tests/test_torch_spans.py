"""The host spans of a CLI run (``pav_tpu_torch.spans``) and the benchmark's
readers of them.

The 200 kb diploid sample of ``test_torch_profile.py``, with h2 cut into two
contigs so that its planning pool runs on threads, goes through the CLI on
the CPU once, inside a CPU ``torch.profiler`` (which records the thread that
opened it). The run writes ``spans.tsv`` beside ``timings.tsv``; the tests
hold the spans to the timings, the threads, the pools, the profiler's clock
and the row budget, and run the four readers in ``benchmark/layers`` that
read them on a record of the run.
"""

import csv
import importlib.util
import os
import sys
import threading
import time

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pav_tpu_torch import __main__ as cli
from pav_tpu_torch import spans
from pav_tpu_torch.align.aligner import core
from pav_tpu_torch.parallel import pools

from helpers import write_two_hap_sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAP_STAGES = ['align', 'trim', 'depth', 'cigar_call', 'largesv', 'inv_scan', 'integrate']
STAGES = ([(f'S1/{hap}', st) for hap in ('h1', 'h2') for st in HAP_STAGES]
          + [('S1', st) for st in ('merge', 'vcf', 'artifacts')])
MAIN_SPANS = ['run:reference', 'S1:load', 'S1:index', 'S1:haplotypes', 'S1:merge', 'S1:vcf',
              'S1:artifacts']
# Each reader and the range its reading must lie in on this run.
READERS = {'pipeline.load_ms_per_mbp': (0.0, 1e6), 'align.index_ms_per_mbp': (0.0, 1e6),
           'align.pool_wait_share': (0.0, 100.0), 'call.cpu_share': (0.0, 100.5)}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp('spans')
    base, lengths = write_two_hap_sample(d, h2_cut=100000)
    core.align_stats_reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        assert cli.main(base + ['--run-dir', str(d / 'run')]) == 0
        t1 = time.time_ns()
    with open(d / 'run' / 'S1' / 'spans.tsv', newline='') as fh:
        rows = list(csv.DictReader(fh, delimiter='\t'))
    with open(d / 'run' / 'S1' / 'spans.tsv') as fh:
        header = fh.readline().rstrip('\n').split('\t')
    with open(d / 'run' / 'S1' / 'timings.tsv') as fh:
        next(fh)
        timings = [line.rstrip('\n').split('\t') for line in fh]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    return {'dir': d, 'rows': rows, 'header': header, 'timings': timings, 'wall': (t0, t1),
            'events': events, 'lengths': lengths,
            'plan_s': {h: v['plan_s'] for h, v in core.ALIGN_STATS_BY_HAP.items()}}


def _one(rows, name):
    found = [r for r in rows if r['NAME'] == name]
    assert len(found) == 1, f'{name}: {len(found)} rows'
    return found[0]


def _ns(r):
    return int(r['END_NS']) - int(r['START_NS'])


def test_spans_are_written_beside_timings(run):
    assert run['header'] == list(spans.COLUMNS)
    assert (run['dir'] / 'run' / 'S1' / 'timings.tsv').is_file()
    assert sorted((label, stage) for label, stage, _ in run['timings']) == sorted(STAGES)


@pytest.mark.parametrize('label,stage', STAGES)
def test_timings_row_equals_its_stage_span(run, label, stage):
    secs = [float(s) for lab, st, s in run['timings'] if (lab, st) == (label, stage)]
    assert len(secs) == 1
    span = _one(run['rows'], f'{label}:{stage}')
    assert span['LABEL'] == label
    assert abs(_ns(span) / 1e9 - secs[0]) <= 1e-3


def test_haplotypes_run_on_two_threads_apart_from_the_vcf(run):
    rows = run['rows']
    tids = {hap: {_one(rows, f'S1/{hap}:{st}')['TID'] for st in HAP_STAGES}
            for hap in ('h1', 'h2')}
    assert all(len(t) == 1 for t in tids.values()), tids
    assert tids['h1'] != tids['h2']
    assert _one(rows, 'S1:vcf')['TID'] not in tids['h1'] | tids['h2']


def test_plan_contig_tasks_name_their_submitter(run):
    """Each contig's planning is a task span with a wait of 0 or more, the
    contig's length as its bases, under its haplotype's ``align.plan`` span
    on the submitting thread; h2's two contigs run on pool threads."""
    rows = run['rows']
    by_id = {r['ID']: r for r in rows}
    tasks = [r for r in rows if r['NAME'] == 'align.plan_contig']
    assert len(tasks) == len(run['lengths'])
    assert sorted(int(dict(kv.split('=') for kv in t['COUNTS'].split(','))['bases'])
                  for t in tasks) == sorted(run['lengths'].values())
    for t in tasks:
        parent = by_id[t['PARENT']]
        assert parent['NAME'] == 'align.plan' and parent['LABEL'] == t['LABEL']
        assert parent['TID'] == _one(rows, f"{t['LABEL']}:align")['TID']
        assert int(t['WAIT_NS']) >= 0
        assert int(parent['START_NS']) <= int(t['START_NS']) <= int(t['END_NS']) \
            <= int(parent['END_NS'])
    h2 = [t for t in tasks if t['LABEL'] == 'S1/h2']
    assert len(h2) == 2 and all(t['TID'] != by_id[t['PARENT']]['TID'] for t in h2)


def test_plan_s_is_the_plan_span(run):
    rows = run['rows']
    for hap in ('h1', 'h2'):
        span = [r for r in rows if r['NAME'] == 'align.plan' and r['LABEL'] == f'S1/{hap}']
        assert len(span) == 1
        assert abs(_ns(span[0]) / 1e9 - run['plan_s'][hap]) <= 1e-3


def test_main_thread_covers_the_run(run):
    """The spans of the thread that ran the CLI cover 90% of its wall."""
    rows = run['rows']
    main = _one(rows, 'run:reference')['TID']
    assert all(_one(rows, name)['TID'] == main for name in MAIN_SPANS)
    covered, end = 0, 0
    for s, e in sorted((int(r['START_NS']), int(r['END_NS'])) for r in rows
                       if r['TID'] == main):
        covered += max(0, e - max(s, end))
        end = max(end, e)
    t0, t1 = run['wall']
    assert covered >= 0.9 * (t1 - t0)


@pytest.mark.parametrize('name', MAIN_SPANS)
def test_span_starts_on_the_profilers_clock(run, name):
    span = _one(run['rows'], name)
    events = [e for e in run['events'] if e.name() == name]
    assert len(events) == 1
    assert abs(int(span['START_NS']) - events[0].start_ns()) <= 2_000_000


def test_pool_rows_sum_their_tasks(run):
    pool_rows = [r for r in run['rows'] if r['NAME'].startswith('pool:')]
    assert {'pool:haplotypes', 'pool:merge'} <= {r['NAME'] for r in pool_rows}
    for r in pool_rows:
        assert int(r['TASKS']) >= 1 and 1 <= int(r['THREADS']) <= int(r['TASKS'])
        assert 0 <= int(r['MAX_WAIT_NS']) <= int(r['WAIT_NS'])
        assert int(r['RUN_NS']) > 0
    assert _one(run['rows'], 'pool:haplotypes')['TASKS'] == '2'


def _counts(row):
    return dict(kv.split('=') for kv in row['COUNTS'].split(',')) if row['COUNTS'] else {}


def test_seeding_spans_say_where_and_how_many(run):
    """On the CPU the index and every contig's anchors are made on the host:
    ``S1:index`` carries the index's minimizers and ``on=cpu``, and each
    contig's ``chain.anchors`` its anchors and ``on=cpu``; a contig's
    anchors are the sum of its chain DP slabs'."""
    from pav_tpu_torch.align.aligner.index import MinimizerIndex
    from pav_tpu_torch.io.fasta import SeqStore
    rows = run['rows']
    index = _counts(_one(rows, 'S1:index'))
    want = MinimizerIndex(SeqStore.from_file(str(run['dir'] / 'ref.fa'))).n_minimizers()
    assert index == {'minimizers': str(want), 'on': 'cpu'}
    anchors = [r for r in rows if r['NAME'] == 'chain.anchors']
    assert len(anchors) == len(run['lengths'])
    assert all(_counts(r)['on'] == 'cpu' for r in anchors)
    by_id = {r['ID']: r for r in rows}
    for r in anchors:
        slabs = [int(_counts(d)['anchors']) for d in rows
                 if d['NAME'] == 'chain.dp' and d['PARENT'] == r['PARENT']]
        assert int(_counts(r)['anchors']) == sum(slabs) > 0
        assert by_id[r['PARENT']]['NAME'] == 'align.chains'


def test_rows_stay_in_the_budget(run):
    assert len(run['rows']) <= 1000
    assert len({r['ID'] for r in run['rows']}) == len(run['rows'])


def _reader(name):
    path = os.path.join(ROOT, 'benchmark', 'layers', name + '.py')
    spec = importlib.util.spec_from_file_location('reader_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_reads_the_run(run, name):
    record = {'samples': [{'name': 'S1', 'run_dir': str(run['dir'] / 'run')}],
              'contig_mbp': sum(run['lengths'].values()) / 1e6}
    value = _reader(name).read(record)
    lo, hi = READERS[name]
    assert value is not None and lo < value <= hi, value


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_reads_nothing_without_spans(run, name, tmp_path):
    record = {'samples': [{'name': 'S1', 'run_dir': str(tmp_path)}], 'contig_mbp': 0.4}
    assert _reader(name).read(record) is None


def test_pool_use_counts_every_task_under_contention():
    """Many more workers than cores, switching often: no task of a pool use
    is lost from its row, and every task sees the submitter's span."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    rec = spans.Recorder()
    try:
        with rec.active(), spans.span('outer') as outer:
            with pools.Executor('stress', 32) as pool:
                parents = list(pool.map(lambda _: spans._CTX.get()[2], range(2000)))
    finally:
        sys.setswitchinterval(old)
    rows = [s for s in rec.records if s.name == 'pool:stress']
    assert len(rows) == 1
    assert rows[0].tasks == 2000 and rows[0].parent == outer.id
    assert all(p is outer for p in parents)


def test_plan_stats_lose_no_update_under_contention():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    core.align_stats_reset()
    try:
        threads = [threading.Thread(target=lambda: [core._account_plan('hx', 1.0)
                                                    for _ in range(500)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert core.ALIGN_STATS_BY_HAP['hx']['plan_s'] == 8000.0
    assert core.ALIGN_STATS['plan_s'] == 8000.0
    core.align_stats_reset()
