"""The host spans of a CLI run (``pav_tpu_torch.spans``) and the benchmark's
readers of them.

The 200 kb diploid sample of ``test_torch_profile.py``, with h2 cut into two
contigs so that its planning pool runs on threads, goes through the CLI on
the CPU once, inside a CPU ``torch.profiler`` (which records the thread that
opened it). The run writes ``spans.tsv`` beside ``timings.tsv``; the tests
hold the spans to the timings, the threads, the pools, the profiler's clock,
the memory counts and the row budget, and run the readers in
``benchmark/layers`` that read them on a record of the run. A second sample
of two chromosomes takes the merge's sharded branch.
"""

import csv
import importlib.util
import os
import sys
import threading
import time

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pav_tpu_torch import __main__ as cli
from pav_tpu_torch import spans
from pav_tpu_torch.align.aligner import core
from pav_tpu_torch.parallel import pools

from helpers import Mutator, random_seq, write_two_hap_sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAP_STAGES = ['align', 'trim', 'depth', 'cigar_call', 'largesv', 'inv_scan', 'integrate']
STAGES = ([(f'S1/{hap}', st) for hap in ('h1', 'h2') for st in HAP_STAGES]
          + [('S1', st) for st in ('merge', 'vcf', 'artifacts')])
MAIN_SPANS = ['run:reference', 'S1:load', 'S1:index', 'S1:haplotypes', 'S1:merge', 'S1:vcf',
              'S1:artifacts']
# Each reader and the range its reading must lie in on this run.
READERS = {'pipeline.load_ms_per_mbp': (0.0, 1e6), 'align.index_ms_per_mbp': (0.0, 1e6),
           'align.pool_wait_share': (0.0, 100.0), 'call.cpu_share': (0.0, 100.5),
           'merge.critical_share': (0.0, 100.0), 'memory.sample_rise_gib': (-1e-9, 1e3)}
MEMORY = ('hwm0_kib', 'hwm_kib', 'rss_kib')


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
    """Pools without a task span sum their tasks into one row a use; the
    merge pool's tasks are spans of their own (``merge.job``)."""
    pool_rows = [r for r in run['rows'] if r['NAME'].startswith('pool:')]
    assert 'pool:haplotypes' in {r['NAME'] for r in pool_rows}
    assert 'pool:merge' not in {r['NAME'] for r in pool_rows}
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
    want = MinimizerIndex(SeqStore.from_file(str(run['dir'] / 'ref.fa')))
    assert {k: v for k, v in index.items() if k not in MEMORY} == {
        'chroms': '1', 'minimizers': str(want.n_minimizers()),
        'index_bytes': str(want.nbytes()), 'on': 'cpu'}
    anchors = [r for r in rows if r['NAME'] == 'chain.anchors']
    assert len(anchors) == len(run['lengths'])
    assert all(_counts(r)['on'] == 'cpu' for r in anchors)
    by_id = {r['ID']: r for r in rows}
    for r in anchors:
        slabs = [int(_counts(d)['anchors']) for d in rows
                 if d['NAME'] == 'chain.dp' and d['PARENT'] == r['PARENT']]
        assert int(_counts(r)['anchors']) == sum(slabs) > 0
        assert by_id[r['PARENT']]['NAME'] == 'align.chains'


def test_merge_jobs_are_the_merge_pools_tasks(run):
    """Each callset tier is one task of the merge pool, a ``merge.job`` span
    with its queue wait, under the sample's merge stage; on one chromosome
    no job shards."""
    rows = run['rows']
    merge = _one(rows, 'S1:merge')
    jobs = [r for r in rows if r['NAME'] == 'merge.job']
    assert len(jobs) == 8
    assert sorted((_counts(j)['type'], _counts(j)['tier']) for j in jobs) == sorted(
        (t, tier) for t in ('svindel_ins', 'svindel_del', 'sv_inv', 'snv_snv')
        for tier in ('pass', 'fail'))
    for j in jobs:
        assert j['PARENT'] == merge['ID'] and j['LABEL'] == 'S1'
        assert int(j['WAIT_NS']) >= 0 and int(j['TASKS']) == 0
        assert int(merge['START_NS']) <= int(j['START_NS']) <= int(j['END_NS']) \
            <= int(merge['END_NS'])
        assert int(_counts(j)['shards']) <= 1 and int(_counts(j)['calls']) >= 0
    assert sum(int(_counts(j)['calls']) for j in jobs) >= 5
    assert not [r for r in rows if r['NAME'] in ('merge.shard', 'merge.concat')]


def test_fasta_reads_are_native_spans(run):
    """The text codec reads the reference (under ``run:reference``) and
    each haplotype's FASTA (under ``S1:load``), one ``io.fasta`` span a
    file with its size and records, on the native path."""
    rows = run['rows']
    by_id = {r['ID']: r for r in rows}
    reads = [r for r in rows if r['NAME'] == 'io.fasta']
    assert sorted(by_id[r['PARENT']]['NAME'] for r in reads) == [
        'S1:load', 'S1:load', 'run:reference']
    size = {'run:reference': os.path.getsize(run['dir'] / 'ref.fa'),
            'S1:load': sorted(os.path.getsize(run['dir'] / f) for f in ('h1.fa', 'h2.fa'))}
    got = sorted(int(_counts(r)['bytes']) for r in reads if r['LABEL'] == 'S1')
    assert got == size['S1:load']
    for r in reads:
        c = _counts(r)
        assert c['on'] == 'native' and int(c['records']) >= 1
        if r['LABEL'] == '':
            assert int(c['bytes']) == size['run:reference']


def test_every_artifact_is_a_native_emit_span(run):
    """Each table the run writes and its VCF is one ``emit.table`` span
    naming it, with its rows and its size on disk, on the native path."""
    base = run['dir'] / 'run' / 'S1'
    want = {'vcf': os.path.getsize(run['dir'] / 'run' / 'S1.vcf.gz')}
    for root, _, names in os.walk(base):
        for name in names:
            if name.endswith('.tsv.gz'):
                path = os.path.join(root, name)
                want[os.path.relpath(path, base)[:-len('.tsv.gz')]] = os.path.getsize(path)
    rows = [r for r in run['rows'] if r['NAME'] == 'emit.table']
    got = {_counts(r)['name']: int(_counts(r)['bytes']) for r in rows}
    assert len(rows) == len(got) == len(want) >= 30
    assert got == want
    assert all(_counts(r)['on'] == 'native' and int(_counts(r)['rows']) >= 0 for r in rows)
    vcf = [r for r in rows if _counts(r)['name'] == 'vcf']
    assert int(_counts(vcf[0])['rows']) >= 5


def test_stage_spans_count_memory(run):
    """Every sample and haplotype stage span carries the process's peak
    and resident set; a span's peak never falls while it runs, and along
    the main thread's stage spans it never falls either."""
    rows = run['rows']
    stages = [f'{label}:{stage}' for label, stage in STAGES] + [
        'run:reference', 'S1:load', 'S1:index', 'S1:haplotypes', 'S1:hap_artifacts']
    for name in stages:
        c = _counts(_one(rows, name))
        assert set(MEMORY) <= set(c), name
        assert 0 < int(c['hwm0_kib']) <= int(c['hwm_kib']), name
        assert 0 < int(c['rss_kib']) <= int(c['hwm_kib']), name
    main = _one(rows, 'run:reference')['TID']
    on_main = sorted((int(r['END_NS']), int(_counts(r)['hwm_kib'])) for r in rows
                     if r['TID'] == main and 'hwm_kib' in _counts(r))
    assert len(on_main) >= len(MAIN_SPANS)
    peaks = [h for _, h in on_main]
    assert peaks == sorted(peaks)
    for r in rows:
        c = _counts(r)
        if 'hwm0_kib' in c:
            assert int(c['hwm0_kib']) <= int(c['hwm_kib'])


def test_memory_peak_from_rusage_without_vmhwm(monkeypatch, tmp_path):
    """The peak is ``ru_maxrss`` whatever the status file says of VmHWM,
    raised to any VmRSS read above it, and it never falls; a file without
    VmRSS gives no counts."""
    import resource
    status = tmp_path / 'status'
    status.write_text('Name:\tpython\nVmHWM:\t    30 kB\nVmRSS:\t    12 kB\n')
    monkeypatch.setattr(spans, '_STATUS', str(status))
    monkeypatch.setattr(spans, '_peak_kib', 0)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    hwm, rss = spans.memory_kib()
    assert rss == 12 and hwm >= before > 30
    big = 1 << 40
    status.write_text(f'Name:\tpython\nVmHWM:\t    30 kB\nVmRSS:\t {big} kB\n')
    assert spans.memory_kib() == (big, big)
    status.write_text('Name:\tpython\nVmRSS:\t    12 kB\n')
    assert spans.memory_kib() == (big, 12)
    status.write_text('Name:\tpython\nVmHWM:\t    30 kB\n')
    assert spans.memory_kib() is None


def test_memory_counts_left_out_without_status(monkeypatch):
    monkeypatch.setattr(spans, '_STATUS', '/nonexistent/status')
    assert spans.memory_kib() is None
    with spans.span('x', memory=True) as sp:
        pass
    assert sp.counts == {}


def _two_chromosome_sample(d):
    """chr1 and chr2 (200 kb and 120 kb), each haplotype one contig a
    chromosome with an SNV and an indel on each: calls on both."""
    from pav_tpu_torch import seqcodec as torch_codec
    from pav_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(11)
    ref = {'chr1': random_seq(200000, rng), 'chr2': random_seq(120000, rng)}
    haps = {}
    for h, (snv, indel) in enumerate(((20000, 60000), (45000, 80000))):
        for chrom, seq in ref.items():
            m = Mutator(seq)
            m.snv(snv, rng=rng)
            if h:
                m.ins(indel, random_seq(12, rng))
            else:
                m.dele(indel, 40)
            haps[f'h{h + 1}', chrom] = m.finish()
    write_fasta({c: torch_codec.decode(v) for c, v in ref.items()}, str(d / 'ref.fa'))
    for h in ('h1', 'h2'):
        write_fasta({f'{h}_{c}': torch_codec.decode(haps[h, c]) for c in ref},
                    str(d / f'{h}.fa'))
    (d / 'asm.tsv').write_text(f'NAME\tHAP_h1\tHAP_h2\nS2\t{d / "h1.fa"}\t{d / "h2.fa"}\n')
    return ['--ref', str(d / 'ref.fa'), '--assemblies', str(d / 'asm.tsv'), '--device', 'cpu',
            '--run-dir', str(d / 'run')]


@pytest.fixture(scope='module')
def two_chrom(tmp_path_factory):
    d = tmp_path_factory.mktemp('two_chrom')
    assert cli.main(_two_chromosome_sample(d)) == 0
    with open(d / 'run' / 'S2' / 'spans.tsv', newline='') as fh:
        return {'dir': d, 'rows': list(csv.DictReader(fh, delimiter='\t'))}


def test_merge_shards_sit_under_their_job(two_chrom):
    """Where a tier's calls lie on both chromosomes its job shards: a
    ``merge.shard`` span a chromosome batch, naming its chromosomes and
    counting its calls, then ``merge.concat``, both under the job."""
    rows = two_chrom['rows']
    by_id = {r['ID']: r for r in rows}
    assert _counts(_one(rows, 'S2:index'))['chroms'] == '2'
    sharded = [j for j in rows if j['NAME'] == 'merge.job' and _counts(j)['shards'] == '2']
    assert {_counts(j)['type'] for j in sharded} >= {'snv_snv'}
    for j in sharded:
        shards = [r for r in rows if r['NAME'] == 'merge.shard' and r['PARENT'] == j['ID']]
        concat = [r for r in rows if r['NAME'] == 'merge.concat' and r['PARENT'] == j['ID']]
        assert sorted(_counts(r)['chroms'] for r in shards) == ['chr1', 'chr2']
        assert sum(int(_counts(r)['calls']) for r in shards) == int(_counts(j)['calls'])
        assert len(concat) == 1 and _counts(concat[0])['shards'] == '2'
        assert max(int(r['END_NS']) for r in shards) <= int(concat[0]['START_NS'])
        assert j['TID'] == concat[0]['TID'] == shards[0]['TID'] == shards[1]['TID']
    for r in rows:
        if r['NAME'] in ('merge.shard', 'merge.concat'):
            assert by_id[r['PARENT']]['NAME'] == 'merge.job'


def test_shard_reader_reads_the_sharded_merge(run, two_chrom):
    """``merge.shard_ms_per_mbp`` reads the sharded sample and nothing on
    the sample of one chromosome."""
    reader = _reader('merge.shard_ms_per_mbp')
    sharded = {'samples': [{'name': 'S2', 'run_dir': str(two_chrom['dir'] / 'run')}],
               'contig_mbp': 0.64}
    one = {'samples': [{'name': 'S1', 'run_dir': str(run['dir'] / 'run')}],
           'contig_mbp': sum(run['lengths'].values()) / 1e6}
    assert reader.read(sharded) > 0
    assert reader.read(one) is None


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
    core.align_stats_reset()
