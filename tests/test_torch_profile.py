"""``--profile-dir`` records the host ops of every thread.

A diploid sample (a 200 kb reference; h1 with an SNV, a 300 bp deletion and
another SNV; h2 with its own SNV and a 25 bp insertion) runs through the CLI
on the CPU without and with ``--profile-dir``: the VCF records are the same,
and the trace holds each stage as a ``sample/hap:stage`` span
(``sample:stage`` for merge and vcf). The profiler records every thread, so
the pools keep their threads: each haplotype's stages are on that
haplotype's own thread, apart from the thread that runs the sample's merge
and vcf; the align spans hold the DP's torch ops (the other stages run
numpy and pandas, which the profiler does not see, so their span is their
record).
"""

import gzip
import json
import threading

import pytest

from pav_tpu_torch import __main__ as cli
from pav_tpu_torch.parallel import pools

from helpers import write_two_hap_sample

HAP_STAGES = ['align', 'trim', 'depth', 'cigar_call', 'largesv', 'inv_scan', 'integrate']
SAMPLE_STAGES = ['merge', 'vcf']


def _records(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines() if not line.startswith('#')]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('profile')
    base, _ = write_two_hap_sample(d)
    assert cli.main(base + ['--run-dir', str(d / 'plain')]) == 0
    assert cli.main(base + ['--run-dir', str(d / 'prof_run'),
                            '--profile-dir', str(d / 'prof')]) == 0
    with open(d / 'prof' / 'trace.json') as fh:
        events = json.load(fh)['traceEvents']
    return (_records(d / 'plain' / 'S1.vcf.gz'), _records(d / 'prof_run' / 'S1.vcf.gz'),
            events)


def test_profiled_run_writes_the_same_vcf(runs):
    plain, profiled, _ = runs
    assert len(plain) >= 4
    assert profiled == plain


def _span(events, name):
    spans = [ev for ev in events if ev.get('name') == name and ev.get('ph') == 'X']
    assert len(spans) == 1, f'{name}: {len(spans)} spans'
    return spans[0]


@pytest.mark.parametrize('label,stage',
                         [(f'S1/{hap}', st) for hap in ('h1', 'h2') for st in HAP_STAGES]
                         + [('S1', st) for st in SAMPLE_STAGES])
def test_trace_holds_each_stage(runs, label, stage):
    """The stage's span is in the trace: a haplotype's stage on the thread
    of that haplotype's align span, which is not the thread of the sample's
    vcf span; merge and vcf on one thread."""
    events = runs[2]
    span = _span(events, f'{label}:{stage}')
    assert span['dur'] > 0
    vcf_tid = _span(events, 'S1:vcf')['tid']
    if label == 'S1':
        assert span['tid'] == vcf_tid
    else:
        assert span['tid'] == _span(events, f'{label}:align')['tid']
        assert span['tid'] != vcf_tid


def test_both_haplotypes_align_on_the_profiled_thread(runs):
    """h1's and h2's align spans each hold host ops of the DP (the plain
    versions' torch ops) on their own profiled thread, two threads in all,
    and the two spans overlap in time."""
    events = runs[2]
    tids = set()
    spans = [_span(events, f'S1/{hap}:align') for hap in ('h1', 'h2')]
    assert spans[0]['ts'] < spans[1]['ts'] + spans[1]['dur']
    assert spans[1]['ts'] < spans[0]['ts'] + spans[0]['dur']
    for span in spans:
        lo, hi = span['ts'], span['ts'] + span['dur']
        ops = {ev['name'] for ev in events
               if ev.get('cat') == 'cpu_op' and ev.get('tid') == span['tid']
               and lo <= ev['ts'] <= hi}
        assert any(name.startswith('aten::') for name in ops), span['name']
        tids.add(span['tid'])
    assert len(tids) == 2


def test_pools_run_inline_only_under_a_profile():
    """A pool runs its tasks on its own threads, and in the caller under
    ``inline()`` (which tests use to run a sample in one thread), with the
    same results and the same delivery of a task's failure."""
    ran_on = []
    with pools.Executor('test', 4) as pool:
        list(pool.map(lambda _: ran_on.append(threading.get_ident()), range(4)))
    assert threading.get_ident() not in ran_on
    ran_on.clear()
    with pools.inline():
        with pools.Executor('test', 4) as pool:
            fut = pool.submit(lambda: ran_on.append(threading.get_ident()) or 7)
            assert list(pool.map(lambda x: x * 2, [1, 2])) == [2, 4]
        pools.start_thread(lambda: ran_on.append(threading.get_ident())).join()
        with pytest.raises(ZeroDivisionError):
            pool.submit(lambda: 1 / 0).result()
    assert fut.result() == 7
    assert ran_on == [threading.get_ident()] * 2
    assert not pools.inlined()
