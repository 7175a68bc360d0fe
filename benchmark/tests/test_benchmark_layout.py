"""BENCHMARK.json against the format it has to keep, and every piece it
names found by name; a configuration, a mix and a per-layer metric added as
new files are picked up with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

from cpu_harness import BENCH, ROOT, load

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_benchmark_json_format():
    b = bench()
    assert set(b) == KEYS
    assert b['paths'] == ['benchmark'] and b['command'] == ['python3', 'benchmark/run.py']
    assert 1 <= b['run_seconds'] <= 51
    names = [c['name'] for c in b['configs']]
    assert len(set(names)) == len(names)
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and line(c['source']) and line(c['why'])
        assert all(NAME.match(k) for k in c['reduced']) and len(c['reduced']) <= 16
    cells = [w['name'] for w in b['workloads']]
    assert len(set(cells)) == len(cells)
    pairs = {(w['config'], w['traffic']) for w in b['workloads']}
    assert len(pairs) == len(cells)
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and w['config'] in names
        assert w['chips'] == 1 and line(w['why'])
    assert {w['config'] for w in b['workloads']} == set(names)
    metrics = b['end_to_end'] + b['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    assert 'setup_s' in {m['name'] for m in b['end_to_end']}
    for m in b['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    e2e = {m['name'] for m in b['end_to_end']}
    for m in b['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in e2e and line(m['layer'])
        assert set(m['workloads']) <= set(cells)
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize('kind', ['config', 'mix', 'limits', 'e2e', 'layer', 'kernel'])
def test_every_piece_found_by_name(kind):
    b = bench()
    if kind == 'config':
        for c in b['configs']:
            assert c['file'].startswith('benchmark/configs/')
            with open(os.path.join(ROOT, c['file'])) as fh:
                cfg = json.load(fh)
            assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
            assert all(k in cfg for k in c['reduced'])
            assert line(cfg['source'])
    elif kind == 'mix':
        for w in b['workloads']:
            with open(os.path.join(BENCH, 'mixes', w['traffic'] + '.json')) as fh:
                assert json.load(fh)['name'] == w['traffic']
    elif kind == 'limits':
        for w in b['workloads']:
            with open(os.path.join(BENCH, 'limits', w['name'] + '.json')) as fh:
                limits = json.load(fh)
            assert {'missed_share', 'edge_missed_share', 'false_share', 'duplicate_calls',
                    'dp_bad_items', 'dp_bad_windows'} <= set(limits)
    elif kind in ('e2e', 'layer'):
        group, folder = ('end_to_end', 'e2e') if kind == 'e2e' else ('per_layer', 'layers')
        for m in b[group]:
            mod = load(os.path.join(BENCH, folder, m['name'] + '.py'), 'reader')
            assert callable(mod.read)
    else:
        names = {m['name'] for m in b['per_layer']} | {
            f[:-3] for f in os.listdir(os.path.join(BENCH, 'layers')) if f.endswith('.py')}
        for name in names:
            if name.endswith('_roofline'):
                mod = load(os.path.join(BENCH, 'kernels', name[:-len('_roofline')] + '.py'),
                           'kernel')
                assert mod.NEEDLE and mod.PEAK and callable(mod.work)


def test_new_files_picked_up_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a limits file
    and a per-layer metric as new files plus new BENCHMARK.json entries;
    the copy's harness finds each by name, no file that was there edited."""
    root = tmp_path / 'checkout'
    shutil.copytree(BENCH, root / 'benchmark', ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*') if p.is_file()}
    b = bench()
    with open(root / 'benchmark' / 'configs' / 'hprc_chr21.json') as fh:
        cfg = dict(json.load(fh), name='hprc_chr22', chromosomes=[['chr22', 50818468]])
    (root / 'benchmark' / 'configs' / 'hprc_chr22.json').write_text(json.dumps(cfg))
    with open(root / 'benchmark' / 'mixes' / 'bench_mix.json') as fh:
        mix = dict(json.load(fh), name='sparse_mix', spacing=[1600, 3600])
    (root / 'benchmark' / 'mixes' / 'sparse_mix.json').write_text(json.dumps(mix))
    with open(root / 'benchmark' / 'limits' / 'hprc_chr21.pub_mix.json') as fh:
        (root / 'benchmark' / 'limits' / 'hprc_chr22.sparse_mix.json').write_text(fh.read())
    (root / 'benchmark' / 'layers' / 'window.samples.py').write_text(
        'def read(record):\n    return len(record["samples"])\n')
    b['configs'].append({'name': 'hprc_chr22', 'source': 'x', 'why': 'x', 'reduced': [],
                         'file': 'benchmark/configs/hprc_chr22.json'})
    b['workloads'].append({'name': 'hprc_chr22.sparse_mix', 'config': 'hprc_chr22',
                           'traffic': 'sparse_mix', 'chips': 1, 'why': 'x'})
    b['per_layer'].append({'name': 'window.samples', 'unit': 'samples', 'better': 'higher',
                           'source': 'host_clock', 'layer': 'Window', 'moves': 'setup_s'})
    (root / 'BENCHMARK.json').write_text(json.dumps(b))

    run = load(str(root / 'benchmark' / 'run.py'), 'copied_run')
    cell, cfg2, cfg_path, mix2, mix_path, limits = run.cell_files(b, 'hprc_chr22.sparse_mix')
    assert cfg2['chromosomes'] == [['chr22', 50818468]] and mix2['spacing'] == [1600, 3600]
    assert cfg_path == str(root / 'benchmark' / 'configs' / 'hprc_chr22.json')
    assert mix_path == str(root / 'benchmark' / 'mixes' / 'sparse_mix.json')
    assert limits['dp_bad_items'] == 0
    record = {'samples': [{}, {}], 'contig_mbp': 0.0, 'trace': None, 'kernels': {},
              'align_by_hap': {}, 'dp_stats': {'classes': {}, 'resolve_s': 0.0}}
    got = run.metrics_of(b, cell, True, record)
    assert got == {'window.samples': {'value': 2, 'unit': 'samples'}}
    after = {p: p.read_bytes() for p in before}
    assert after == before
