"""The harness end to end on the CPU at 1/200 scale: the result line's
keys, the control failing the check, faults planted in the timed path
failing it, the run without a card, and the import boundary."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from cpu_harness import BENCH, ROOT, harness, load, shrink

SEED = 2**31 + 977
RESULT_KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device', 'checks'}
CONTROL_FAILS = ('missed_share', 'false_share', 'dp_bad_items')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


CELLS = [w['name'] for w in bench()['workloads']]


@pytest.mark.parametrize('cell', [CELLS[0], 'hprc_chr21.bench_mix'])
@pytest.mark.parametrize('trace', [0, 1])
def test_result_line(monkeypatch, capsys, trace, cell):
    """The last line has the contract's keys and exactly the metrics that
    BENCHMARK.json lists for the cell; every reader's reading is on
    standard error, the checks last."""
    run = harness(monkeypatch)
    monkeypatch.setattr(sys, 'argv', ['run.py'])
    rc = run.main(['--workload', cell, '--seed', str(SEED), '--seconds', '1',
                   '--trace', str(trace)])
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and res['correct'] is True and res['failed'] == 0 and res['attempted'] == 1
    assert set(res) == RESULT_KEYS | ({'breakdown'} if trace else set())
    assert list(res)[-1] == 'checks'
    device = {'platform', 'kind', 'count', 'memory_peak_bytes'}
    assert set(res['device']) == device | ({'busy_s', 'window_s'} if trace else set())
    b = bench()
    group = b['per_layer'] if trace else b['end_to_end']
    names = {m['name'] for m in group if cell in m.get('workloads', [cell])}
    # no device on the CPU: the rooflines find nothing to read
    assert set(res['metrics']) == names - {'dp_full_roofline', 'traceback_roofline'}
    if trace:
        assert len(res['breakdown']['idle_gaps']) >= 1
    # every reader's reading on standard error, the rooflines' none on the CPU
    said = json.loads(next(line for line in out.err.splitlines()
                           if line.startswith('benchmark: readings '))[len('benchmark: readings '):])
    readers = {f[:-3] for folder in ('e2e', 'layers')
               for f in os.listdir(os.path.join(BENCH, folder)) if f.endswith('.py')}
    assert set(said) == readers and said['contig_mbp_per_s'] > 0
    assert said['dp_full_roofline'] is None and said['traceback_roofline'] is None
    for m in res['metrics'].values():
        assert set(m) == {'value', 'unit'}
    tail = out.err.strip().splitlines()[-len(res['checks']):]
    assert [line.split()[1] for line in tail] == list(res['checks'])


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_check(monkeypatch, cell):
    """The program passes; the control (positions and DP extents at 2 bp)
    fails the shares of missed and false calls and the DP items at once."""
    run = harness(monkeypatch)
    res = run.measure(cell, SEED, 1, False, control=True)
    assert res['correct'] is True
    for name, c in res['checks'].items():
        assert c['value'] <= c['limit']
    for name in CONTROL_FAILS:
        assert res['control'][name] > res['checks'][name]['limit'], name


def _unchanged(out):
    return torch.zeros_like(out)


def _half_left_out(out):
    out = out.clone()
    half = out.shape[0] // 2
    out[half:] = out[:out.shape[0] - half]
    return out


def _answer_altered(out):
    out = out.clone()
    lengths = out[:, -5:-1].to(torch.int64) @ (1 << (8 * torch.arange(4)))
    out[int(torch.argmax(lengths)), 0] ^= 1     # its last step: = <-> X, I <-> D
    return out


def _untrimmed(df, *args, **kw):
    df = df.copy()
    for col in ('TRIM_REF_L', 'TRIM_REF_R', 'TRIM_QRY_L', 'TRIM_QRY_R'):
        if col not in df.columns:
            df[col] = 0
    return df


def _complement_dropped(gather):
    def wrong(resident, desc, *args):
        desc = desc.clone()
        desc[:, 2] &= 1
        desc[:, 5] &= 1
        return gather(resident, desc, *args)
    return wrong


def _plant(monkeypatch, fault):
    """Break the timed path where the answer is produced."""
    from pav_tpu_torch import pipeline
    from pav_tpu_torch.ops import affine_dp, dp_kernels
    if fault == 'trimming_off':
        monkeypatch.setattr(pipeline, 'trim_alignments', _untrimmed)
    elif fault == 'complement_dropped':
        monkeypatch.setattr(affine_dp, '_gather_resident',
                            _complement_dropped(affine_dp._gather_resident))
    else:
        walker = {'state_unchanged': _unchanged, 'half_batch_left_out': _half_left_out,
                  'answer_altered': _answer_altered}[fault]
        good = dp_kernels.traceback
        monkeypatch.setattr(dp_kernels, 'traceback', lambda *a, **k: walker(good(*a, **k)))


@pytest.mark.parametrize('fault, caught_by', [
    ('state_unchanged', 'dp_bad_items'), ('half_batch_left_out', 'dp_bad_items'),
    ('answer_altered', 'dp_bad_items'), ('trimming_off', 'duplicate_calls'),
    ('complement_dropped', 'dp_bad_windows')])
def test_fault_in_the_timed_path_fails(monkeypatch, fault, caught_by):
    """The walker's output, the trimming of overlapping contigs or the
    gather of reverse-strand windows broken, in the window only (the
    warm-up runs sound): ``correct`` false, by the number named or by a
    sample that the fault made fail."""
    run = harness(monkeypatch)
    window = run.run_window

    def faulty_window(*args, **kw):
        _plant(monkeypatch, fault)
        return window(*args, **kw)

    monkeypatch.setattr(run, 'run_window', faulty_window)
    res = run.measure(CELLS[0], SEED, 1, False)
    assert res['correct'] is False
    assert res['failed'] or res['checks'][caught_by]['value'] > res['checks'][caught_by]['limit']


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0], '--seed',
                        '1', '--seconds', '1', '--trace', '0'], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ''


def test_forbidden_names_compared_whole(monkeypatch):
    run = harness(monkeypatch)
    assert run.forbidden_modules(['pav_tpu_torch', 'pav_tpu_torch.ops', 'jaxtyping']) == []
    assert run.forbidden_modules(['pav_tpu.ops', 'jax.numpy', 'torch']) == ['jax', 'pav_tpu']


@pytest.mark.parametrize('name', ['reference.py', 'gen.py'])
def test_reference_and_generator_import_nothing_of_the_program(name):
    code = ('import sys, importlib.util\n'
            'for m in ("jax", "pav_tpu", "pav_tpu_torch", "torch"): sys.modules[m] = None\n'
            f'spec = importlib.util.spec_from_file_location("m", {os.path.join(BENCH, name)!r})\n'
            'spec.loader.exec_module(importlib.util.module_from_spec(spec))\n')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=60)


def test_harness_sources_import_no_jax():
    banned = {'jax', 'jaxlib', 'flax', 'pav_tpu', 'bench', 'bench_torch', 'chip_smoke'}
    for folder, _, files in os.walk(BENCH):
        if os.path.basename(folder) == 'tests':
            continue
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(folder, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        tops = {a.name.split('.')[0] for a in node.names}
                    elif isinstance(node, ast.ImportFrom) and node.level == 0:
                        tops = {node.module.split('.')[0]}
                    else:
                        continue
                    assert not tops & banned, (f, tops)


@pytest.mark.gpu
def test_control_on_the_card(monkeypatch):
    """On a card: the cell at 1/200 scale through the harness on cuda, the
    program passing and the control failing every number."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    run = shrink(load(os.path.join(BENCH, 'run.py'), 'bench_run_card'), monkeypatch)
    res = run.measure(CELLS[0], SEED, 1, False, control=True)
    assert res['correct'] is True and res['device']['platform'] == 'gpu'
    assert all(res['control'][k] > res['checks'][k]['limit'] for k in CONTROL_FAILS)
