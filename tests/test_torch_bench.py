"""bench_torch.py, the port of bench.py, on the CPU.

Held here: the script runs end to end with ``--device cpu`` at a tiny size,
with jax and pav_tpu blocked in every interpreter it starts, and prints
bench.py's JSON keys (backend cpu, mfu null); its ``mfu``
operation count equals one made by hand on a full-width and a wavefront
class; its repeat-rich sample is the one bench.py's ``repeat_child`` builds
from tests/helpers.py; and ``--device cuda`` without CUDA stops before any
number is printed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch

REPO = os.path.dirname(os.path.abspath(bench_torch.__file__))
SCRIPT = os.path.join(REPO, 'bench_torch.py')
KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'mfu', 'peak_rss_gb', 'backend')
SECONDARY = ('repeat_rich_mbp_s', 'chrom_scale_mbp_s', 'chrom_peak_rss_gb')

# The tiny size: a 0.3 Mbp headline and chromosome sample (0.15 Mbp
# repeat-rich), one iteration.
TINY_ENV = {'PAV_BENCH_REF_MBP': '0.3', 'PAV_BENCH_CHROM_MBP': '0.3',
            'PAV_BENCH_ITERS': '1', 'PAV_BENCH_MAX_ITERS': '1'}


def json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith('{')]


@pytest.fixture(scope='module')
def tiny_run(tmp_path_factory):
    """One ``bench_torch.py --device cpu`` run at the tiny size, with jax and
    pav_tpu blocked in the script and in both of its child processes (a
    ``sitecustomize`` on the path blocks them in every interpreter the run
    starts, and writes each one's pid to ``started``); (process, started)."""
    from test_torch_import_boundary import _BLOCK
    site = tmp_path_factory.mktemp('bench_site')
    started = site / 'started'
    (site / 'sitecustomize.py').write_text(
        _BLOCK + f"import os\nwith open({str(started)!r}, 'a') as fh:\n"
                 "    fh.write(f'{os.getpid()}\\n')\n")
    env = dict(os.environ, PYTHONPATH=f'{site}{os.pathsep}{REPO}', **TINY_ENV)
    proc = subprocess.run([sys.executable, SCRIPT, '--device', 'cpu'], cwd=site, env=env,
                          capture_output=True, text=True, timeout=900)
    return proc, started


def test_runs_end_to_end_on_the_cpu(tiny_run):
    proc, _ = tiny_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = json_lines(proc.stdout)
    assert len(lines) == 3, proc.stdout
    for line in lines:
        assert set(KEYS) <= set(line)
        assert line['metric'] == 'contig_mbp_aligned_called_per_s' and line['unit'] == 'Mbp/s'
        assert line['backend'] == 'cpu' and line['mfu'] is None
        assert line['value'] > 0 and line['vs_baseline'] == round(line['value'] / 0.33, 3)
    assert set(lines[-1]) == set(KEYS + SECONDARY)
    assert all(lines[-1][k] > 0 for k in SECONDARY)
    assert 'headline VCF: every recall floor met' in proc.stderr
    assert '[bench] nvidia-smi: ' in proc.stderr and 'cores' in proc.stderr


def test_runs_without_jax_or_pav_tpu(tiny_run):
    """The same run went through the script and both children with jax and
    pav_tpu blocked: three interpreters started, and none failed."""
    proc, started = tiny_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(started.read_text().split()) >= 3
    assert 'failed (rc=' not in proc.stderr and 'timed out' not in proc.stderr


def _hand_ops(kind, launches, b_pad, mm, nn, width):
    if kind == 'full':
        return launches * 40 * b_pad * mm * (nn + 1)
    lanes = -(-(width // 2 + 8) // 128) * 128     # roundup128(width/2 + 8)
    return launches * 49 * b_pad * (mm + nn) * lanes


@pytest.mark.parametrize('kind, key', [
    ('full', (2048, 2048, 2049, 64)),
    ('full', (16, 1024, 1025, 256)),
    ('wave', (8192, 8192, 513, 8)),
    ('wave', (8192, 8192, 2049, 4)),
])
def test_mfu_operation_count(kind, key):
    """dp_ops on a one-class table, and on a table of both kinds, equals
    the count made by hand from the class shape and its launches."""
    row = (3, 0.5, 100, 0, 0, 0, 0)
    assert bench_torch.dp_ops({key: row}) == _hand_ops(kind, 3, key[3], *key[:3])
    both = {key: row, (16, 16, 17, 4096): (5,) + row[1:]}
    assert bench_torch.dp_ops(both) == (_hand_ops(kind, 3, key[3], *key[:3])
                                        + _hand_ops('full', 5, 4096, 16, 16, 17))


class _Captured(Exception):
    pass


def test_repeat_sample_equals_bench(monkeypatch):
    """bench.py's repeat_child, stopped at its first run_sample, builds the
    same reference and haplotype from tests/helpers.py as bench_torch's
    repeat_sample at the same length and seed."""
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
    monkeypatch.setattr(bench_torch, 'REF_MBP', 0.3)
    with pytest.raises(_Captured):
        bench.repeat_child()
    rref, rhap = bench_torch.repeat_sample()
    assert len(rref) == 150000 and len(rhap) > 100000
    assert np.array_equal(rref, seen['ref']) and np.array_equal(rhap, seen['hap'])


def test_cuda_without_cuda_prints_no_number():
    if torch.cuda.is_available():
        pytest.skip('CUDA present: --device cuda runs')
    proc = subprocess.run([sys.executable, SCRIPT, '--device', 'cuda'], cwd=REPO,
                          env=dict(os.environ, **TINY_ENV), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert json_lines(proc.stdout) == []
    assert 'torch.cuda.is_available() is false' in proc.stderr
