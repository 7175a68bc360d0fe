"""The torch port's boundary: it never imports jax, it never runs on a device
it was not given, and a CUDA tensor never falls back to a plain version."""

import gzip
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pav_tpu_torch
from pav_tpu_torch import _build
from pav_tpu_torch.device import resolve_device
from pav_tpu_torch.ops import dp_kernels

PKG_DIR = os.path.dirname(os.path.abspath(pav_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)

# Any import of jax or of the JAX package (``pav_tpu``, not ``pav_tpu_torch``).
_JAX_MODULES = re.compile(
    r'^\s*(import\s+jax|from\s+jax[\s.]|(from|import)\s+pav_tpu(\.|\s|$))', re.M)

# Run in a fresh interpreter with jax and pav_tpu blocked: any import of
# either raises ImportError.
_BLOCK = "import sys; sys.modules['jax'] = None; sys.modules['pav_tpu'] = None\n"

_NO_JAX_RUN = _BLOCK + r'''
import importlib, pkgutil
import numpy as np
import pav_tpu_torch
for info in pkgutil.walk_packages(pav_tpu_torch.__path__, 'pav_tpu_torch.'):
    importlib.import_module(info.name)
from pav_tpu_torch.align import cigar as cg
from pav_tpu_torch.ops.affine_dp import BandedAligner
rng = np.random.default_rng(0)
q = rng.integers(0, 4, 50).astype(np.uint8)
r = np.delete(q, slice(10, 14))
out = BandedAligner(device='cpu').align_batch([(q, r), (q[:20], q[:20])], width=65)
print(';'.join(cg.to_string(*x) for x in out))
'''

_NO_JAX_CLI = _BLOCK + (
    "import runpy; sys.argv = ['pav_tpu_torch'] + sys.argv[1:]; "
    "runpy.run_module('pav_tpu_torch', run_name='__main__', alter_sys=True)")


def test_port_imports_and_aligns_without_jax():
    """Every module of the port imports with jax and pav_tpu blocked, and a
    tiny aligner job runs through the port's own CIGAR codec."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == '10=4I36=;20='


def test_cli_writes_vcf_without_jax_or_pav_tpu(tmp_path):
    """``python -m pav_tpu_torch --device cpu`` with jax and pav_tpu blocked,
    on the verify recipe's sample (200 kb reference; an SNV, a 300 bp DEL
    and a second SNV): the VCF holds records at the planted positions."""
    from pav_tpu_torch import seqcodec
    from pav_tpu_torch.io.fasta import write_fasta

    from helpers import Mutator, random_seq
    rng = np.random.default_rng(7)
    ref = random_seq(200000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.dele(50000, 300)
    mut.snv(120000, rng=rng)
    write_fasta({'chr1': seqcodec.decode(ref)}, str(tmp_path / 'ref.fa'))
    write_fasta({'tig1': seqcodec.decode(mut.finish())}, str(tmp_path / 'h1.fa'))
    (tmp_path / 'asm.tsv').write_text('NAME\tHAP_h1\nS1\th1.fa\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', _NO_JAX_CLI, '--ref', 'ref.fa', '--assemblies',
         'asm.tsv', '--run-dir', 'run', '--device', 'cpu'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with gzip.open(tmp_path / 'run' / 'S1.vcf.gz', 'rt') as fh:
        pos = {int(line.split('\t')[1]) for line in fh if not line.startswith('#')}
    assert {5001, 50000, 120001} <= pos, sorted(pos)


_NO_JAX_ENTRY = _BLOCK + r'''
import numpy as np
from pav_tpu_torch import asmstat, entry
from pav_tpu_torch.io.fasta import SeqStore
fn, args = entry.entry(device='cpu')
score, tb, offs = fn(*args)
dry = entry.dryrun_multichip(2, device='cpu')
stats = asmstat.asm_stats(SeqStore({'a': np.zeros(300, np.uint8), 'b': np.zeros(50, np.uint8)}))
print(tuple(tb.shape), int(offs.max()), tuple(dry['tb'].shape), int(stats['N50']))
'''


def test_entry_points_and_eval_run_without_jax(tmp_path):
    """``entry``, ``dryrun_multichip`` and ``asmstat``, and ``python -m
    pav_tpu_torch.eval``, with jax and pav_tpu blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_ENTRY], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == '(4, 64, 65) 8 (4, 32, 33) 300'
    vcf = tmp_path / 'a.vcf'
    vcf.write_text('##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n'
                   'c1\t101\ts1\tA\tG\t.\tPASS\tSVTYPE=SNV\n')
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCK + "import runpy; sys.argv = ['eval'] + sys.argv[1:]; "
         "runpy.run_module('pav_tpu_torch.eval', run_name='__main__', alter_sys=True)",
         str(vcf), str(vcf)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'SNV' in proc.stdout and 'RECALL' in proc.stdout


def test_no_source_file_imports_jax():
    """No module of the port and not chip_smoke.py imports jax or
    pav_tpu."""
    offenders = []
    paths = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, name) for name in files if name.endswith('.py')]
    for path in paths:
        with open(path) as fh:
            if _JAX_MODULES.search(fh.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert len(paths) > 50
    assert not offenders


def test_boundary_pattern():
    for line in ('import jax', 'from jax import numpy', 'import pav_tpu',
                 'from pav_tpu import seqcodec', 'from pav_tpu.io.fasta import SeqStore',
                 '    import pav_tpu.runtime'):
        assert _JAX_MODULES.search(line), line
    for line in ('import pav_tpu_torch', 'from pav_tpu_torch import native',
                 'from .align import cigar', '# from pav_tpu'):
        assert not _JAX_MODULES.search(line), line


def test_resolve_device():
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('meta')
    if torch.cuda.is_available():
        assert resolve_device(None).type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            resolve_device('cuda')
        with pytest.raises(RuntimeError, match='cuda'):
            resolve_device(None)


def test_pipeline_defaults_to_cuda():
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device resolves')
    store = SeqStore({'chr1': np.zeros(100, dtype=np.uint8)})
    with pytest.raises(RuntimeError, match='cuda'):
        Pipeline(store, {})
    with pytest.raises(RuntimeError, match='cuda'):
        Pipeline(store, {'device': 'cuda'})
    assert Pipeline(store, {'device': 'cpu'}).device.type == 'cpu'


def test_cli_cuda_without_cuda_writes_no_vcf(tmp_path):
    """``python -m pav_tpu_torch --device cuda`` on a host without CUDA
    exits nonzero, says why, and writes no VCF under its run dir."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present: --device cuda runs')
    (tmp_path / 'ref.fa').write_text('>chr1\n' + 'ACGT' * 50 + '\n')
    (tmp_path / 'h1.fa').write_text('>tig1\n' + 'ACGT' * 50 + '\n')
    (tmp_path / 'asm.tsv').write_text('NAME\tHAP_h1\nS1\th1.fa\n')
    proc = subprocess.run(
        [sys.executable, '-m', 'pav_tpu_torch', '--ref', 'ref.fa', '--assemblies',
         'asm.tsv', '--run-dir', 'run', '--device', 'cuda'],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert 'torch.cuda.is_available() is false' in proc.stderr
    assert not list(tmp_path.glob('run/**/*.vcf*'))


def _card_calls():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(0, 5, (4, 16)).astype(np.int8))
    r = torch.from_numpy(rng.integers(0, 5, (4, 16)).astype(np.int8))
    m = torch.full((4,), 16, dtype=torch.int32)
    n = torch.full((4,), 16, dtype=torch.int32)
    sc = (1, -5, 5, 56, 4, 1)
    tb = torch.zeros((4, 16, 17), dtype=torch.uint8)
    offs = torch.zeros((4, 16), dtype=torch.int32)
    doffs = torch.zeros((4, 32), dtype=torch.int32)
    return {
        'full': lambda: dp_kernels.align_full(q, r, m, n, sc),
        'wave': lambda: dp_kernels.align_wave(q, r, m, n, doffs, 128, sc),
        'band': lambda: dp_kernels.align_band(q, r, m, n, 9, sc),
        'traceback': lambda: dp_kernels.traceback(tb, offs, q, r, m, n, False),
    }


@pytest.mark.parametrize('kernel', ['full', 'wave', 'band', 'traceback'])
def test_cuda_tensor_never_falls_back(monkeypatch, kernel):
    """With the inputs taken for CUDA tensors and no kernel library built,
    each wrapper raises; it never runs its plain version or counts a
    launch."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the kernel library can be built here')
    monkeypatch.setattr(_build, '_LIB', None)
    monkeypatch.setattr(_build, '_nvcc', lambda: (_ for _ in ()).throw(
        RuntimeError('nvcc not found')))
    monkeypatch.setattr(dp_kernels, '_check_seqs',
                        lambda q, r, m, n: torch.device('cuda', 0))
    monkeypatch.setattr(dp_kernels, '_check', lambda *a: None)

    def plain(*a, **k):
        raise AssertionError('plain version ran for a CUDA tensor')
    for name in ('align_full_ref', 'align_wave_ref', 'align_band_ref', 'traceback_ref'):
        monkeypatch.setattr(dp_kernels, name, plain)
    before = dict(dp_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match='nvcc'):
        _card_calls()[kernel]()
    assert dp_kernels.LAUNCHES == before


@pytest.mark.parametrize('on_card', [False, True], ids=['cpu', 'cuda'])
def test_band_rejects_empty_reference(monkeypatch, on_card):
    """A row band needs max_n >= 1 (width 1 of an empty r would read before
    its start): align_band and align_band_ref raise on the CPU, and on a
    tensor taken for CUDA align_band raises before it builds or counts."""
    q = torch.zeros((2, 8), dtype=torch.int8)
    r = torch.zeros((2, 0), dtype=torch.int8)
    m = torch.full((2,), 8, dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    sc = (1, -5, 5, 56, 4, 1)
    if on_card:
        monkeypatch.setattr(dp_kernels, '_check_seqs',
                            lambda q, r, m, n: torch.device('cuda', 0))
        monkeypatch.setattr(_build, '_LIB', None)
        monkeypatch.setattr(_build, '_nvcc', lambda: (_ for _ in ()).throw(
            AssertionError('built a kernel for an empty reference')))
    calls = [lambda: dp_kernels.align_band(q, r, m, n, 1, sc)]
    if not on_card:
        calls.append(lambda: dp_kernels.align_band_ref(q, r, m, n, 1, sc))
    before = dict(dp_kernels.LAUNCHES)
    for call in calls:
        with pytest.raises(ValueError, match='max_n'):
            call()
    assert dp_kernels.LAUNCHES == before


def test_unknown_device_raises():
    q = torch.zeros((2, 8), dtype=torch.int8, device='meta')
    r = torch.zeros((2, 8), dtype=torch.int8, device='meta')
    m = torch.ones(2, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='device'):
        dp_kernels.align_full(q, r, m, m, (1, -5, 5, 56, 4, 1))
