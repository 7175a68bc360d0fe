"""The torch port's boundary: it never imports jax, it never runs on a device
it was not given, and a CUDA tensor never falls back to a plain version."""

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

# pav_tpu modules whose import chain reaches jax.
_JAX_MODULES = re.compile(
    r'^\s*(import\s+jax|from\s+jax[\s.]|'
    r'(from|import)\s+pav_tpu\.(ops|parallel|pipeline|runtime|__main__|'
    r'align\.aligner|call\.(density|inv|largesv))\b)', re.M)

_NO_JAX_RUN = r'''
import sys
sys.modules['jax'] = None          # any import of jax now raises ImportError
import numpy as np
import pav_tpu_torch, pav_tpu_torch.pipeline, pav_tpu_torch.__main__
from pav_tpu.align import cigar as cg
from pav_tpu_torch.ops.affine_dp import BandedAligner
rng = np.random.default_rng(0)
q = rng.integers(0, 4, 50).astype(np.uint8)
r = np.delete(q, slice(10, 14))
out = BandedAligner(device='cpu').align_batch([(q, r), (q[:20], q[:20])], width=65)
print(';'.join(cg.to_string(*x) for x in out))
'''


def test_port_imports_and_aligns_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_RUN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == '10=4I36=;20='


def test_no_source_file_imports_jax():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith('.py'):
                path = os.path.join(root, name)
                with open(path) as fh:
                    if _JAX_MODULES.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders
    with open(os.path.join(REPO, 'chip_smoke.py')) as fh:
        assert not _JAX_MODULES.search(fh.read())


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
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device resolves')
    store = SeqStore({'chr1': np.zeros(100, dtype=np.uint8)})
    with pytest.raises(RuntimeError, match='cuda'):
        Pipeline(store, {})
    with pytest.raises(RuntimeError, match='cuda'):
        Pipeline(store, {'device': 'cuda'})
    assert Pipeline(store, {'device': 'cpu'}).device.type == 'cpu'


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
        'traceback': lambda: dp_kernels.traceback(tb, offs, q, r, m, n, False),
    }


@pytest.mark.parametrize('kernel', ['full', 'wave', 'traceback'])
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
    for name in ('align_full_ref', 'align_wave_ref', 'traceback_ref'):
        monkeypatch.setattr(dp_kernels, name, plain)
    before = dict(dp_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match='nvcc'):
        _card_calls()[kernel]()
    assert dp_kernels.LAUNCHES == before


def test_unknown_device_raises():
    q = torch.zeros((2, 8), dtype=torch.int8, device='meta')
    r = torch.zeros((2, 8), dtype=torch.int8, device='meta')
    m = torch.ones(2, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='device'):
        dp_kernels.align_full(q, r, m, m, (1, -5, 5, 56, 4, 1))
