"""The torch port's aligner (device='cpu', plain kernel versions) against
the JAX reference's align_store on its accelerator branch.

The port runs with ladder='accel', the class ladder of its CUDA path, and
the reference is forced onto its accelerator branch: both packages see the
same numpy genomes and use the same class ladder, so their alignment
tables must be equal: the genome of test_aligner.py's accelerator-branch
test (SNVs, query- and ref-major indels), and a repeat-rich genome whose
tandem arrays produce a balanced 8192-class segment, which both packages
run through their wavefront band kernel. (The CPU ladder is held against
the unforced reference in test_torch_ladder.py.)
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from pav_tpu.align.aligner import Aligner as RefAligner
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu_torch.align.aligner import Aligner
from pav_tpu_torch.align.aligner import core
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import affine_dp

from helpers import Mutator, random_seq, repeat_rich_ref


def _ref_align(ref_store, store, config, monkeypatch):
    """align_store of the reference, forced onto its accelerator branch on
    the CPU backend (as test_aligner.py does)."""
    from pav_tpu.align.aligner import core as ref_core
    with monkeypatch.context() as mp:
        mp.setattr(jax, 'default_backend', lambda: 'fake-accel')
        mp.setattr(ref_core, '_shape_batch', lambda m_b, w_b, n_b=None: 16)
        mp.setenv('PAV_TPU_PALLAS', '0')
        return RefAligner(ref_store, config).align_store(store, 'h1')


def _compare(ref, hap, config, monkeypatch):
    want = _ref_align(RefSeqStore({'chr1': ref}), RefSeqStore({'c1': hap}),
                      config, monkeypatch)
    affine_dp.stats_reset()
    got = Aligner(SeqStore({'chr1': ref}), config, device='cpu',
                  ladder='accel').align_store(SeqStore({'c1': hap}), 'h1')
    assert got.shape[0] >= 1
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))
    return dict(affine_dp.STATS['classes'])


def test_align_store_matches_reference(monkeypatch):
    rng = np.random.default_rng(33)
    ref = random_seq(400000, rng)
    mut = Mutator(ref)
    mut.snv(5000, rng=rng)
    mut.ins(40000, random_seq(800, rng))      # query-major segment
    mut.dele(80000, 700)                      # ref-major segment
    mut.ins(120000, random_seq(30, rng))
    mut.dele(160000, 25)
    mut.snv(200000, rng=rng)
    classes = _compare(ref, mut.finish(), {'aligner_min_chain_score': 500},
                       monkeypatch)
    assert any(w == n + 1 for (_, n, w, _) in classes)


def test_align_store_repeat_rich_matches_reference(monkeypatch):
    rng = np.random.default_rng(3)
    ref, _ = repeat_rich_ref(250000, rng)
    mut = Mutator(ref)
    pos = 2000
    while pos < len(ref) - 20000:
        r = rng.random()
        if r < 0.8:
            if ref[pos] < 4:
                mut.snv(pos, rng=rng)
        elif r < 0.97:
            ln = int(rng.integers(1, 40))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        else:
            ln = int(rng.integers(50, 1200))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        pos = max(pos + int(rng.integers(900, 2000)), mut.cursor + 200)
    classes = _compare(ref, mut.finish(), {'aligner_min_chain_score': 1000},
                       monkeypatch)
    assert any(w < n + 1 for (_, n, w, _) in classes), 'no banded class ran'


@pytest.mark.parametrize('m,n,want', [
    (10, 12, (16, 16, 17)),
    (16, 30000, (16, 32768, 32769)),        # unbalanced: full width
    (3000, 3100, (8192, 8192, 512)),        # balanced, hugs the diagonal
    (3000, 3900, (8192, 8192, 2048)),       # balanced, wide band
])
def test_class_ladder_matches_reference(m, n, want):
    from pav_tpu.align.aligner import core as ref_core
    assert core._accel_bucket(m, n) == ref_core._accel_bucket(m, n) == want


@pytest.mark.parametrize('m_b,w_b,n_b', [
    (16, 17, 16), (2048, 2049, 2048), (16, 32769, 32768),
    (8192, 513, 8192), (32768, 2049, 32768)])
def test_shape_batch_caps(monkeypatch, m_b, w_b, n_b):
    """CUDA keeps the reference's accelerator cap (512M tape cells); the CPU
    cap is small and only changes batch padding."""
    from pav_tpu.align.aligner import core as ref_core
    monkeypatch.setattr(jax, 'default_backend', lambda: 'fake-accel')
    assert core._shape_batch(m_b, w_b, n_b, 'cuda') == ref_core._shape_batch(m_b, w_b, n_b)
    cpu = core._shape_batch(m_b, w_b, n_b, 'cpu')
    assert 8 <= cpu <= core._shape_batch(m_b, w_b, n_b, 'cuda')
    assert cpu & (cpu - 1) == 0


def test_resident_buffer_is_plain_codes():
    a = np.array([0, 1, 2, 3, 4], dtype=np.uint8)
    b = np.array([3, 3, 0], dtype=np.uint8)
    cpu = torch.device('cpu')
    res, base = core._build_resident_from([a, b, a], [cpu])
    assert list(res) == [cpu]
    assert res[cpu].dtype == torch.int8
    assert res[cpu].tolist() == [0, 1, 2, 3, 4, 3, 3, 0]
    assert base == {id(a): 0, id(b): 5}


def test_resident_buffer_refuses_int32_overflow():
    """The gather descriptors hold int32 offsets: a buffer of 2^31 bases or
    more raises before it is built, rather than wrapping."""
    # Two 2^30-base views of one zero byte (no memory): 2^31 bases in all.
    big = [np.broadcast_to(np.zeros(1, dtype=np.uint8), (1 << 30,)) for _ in range(2)]
    with pytest.raises(ValueError, match='2\\^31'):
        core._build_resident_from(big, [torch.device('cpu')])
