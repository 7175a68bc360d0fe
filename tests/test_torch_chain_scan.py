"""The port's chain scan (``ops.chain_scan``) against pav_tpu's jitted scan
(jax on the CPU) and the native host kernel (native/chain.cpp), bit for bit:
scores and parents, on slabs like those of test_mesh_sharding.py with two
groups.

On the CPU the scan runs its plain version; ``csrc/chain_scan.cu`` is held
against that plain version on the card (test_torch_gpu_kernels.py).
"""

import numpy as np
import pytest
import torch

from pav_tpu import native as ref_native
from pav_tpu.ops import chain_scan as ref_chain_scan
from pav_tpu_torch import native
from pav_tpu_torch.ops import chain_scan
from pav_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device('cpu')


def _slabs(seed, count=8, lo=50, hi=400, jitter=25):
    """Sorted anchors per slab, rpos = qpos + jitter, two groups per slab
    (the second half of each slab is group 1)."""
    rng = np.random.default_rng(seed)
    slabs = []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        qpos = np.sort(rng.integers(0, 50000, n)).astype(np.int64)
        rpos = (qpos + rng.integers(-jitter, jitter, n)).astype(np.int64)
        group = (np.arange(n) >= n // 2).astype(np.int64)
        slabs.append((qpos, rpos, group))
    return slabs


@pytest.mark.parametrize('seed,k,jitter', [(32, 19, 25), (33, 15, 60), (34, 19, 400)])
def test_batch_matches_jax_scan_and_native(seed, k, jitter):
    slabs = _slabs(seed, jitter=jitter)
    got = chain_scan.chain_scores_batch(slabs, k, device=CPU)
    want = ref_chain_scan.chain_scores_batch(slabs, k)
    assert len(got) == len(slabs)
    chained = 0
    for (qp, rp, gp), (f, p), (fw, pw) in zip(slabs, got, want):
        fn, pn = ref_native.chain_dp(qp, rp, gp, k, 64, 50000, 10000, 0.01 * k)
        assert f.dtype == np.float32 and p.dtype == np.int64
        assert np.array_equal(f, fw) and np.array_equal(p, pw)
        assert np.array_equal(f, fn) and np.array_equal(p, pn)
        chained += int((p >= 0).sum())
    assert chained > 0


def test_one_slab_scan_matches_jax_scan():
    import jax.numpy as jnp
    qp, rp, gp = _slabs(35, count=1, lo=700, hi=701)[0]
    n_pad = 1024
    pad = lambda a, fill: np.concatenate(
        [a, np.full(n_pad - len(a), fill)]).astype(np.int32)
    args = (64, 19, 50000.0, 10000.0, 0.19)
    fw, pw = ref_chain_scan._chain_scan(jnp.asarray(pad(qp, 0)), jnp.asarray(pad(rp, 0)),
                                        jnp.asarray(pad(gp, -9)), *args)
    f, p = chain_scan._chain_scan(torch.from_numpy(pad(qp, 0)), torch.from_numpy(pad(rp, 0)),
                                  torch.from_numpy(pad(gp, -9)), *args)
    assert np.array_equal(f.numpy(), np.asarray(fw))
    assert np.array_equal(p.numpy(), np.asarray(pw))


def test_limits_compare_in_float32():
    """dq <= max_dist and dd <= max_gap_diff compare in float32, as in the
    jitted scan: tight limits on a slab whose gaps straddle them."""
    slabs = _slabs(36, count=4, jitter=300)
    kw = dict(max_dist=120.5, max_gap_diff=37.0)
    got = chain_scan.chain_scores_batch(slabs, 19, device=CPU, **kw)
    want = ref_chain_scan.chain_scores_batch(slabs, 19, **kw)
    for (f, p), (fw, pw) in zip(got, want):
        assert np.array_equal(f, fw) and np.array_equal(p, pw)


def test_native_missing_falls_back_to_device_scan(monkeypatch):
    slabs = _slabs(37, count=3)
    want = [ref_native.chain_dp(q, r, g, 19, 64, 50000, 10000, 0.19) for q, r, g in slabs]
    monkeypatch.setattr(native, 'chain_dp', lambda *a, **k: None)
    for (q, r, g), (fw, pw) in zip(slabs, want):
        f, p = chain_scan.chain_scores(q, r, g, 19, device=CPU)
        assert np.array_equal(f, fw) and np.array_equal(p, pw)
    with pytest.raises(RuntimeError, match='device'):
        chain_scan.chain_scores(*slabs[0], 19)


def test_find_chains_runs_on_the_aligner_device_without_native(monkeypatch):
    """With native.chain_dp gone, the aligner's chaining takes the scan on
    its own device and finds the same chains."""
    from pav_tpu_torch.align.aligner import Aligner
    from pav_tpu_torch.io.fasta import SeqStore

    from helpers import random_seq
    rng = np.random.default_rng(38)
    ref = random_seq(40000, rng)
    contig = ref[3000:33000].copy()
    contig[5000] = (contig[5000] + 1) % 4
    ref_store = SeqStore({'c': ref})
    cfg = {'aligner_min_chain_score': 500}
    want = Aligner(ref_store, cfg, device='cpu').align_store(SeqStore({'t': contig}), 'h1')
    monkeypatch.setattr(native, 'chain_dp', lambda *a, **k: None)
    got = Aligner(ref_store, cfg, device='cpu').align_store(SeqStore({'t': contig}), 'h1')
    assert got.shape[0] == 1
    assert got.equals(want)


def test_mesh_split_is_bit_identical():
    slabs = _slabs(39)
    plain = chain_scan.chain_scores_batch(slabs, 19, device=CPU)
    sharded = chain_scan.chain_scores_batch(slabs, 19, mesh=make_mesh(8, 'cpu'))
    for (f, p), (fs, ps) in zip(plain, sharded):
        assert np.array_equal(f, fs) and np.array_equal(p, ps)


def test_scan_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match='int32'):
        chain_scan._chain_scan_batch(q.to(torch.int64), q, q, 64, 19, 5e4, 1e4, 0.19)
    with pytest.raises(ValueError, match='lookback'):
        chain_scan._chain_scan_batch(q, q, q, 65, 19, 5e4, 1e4, 0.19)
    with pytest.raises(ValueError, match='device'):
        chain_scan._chain_scan_batch(*(torch.zeros((2, 8), dtype=torch.int32,
                                                   device='meta'),) * 3,
                                     64, 19, 5e4, 1e4, 0.19)
