"""Each CUDA kernel of the port against its plain PyTorch version, bit for
bit, on CUDA tensors at the shapes of chip_smoke.py phase 3, and the
mesh-sharded DP against the unsharded one on the card.

Needs a CUDA device and nvcc; skipped without them. This file imports no
jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pav_tpu_torch.ops import affine_dp, chain_scan
from pav_tpu_torch.ops import dp_kernels as K

pytestmark = pytest.mark.gpu
SC = chip_smoke.SCORING


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('CUDA kernels run only on a CUDA device')
    return torch.device('cuda', 0)


def _inputs(dev, B, max_m, max_n, seed):
    return [torch.from_numpy(a).to(dev)
            for a in chip_smoke.dp_inputs(B, max_m, max_n, seed)]


@pytest.mark.parametrize('shape', chip_smoke.FULL_SHAPES, ids=str)
def test_dp_full_and_traceback_match_plain(dev, shape):
    B, mm, nn = shape
    q, r, m, n = _inputs(dev, B, mm, nn, 300)
    before = dict(K.LAUNCHES)
    tb, offs = K.align_full(q, r, m, n, SC)
    tb_ref, _ = K.align_full_ref(q, r, m, n, SC)
    out = K.traceback(tb, offs, q, r, m, n, False)
    out_ref = K.traceback_ref(tb_ref, offs, q, r, m, n, False)
    torch.cuda.synchronize()
    assert torch.equal(tb, tb_ref)
    assert torch.equal(out, out_ref)
    assert K.LAUNCHES['full'] == before['full'] + 1
    assert K.LAUNCHES['traceback'] == before['traceback'] + 1


@pytest.mark.parametrize('shape', chip_smoke.WAVE_SHAPES, ids=str)
def test_dp_wave_and_traceback_match_plain(dev, shape):
    B, mm, nn, width = shape
    q, r, m, n = _inputs(dev, B, mm, nn, 400)
    ww = affine_dp._wave_width(width)
    doffs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)
    tb = K.align_wave(q, r, m, n, doffs, ww, SC)
    tb_ref = K.align_wave_ref(q, r, m, n, doffs, ww, SC)
    out = K.traceback(tb, doffs, q, r, m, n, True)
    out_ref = K.traceback_ref(tb_ref, doffs, q, r, m, n, True)
    torch.cuda.synchronize()
    assert torch.equal(tb, tb_ref)
    assert torch.equal(out, out_ref)


def test_align_and_trace_on_card_matches_cpu(dev):
    """The fused buffer of one related batch: CUDA kernels == CPU plain."""
    q, r, m, n = chip_smoke.dp_inputs(64, 256, 256, 500)
    r[:, :200] = q[:, :200]
    cpu = [torch.from_numpy(a) for a in (q, r, m, n)]
    for width in (257, 65):
        got = affine_dp.align_and_trace(*[t.to(dev) for t in cpu], 256, width,
                                        affine_dp.DEFAULT_SCORING)
        want = affine_dp.align_and_trace(*cpu, 256, width, affine_dp.DEFAULT_SCORING)
        assert torch.equal(got.cpu(), want)


def test_chain_scan_matches_plain(dev):
    """csrc/chain_scan.cu against _chain_scan_ref on CUDA tensors: 16 slabs
    of up to 1024 anchors (ragged, padding group -9, two groups)."""
    q, r, g = (torch.from_numpy(a).to(dev)
               for a in chip_smoke.chain_inputs(16, 1024, 600))
    args = (64, 19, 50000.0, 10000.0, 0.19)
    before = chain_scan.LAUNCHES['chain_scan']
    f, p = chain_scan._chain_scan_batch(q, r, g, *args)
    f_ref, p_ref = chain_scan._chain_scan_ref(q, r, g, *args)
    torch.cuda.synchronize()
    assert chain_scan.LAUNCHES['chain_scan'] == before + 1
    assert torch.equal(f, f_ref) and torch.equal(p, p_ref)
    assert (p >= 0).any()


def test_sharded_dp_matches_unsharded_on_card(dev):
    """BandedAligner over the mesh [cuda:0, cuda:0] gives the unsharded
    CIGARs; each shard runs and copies back on its own."""
    from pav_tpu.align import cigar as cg
    rng = np.random.default_rng(601)
    pairs = []
    for _ in range(61):
        m = int(rng.integers(8, 60))
        q = rng.integers(0, 4, m).astype(np.uint8)
        pairs.append((q, np.delete(q, slice(3, 6)) if m > 12 else q.copy()))
    single = affine_dp.BandedAligner(device=dev)
    sharded = affine_dp.BandedAligner(device=dev, mesh=[dev, dev])
    affine_dp.stats_reset()
    want = [cg.to_string(*x) for x in single.align_batch(pairs, width=65, pad_to=64)]
    got = [cg.to_string(*x) for x in sharded.align_batch(pairs, width=65, pad_to=64)]
    assert affine_dp.STATS['sharded_puts'] == 4
    assert affine_dp.STATS['shard_rows'] == (64, 64)
    assert got == want
