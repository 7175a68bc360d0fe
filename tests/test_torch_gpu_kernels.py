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


def _ragged(dev, B, max_m, max_n, seed, pad=True):
    """Codes 0-4 with m and n drawn independently in [1, max_m] x [1, max_n]
    (m > n included), code 4 past each length (or, with ``pad`` false, any
    code); item 0 takes the full size."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 5, (B, max_n)).astype(np.int8)
    m = rng.integers(1, max_m + 1, B).astype(np.int32)
    n = rng.integers(1, max_n + 1, B).astype(np.int32)
    m[0], n[0] = max_m, max_n
    for b in range(B if pad else 0):
        q[b, m[b]:] = 4
        r[b, n[b]:] = 4
    return [torch.from_numpy(a).to(dev) for a in (q, r, m, n)]


# Boundaries of csrc/dp_full.cu's geometry, as pav_dp_full dispatches on
# width = max_n + 1: dp_full_warp<16, 1> up to width 17, <32, 1> to 33,
# <32, 2> to 65, <32, 4> to 129, <32, 8> to 257 (the last and first width
# of each, and widths 9 and 41 inside); dp_full_block<4> from 258 (its last
# warp owns one column) to 513, <8> from 514 to 4097; the shared-memory
# wide kernel at 4098 and 8193, global scratch at 8194 and 32769; chunks of
# 16 staged rows (max_m 17, 37, 70); B = 1, and batches that leave the last
# block part-filled (8 items per block up to width 17, then 4).
DP_FULL_EDGES = [
    (1, 16, 16), (13, 16, 16), (9, 8, 8), (5, 12, 9), (7, 20, 17), (6, 16, 32),
    (3, 37, 33), (5, 17, 64), (5, 16, 65), (7, 16, 128), (6, 16, 129),
    (5, 16, 256), (3, 16, 257), (3, 24, 512), (3, 24, 513), (2, 40, 1024),
    (2, 24, 2048), (1, 20, 4096), (2, 9, 4097), (2, 17, 8192), (2, 9, 8193),
    (1, 16, 32768), (3, 70, 40),
]


@pytest.mark.parametrize('shape', DP_FULL_EDGES, ids=str)
def test_dp_full_geometry_edges(dev, shape):
    """csrc/dp_full.cu against align_full_ref, bit for bit, with ragged m and
    n (rows past m and columns past n included) at every geometry boundary."""
    B, mm, nn = shape
    q, r, m, n = _ragged(dev, B, mm, nn, 700 + mm + nn)
    tb, _ = K.align_full(q, r, m, n, SC)
    tb_ref, _ = K.align_full_ref(q, r, m, n, SC)
    torch.cuda.synchronize()
    assert torch.equal(tb, tb_ref)


@pytest.mark.parametrize('shape', [(5, 40, 128), (3, 40, 257), (8, 96, 2048)], ids=str)
def test_dp_full_repeated_launches_agree(dev, shape):
    """Twenty launches on one input give the plain version's tape every
    time: the warp kernel's staged chunks and the block kernel's row
    barrier and double-buffered strip maxima and chunk buffers."""
    B, mm, nn = shape
    q, r, m, n = _ragged(dev, B, mm, nn, 800 + nn)
    tb_ref, _ = K.align_full_ref(q, r, m, n, SC)
    for _ in range(20):
        tb, _ = K.align_full(q, r, m, n, SC)
        torch.cuda.synchronize()
        assert torch.equal(tb, tb_ref)


@pytest.mark.parametrize('shape', [(4, 40, 300), (3, 50, 2048), (2, 33, 4096)], ids=str)
def test_dp_full_codes_past_lengths(dev, shape):
    """Any codes past m and n (not only the aligner's padding code 4), in
    the warp, block and shared-memory kernels of dp_full."""
    B, mm, nn = shape
    q, r, m, n = _ragged(dev, B, mm, nn, 900 + nn, pad=False)
    m[1:] = torch.clamp(m[1:], max=mm // 3)
    q[1:, mm // 2:mm // 2 + 3] = 4   # a short padding run between base codes
    tb, _ = K.align_full(q, r, m, n, SC)
    tb_ref, _ = K.align_full_ref(q, r, m, n, SC)
    torch.cuda.synchronize()
    assert torch.equal(tb, tb_ref)


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
    from pav_tpu_torch.align import cigar as cg
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
