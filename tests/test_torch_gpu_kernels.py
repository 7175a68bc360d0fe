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


def _chain_check(dev, q, r, g, args):
    """The kernel against _chain_scan_ref on the same CUDA tensors; one
    counted launch. Returns the kernel's (f, parent)."""
    q, r, g = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
               for a in (q, r, g))
    before = chain_scan.LAUNCHES['chain_scan']
    f, p = chain_scan._chain_scan_batch(q, r, g, *args)
    f_ref, p_ref = chain_scan._chain_scan_ref(q, r, g, *args)
    torch.cuda.synchronize()
    assert chain_scan.LAUNCHES['chain_scan'] == before + 1
    assert torch.equal(f.view(torch.int32), f_ref.view(torch.int32))
    assert torch.equal(p, p_ref)
    return f, p


@pytest.mark.parametrize('lookback', [1, 2, 31, 32, 33, 64])
def test_chain_scan_lookbacks(dev, lookback):
    """Every lookback the slot layout treats apart (one slot pending, both,
    a full window), on 8 ragged slabs of up to 300 anchors."""
    _, p = _chain_check(dev, *chip_smoke.chain_inputs(8, 300, 610 + lookback),
                        (lookback, 19, 50000.0, 10000.0, 0.19))
    assert (p >= 0).any()


@pytest.mark.parametrize('B,n', [(1, 77), (1, 1000), (200, 333)])
def test_chain_scan_ragged_lengths(dev, B, n):
    """n not a multiple of 32, one slab (one warp a block) and 200 slabs
    (four a block)."""
    _chain_check(dev, *chip_smoke.chain_inputs(B, n, 620 + B), (64, 19, 50000.0, 10000.0, 0.19))


@pytest.mark.parametrize('limits', ['engine', 'float32 straddle', 'huge'])
def test_chain_scan_limits_and_int32_wrap(dev, limits):
    """Coordinates that wrap past 2^31 (the int32 arithmetic wraps, as in
    the reference); the engine's limits and fractional ones take the exact
    integer forms, limits >= 2^23 the int -> float conversions."""
    q, r, g = chip_smoke.chain_inputs(4, 500, 630)
    q = (q.astype(np.int64) + 2**31 - 3000).astype(np.uint32).view(np.int32)
    r = (r.astype(np.int64) + 2**31 - 2990).astype(np.uint32).view(np.int32)
    lim = {'engine': (50000.0, 10000.0), 'float32 straddle': (120.5, 37.0),
           'huge': (3.0e9, 3.0e9)}[limits]
    _chain_check(dev, q, r, g, (64, 19, *lim, 0.19))


def test_chain_scan_every_pair_invalid(dev):
    """Equal query positions (dq = 0) in slab 0, a new group at every
    anchor in slab 1: every f is k and every parent -1."""
    n = 100
    q = np.zeros((2, n), np.int32)
    q[1] = np.arange(n) * 10
    r = np.tile(np.arange(n, dtype=np.int32) * 10, (2, 1))
    g = np.zeros((2, n), np.int32)
    g[1] = np.arange(n)
    f, p = _chain_check(dev, q, r, g, (64, 19, 50000.0, 10000.0, 0.19))
    assert bool((f == 19).all()) and bool((p == -1).all())


def test_chain_scan_every_candidate_ties(dev):
    """Blocks of identical anchors and a follower on their diagonal: every
    predecessor gives the same candidate and the oldest must win."""
    q, r, g = chip_smoke.chain_tie_slab()
    _, p = _chain_check(dev, q[None], r[None], g[None], (64, 19, 50000.0, 10000.0, 0.19))
    assert int(p[0, 20]) == 0


def test_chain_scan_repeated_launches_agree(dev):
    q, r, g = (torch.from_numpy(a).to(dev) for a in chip_smoke.chain_inputs(16, 700, 640))
    args = (64, 19, 50000.0, 10000.0, 0.19)
    f0, p0 = chain_scan._chain_scan_batch(q, r, g, *args)
    f_ref, p_ref = chain_scan._chain_scan_ref(q, r, g, *args)
    assert torch.equal(f0, f_ref) and torch.equal(p0, p_ref)
    for _ in range(20):
        f, p = chain_scan._chain_scan_batch(q, r, g, *args)
        assert torch.equal(f, f0) and torch.equal(p, p0)


def test_chain_fallback_on_card_matches_cpu(dev, monkeypatch):
    """chain_scores without native.chain_dp: the pieces in one launch on
    the card equal the same on the CPU (plain version)."""
    from pav_tpu_torch import native
    q, r, g = chip_smoke.chain_piece_anchors(650)
    monkeypatch.setattr(native, 'chain_dp', lambda *a, **k: None)
    before = chain_scan.LAUNCHES['chain_scan']
    f, p = chain_scan.chain_scores(q, r, g, 19, device=dev)
    assert chain_scan.LAUNCHES['chain_scan'] == before + 1
    fc, pc = chain_scan.chain_scores(q, r, g, 19, device=torch.device('cpu'))
    assert np.array_equal(f, fc) and np.array_equal(p, pc)


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


@pytest.fixture(scope='module')
def lib(dev):
    from pav_tpu_torch import _build
    return _build.lib()


@pytest.fixture(scope='module')
def edge_tapes(dev):
    return chip_smoke.edge_tapes(dev)


@pytest.mark.parametrize('design', ['default', 'windows'])
@pytest.mark.parametrize('idx', range(5))
def test_traceback_edge_tapes_match_plain(lib, edge_tapes, idx, design):
    """The walker on chip_smoke.py's edge tapes (a whole-row deletion run, a
    whole-column insertion run, padded items with m = n = 0, B = 1 crossing
    many windows, a band exit that sets err), in its default design and with
    every tape walked through staged windows."""
    label, tb, offs, q, r, m, n, wave = edge_tapes[idx]
    old = lib.pav_traceback_whole_max(0 if design == 'windows' else -1)
    try:
        out = K.traceback(tb, offs, q, r, m, n, wave)
        torch.cuda.synchronize()
    finally:
        lib.pav_traceback_whole_max(old)
    ref = K.traceback_ref(tb, offs, q, r, m, n, wave)
    assert torch.equal(out, ref), label
    if label.startswith('band exit'):
        assert bool(ref[:, -1].all())


@pytest.mark.parametrize('shape', chip_smoke.FULL_SHAPES[:chip_smoke.TRACED_FULL], ids=str)
def test_traceback_windows_on_phase3_tapes(dev, lib, shape):
    """Every phase-3 walker tape through staged windows (the small ones are
    staged whole by default)."""
    B, mm, nn = shape
    q, r, m, n = _inputs(dev, B, mm, nn, 310)
    tb, offs = K.align_full(q, r, m, n, SC)
    old = lib.pav_traceback_whole_max(0)
    try:
        out = K.traceback(tb, offs, q, r, m, n, False)
        torch.cuda.synchronize()
    finally:
        lib.pav_traceback_whole_max(old)
    assert torch.equal(out, K.traceback_ref(tb, offs, q, r, m, n, False))


def _wave_case(dev, B, mm, nn, ww, seed, shifts=False):
    """Ragged m != n (either longer), and with ``shifts`` band offsets that
    move by -1..3 per diagonal, so every (s1, s2) the reference's shift_sel
    distinguishes occurs."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, mm)).astype(np.int8)
    r = rng.integers(0, 5, (B, nn)).astype(np.int8)
    m = rng.integers(1, mm + 1, B).astype(np.int32)
    n = rng.integers(1, nn + 1, B).astype(np.int32)
    m[0], n[0] = mm, nn
    t = [torch.from_numpy(a).to(dev) for a in (q, r, m, n)]
    if shifts:
        steps = rng.choice([-1, 0, 1, 2, 3], (B, mm + nn))
        steps[:, 0] = 0
        doffs = np.maximum(np.cumsum(steps, axis=1), 0).astype(np.int32)
        d = torch.from_numpy(doffs).to(dev)
    else:
        d = affine_dp._wave_geometry(t[2], t[3], mm, nn, mm + nn, ww)
    return (*t, d)


@pytest.mark.parametrize('case', [
    # B, max_m, max_n, ww, shifts
    (3, 200, 150, 128, False), (1, 160, 300, 384, False), (5, 300, 333, 384, True),
    (2, 700, 650, 1152, False), (3, 260, 240, 1152, True), (4, 96, 500, 128, True),
    (3, 90, 70, 160, False),
], ids=str)
def test_dp_wave_edges_match_plain(dev, case):
    """csrc/dp_wave.cu against align_wave_ref, bit for bit, at ww = 128, 384
    and 1152 (and 160, a partial last warp), ragged m != n, B = 1, and band
    offsets that move by -1..3 per diagonal (every neighbour offset of each
    of the three neighbours)."""
    B, mm, nn, ww, shifts = case
    q, r, m, n, doffs = _wave_case(dev, B, mm, nn, ww, 1000 + mm, shifts)
    tb = K.align_wave(q, r, m, n, doffs, ww, SC)
    torch.cuda.synchronize()
    assert torch.equal(tb, K.align_wave_ref(q, r, m, n, doffs, ww, SC))


@pytest.mark.parametrize('ww', [384, 1152])
def test_dp_wave_repeated_launches_agree(dev, ww):
    """Twenty launches of the default kernel on one input give the plain
    version's tape every time (the per-diagonal warp-edge hand-off and the
    staged band offsets)."""
    q, r, m, n, doffs = _wave_case(dev, 3, 600, 640, ww, 77)
    want = K.align_wave_ref(q, r, m, n, doffs, ww, SC)
    for _ in range(20):
        tb = K.align_wave(q, r, m, n, doffs, ww, SC)
        torch.cuda.synchronize()
        assert torch.equal(tb, want)
