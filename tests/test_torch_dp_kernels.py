"""Plain versions of the port's DP kernels against the JAX reference, bit for
bit, on the CPU.

* align_full_ref tapes == pallas_dp.pallas_align_full(interpret=True) ==
  affine_dp._align_batch (batches of test_pallas_dp.py, ragged, padded);
* align_wave_ref tapes and band offsets == affine_dp._align_batch_wave, and
  == pallas_dp.pallas_align_wave(interpret=True) where D <= 256 (interpret
  mode drops trailing diagonals when 256 does not divide D);
* the fused align_and_trace buffer == affine_dp._align_and_trace with
  backend_kind='xla-wave', at full and banded widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pav_tpu.ops import affine_dp as A
from pav_tpu.ops import pallas_dp as P
from pav_tpu_torch.ops import affine_dp as TA
from pav_tpu_torch.ops import dp_kernels as K

from helpers import random_seq

SCORINGS = [(1, -5, 5, 56, 4, 1), (2, -4, 4, 24, 2, 1)]


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _related_batch(rng, B=6, max_m=32):
    """The batch generator of test_pallas_dp.py: ragged, mostly related
    pairs, padded with 4."""
    q = np.full((B, max_m), 4, np.int8)
    r = np.full((B, max_m), 4, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for i in range(B):
        mm = int(rng.integers(4, max_m))
        qq = random_seq(mm, rng)
        rr = qq.copy()
        if mm > 10 and rng.random() < 0.7:
            rr = np.delete(rr, slice(2, 5))
        if rng.random() < 0.4 and mm > 6:
            rr[3] = (rr[3] + 1) % 4
        q[i, :len(qq)] = qq
        r[i, :len(rr)] = rr
        m[i] = len(qq)
        n[i] = len(rr)
    return q, r, m, n


def _random_batch(rng, B, max_m, max_n, m_le_n=False):
    """The batch generator of test_wave_dp.py: random codes 0-4, ragged
    lengths, rows past each length left as random padding."""
    q = rng.integers(0, 5, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 5, (B, max_n)).astype(np.int8)
    m = rng.integers(1, max_m + 1, B).astype(np.int32)
    n = rng.integers(1, max_n + 1, B).astype(np.int32)
    if m_le_n:
        m, n = np.minimum(m, n), np.maximum(m, n)
    return q, r, m, n


def _mutate(r, rng):
    q = r.copy()
    for _ in range(int(rng.integers(0, 8))):
        p = int(rng.integers(0, max(len(q) - 1, 1)))
        op = rng.random()
        if op < 0.5:
            q[p] = (q[p] + 1 + rng.integers(0, 3)) % 4
        elif op < 0.75 and len(q) > 6:
            q = np.delete(q, slice(p, min(p + int(rng.integers(1, 6)), len(q))))
        else:
            q = np.insert(q, p, rng.integers(0, 4, int(rng.integers(1, 6))).astype(np.int8))
    return q


@pytest.mark.parametrize('sc', SCORINGS)
@pytest.mark.parametrize('seed,max_m', [(23, 32), (24, 16), (25, 64)])
def test_full_tape_matches_pallas_and_xla(seed, max_m, sc):
    rng = np.random.default_rng(seed)
    q, r, m, n = _related_batch(rng, max_m=max_m)
    args = (jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), jnp.asarray(n),
            max_m, max_m + 1, *sc)
    _, tb_xla, _ = A._align_batch(*args)
    tb_pl, _ = P.pallas_align_full(*args, interpret=True)
    tb, offs = K.align_full(*_t(q, r, m, n), sc)
    assert np.array_equal(tb.numpy(), np.asarray(tb_pl))
    assert np.array_equal(tb.numpy(), np.asarray(tb_xla))
    assert not offs.any()


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_full_tape_random_unbalanced(seed):
    """Random codes, ragged m/n, unbalanced shapes (m << n), and random
    (not 4) codes past each length: the Pallas kernel reads every column
    past n as 4, and so does the port (the XLA row kernel would read the
    padding, which the pipeline always fills with 4)."""
    rng = np.random.default_rng(seed)
    q, r, m, n = _random_batch(rng, 5, 8, 200)
    sc = SCORINGS[0]
    tb_pl, _ = P.pallas_align_full(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                                   jnp.asarray(n), 8, 201, *sc, interpret=True)
    tb, _ = K.align_full(*_t(q, r, m, n), sc)
    assert np.array_equal(tb.numpy(), np.asarray(tb_pl))


@pytest.mark.parametrize('sc', SCORINGS)
@pytest.mark.parametrize('trial', range(4))
def test_wave_tape_matches_xla_and_pallas(trial, sc):
    rng = np.random.default_rng(7 + trial)
    max_m, max_n, width = 64, 128, 65
    q, r, m, n = _random_batch(rng, 8, max_m, max_n, m_le_n=True)
    tb_x, off_x = A._align_batch_wave(q, r, m, n, max_m, width, *sc)
    tb_p, off_p = P.pallas_align_wave(q, r, m, n, max_m, width, *sc,
                                      interpret=True)   # D = 192 <= 256
    ww = TA._wave_width(width)
    tq = _t(q, r, m, n)
    doffs = TA._wave_geometry(tq[2], tq[3], max_m, max_n, max_m + max_n, ww)
    tb = K.align_wave(*tq, doffs, ww, sc)
    assert np.array_equal(doffs.numpy(), np.asarray(off_x))
    assert np.array_equal(doffs.numpy(), np.asarray(off_p))
    assert np.array_equal(tb.numpy(), np.asarray(tb_x))
    assert np.array_equal(tb.numpy(), np.asarray(tb_p))


def test_wave_tape_matches_xla_large_band():
    """A 1152-lane band (width 2049) on a long balanced pair."""
    rng = np.random.default_rng(11)
    max_m = max_n = 640
    r0 = random_seq(600, rng).astype(np.int8)
    q0 = _mutate(r0, rng)[:600]
    q = np.full((2, max_m), 4, np.int8)
    r = np.full((2, max_n), 4, np.int8)
    q[0, :len(q0)] = q0
    r[0, :len(r0)] = r0
    q[1, 0] = r[1, 0] = 0
    m = np.array([len(q0), 1], np.int32)
    n = np.array([len(r0), 1], np.int32)
    m, n = np.minimum(m, n), np.maximum(m, n)
    sc = SCORINGS[0]
    tb_x, off_x = A._align_batch_wave(q, r, m, n, max_m, 2049, *sc)
    tq = _t(q, r, m, n)
    doffs = TA._wave_geometry(tq[2], tq[3], max_m, max_n, max_m + max_n, 1152)
    tb = K.align_wave(*tq, doffs, 1152, sc)
    assert np.array_equal(doffs.numpy(), np.asarray(off_x))
    assert np.array_equal(tb.numpy(), np.asarray(tb_x))


@pytest.mark.parametrize('mi,ni,max_m,Ww', [
    (5000, 8000, 8192, 384), (8192, 8192, 8192, 1152),
    (32768, 32768, 32768, 1152),        # d*m reaches 2^31: int32 wrap
    (1, 1, 16, 128)])
def test_wave_geometry_matches_reference(mi, ni, max_m, Ww):
    D = 2 * max_m
    want, _, _ = A._wave_geometry(jnp.int32(mi), jnp.int32(ni), max_m, max_m, D, Ww)
    got = TA._wave_geometry(torch.tensor([mi], dtype=torch.int32),
                            torch.tensor([ni], dtype=torch.int32),
                            max_m, max_m, D, Ww)
    assert np.array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize('sc', SCORINGS)
@pytest.mark.parametrize('trial', range(3))
def test_fused_buffer_matches_reference(trial, sc):
    """Related pairs (m <= n) plus padded rows, at full width and at a band
    narrow enough that some items escape it."""
    rng = np.random.default_rng(100 + trial)
    n_len = int(rng.integers(40, 300))
    B = 5
    max_m = max_n = ((n_len + 40 + 15) // 16) * 16
    q = np.full((B, max_m), 4, np.int8)
    r = np.full((B, max_n), 4, np.int8)
    m = np.ones(B, np.int32)
    n = np.ones(B, np.int32)
    for b in range(B - 1):
        rr = random_seq(n_len, rng).astype(np.int8)
        qq = _mutate(rr, rng)
        if len(qq) > len(rr):
            qq, rr = rr, qq
        q[b, :len(qq)] = qq
        r[b, :len(rr)] = rr
        m[b], n[b] = len(qq), len(rr)
    q[B - 1, 0] = r[B - 1, 0] = 0
    scoring = {'match': sc[0], 'mismatch': sc[1], 'gap_open': sc[2:4],
               'gap_ext': sc[4:6]}
    for width in (max_n + 1, 33):
        want = np.asarray(A._align_and_trace(q, r, m, n, max_m, width, *sc,
                                             backend_kind='xla-wave'))
        got = TA.align_and_trace(*_t(q, r, m, n), max_m, width,
                                 TA.scoring_from_reference(scoring))
        assert np.array_equal(got.numpy(), want), f'width {width}'


def test_fused_buffer_opposing_gaps():
    """Opposing 150 bp gaps put the best global path outside a 128-lane band:
    the banded tape's best in-band path, its length and err byte match the
    reference, as do those of unrelated random pairs."""
    rng = np.random.default_rng(9)
    max_m = max_n = 656
    q, r, m, n = _random_batch(rng, 4, max_m, max_n, m_le_n=True)
    core = random_seq(500, rng).astype(np.int8)
    r0 = np.concatenate([random_seq(150, rng).astype(np.int8), core])
    q0 = np.concatenate([core, random_seq(150, rng).astype(np.int8)])
    q[0, :650], r[0, :650] = q0, r0
    m[0] = n[0] = 650
    sc = SCORINGS[0]
    want = np.asarray(A._align_and_trace(q, r, m, n, max_m, 65, *sc,
                                         backend_kind='xla-wave'))
    got = TA.align_and_trace(*_t(q, r, m, n), max_m, 65, TA.DEFAULT_SCORING)
    assert np.array_equal(got.numpy(), want)


def test_banded_aligner_cigars_match_reference():
    """BandedAligner.align_batch (host padding + launch + resolve) returns the
    reference's CIGARs."""
    from pav_tpu.align import cigar as ref_cg
    from pav_tpu_torch.align import cigar as cg
    rng = np.random.default_rng(29)
    pairs = []
    for _ in range(10):
        mm = int(rng.integers(6, 60))
        qq = random_seq(mm, rng)
        rr = qq.copy()
        if mm > 15:
            rr = np.delete(rr, slice(4, 9))
        pairs.append((qq, rr))
    want = [ref_cg.to_string(*res) for res in
            A.BandedAligner().align_batch(pairs, width=65, pad_to=64)]
    got = [cg.to_string(*res) for res in
           TA.BandedAligner(device='cpu').align_batch(pairs, width=65, pad_to=64)]
    assert got == want


@pytest.mark.parametrize('bad', [
    {'mismatch': -128}, {'mismatch': -200}, {'match': 128},
    {'gap_open': (5,)}])
def test_scoring_range_is_asserted(bad):
    with pytest.raises(ValueError):
        TA.scoring_from_reference(bad)
    with pytest.raises(ValueError):
        TA.BandedAligner(bad, device='cpu')


def test_scoring_from_reference_normalises():
    sc = TA.scoring_from_reference({'mismatch': -4, 'gap_open': [4, 24]})
    assert sc == {'match': 1, 'mismatch': -4, 'gap_open': (4, 24),
                  'gap_ext': (4, 1)}


def test_wrappers_check_inputs():
    rng = np.random.default_rng(0)
    q, r, m, n = _t(*_random_batch(rng, 4, 16, 16))
    sc = SCORINGS[0]
    with pytest.raises(TypeError):
        K.align_full(q.to(torch.int32), r, m, n, sc)
    with pytest.raises(ValueError):
        K.align_full(q, r[:3], m, n, sc)
    with pytest.raises(ValueError):
        K.align_full(q.t().contiguous().t(), r, m, n, sc)
    tb, offs = K.align_full(q, r, m, n, sc)
    with pytest.raises(ValueError):
        K.traceback(tb[:, :8], offs[:, :8], q, r, m, n, False)
    with pytest.raises(ValueError):
        K.align_wave(q, r, m, n, torch.zeros((4, 31), dtype=torch.int32), 128, sc)
