"""The walker's plain version against the JAX walker, on the geometries the
CUDA walker's staged windows must handle.

Each case runs the reference's DP and walk
(``pav_tpu.ops.affine_dp._align_and_trace_impl``, JAX on the CPU;
``_align_batch_full`` at full width, ``_align_batch_wave`` for the band, not
interpret mode) and the port's plain versions (``align_full_ref`` or
``align_wave_ref``, then ``traceback_ref``) on the same inputs, and holds the
fused buffers (codes, path length, err byte) equal:

* whole-row deletion runs: short queries against long references, so the
  walk crosses window after window to the left;
* whole-column insertion runs: the walk goes straight up (full width) or
  across diagonals one lane at a time (wave);
* padded items with m = n = 0, and items with m = 0 or n = 0 (pure edges);
* a long related pair, whose walk crosses many windows up-left;
* wave tapes with a band exit: the tape of a wider band walked as if its
  band were ``_wave_width(width)`` lanes, so the walk leaves the band and
  sets err (fed to the JAX walker in place of its own wave DP).
"""

import numpy as np
import pytest
import torch

from pav_tpu.ops import affine_dp as A
from pav_tpu_torch.ops import affine_dp as TA
from pav_tpu_torch.ops import dp_kernels as K

from helpers import random_seq

SC = (1, -5, 5, 56, 4, 1)


def _batch(pairs, max_m, max_n):
    B = len(pairs)
    q = np.full((B, max_m), 4, np.int8)
    r = np.full((B, max_n), 4, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (qq, rr) in enumerate(pairs):
        q[b, :len(qq)], r[b, :len(rr)] = qq, rr
        m[b], n[b] = len(qq), len(rr)
    return q, r, m, n


def _row_deletions(rng, max_m, max_n):
    """Queries that are a reference with one or two long deletions."""
    pairs = []
    for k in range(4):
        rr = random_seq(int(rng.integers(max_n - 40, max_n + 1)), rng).astype(np.int8)
        keep = np.ones(len(rr), bool)
        for _ in range(1 + k % 2):
            s = int(rng.integers(0, len(rr) - 1))
            keep[s:s + len(rr) // 2] = False
        qq = rr[keep][:max_m]
        pairs.append((qq, rr))
    return _batch(pairs, max_m, max_n)


def _column_insertions(rng, max_m, max_n):
    """Queries that are a reference with a long insertion."""
    pairs = []
    for _ in range(4):
        rr = random_seq(int(rng.integers(max_n // 2, max_n + 1)), rng).astype(np.int8)
        s = int(rng.integers(0, len(rr)))
        ins = random_seq(max_m - len(rr) - int(rng.integers(0, 8)), rng).astype(np.int8)
        pairs.append((np.concatenate([rr[:s], ins, rr[s:]])[:max_m], rr))
    return _batch(pairs, max_m, max_n)


def _edges(rng, max_m, max_n):
    """m = n = 0 padding, m = 0 < n, n = 0 < m, and two random items."""
    pairs = [(np.zeros(0, np.int8), np.zeros(0, np.int8)),
             (np.zeros(0, np.int8), random_seq(max_n // 2, rng).astype(np.int8)),
             (random_seq(max_m // 3, rng).astype(np.int8), np.zeros(0, np.int8)),
             (random_seq(max_m, rng).astype(np.int8), random_seq(max_n, rng).astype(np.int8)),
             (random_seq(5, rng).astype(np.int8), random_seq(max_n - 3, rng).astype(np.int8))]
    return _batch(pairs, max_m, max_n)


def _related(rng, max_m, max_n):
    """Long related pairs (SNVs and short indels)."""
    pairs = []
    for _ in range(3):
        rr = random_seq(max_n - int(rng.integers(0, 20)), rng).astype(np.int8)
        qq = rr.copy()
        for _ in range(12):
            p = int(rng.integers(0, len(qq) - 10))
            if rng.random() < 0.6:
                qq[p] = (qq[p] + 1) % 4
            elif rng.random() < 0.5:
                qq = np.delete(qq, slice(p, p + int(rng.integers(1, 9))))
            else:
                qq = np.insert(qq, p, random_seq(int(rng.integers(1, 9)), rng))
        pairs.append((qq[:max_m], rr))
    return _batch(pairs, max_m, max_n)


def _port_buffer(q, r, m, n, width, cut_from=None):
    q, r, m, n = (torch.from_numpy(a) for a in (q, r, m, n))
    max_m, max_n = q.shape[1], r.shape[1]
    if width == max_n + 1:
        tb, offs = K.align_full_ref(q, r, m, n, SC)
        return K.traceback_ref(tb, offs, q, r, m, n, False).numpy()
    ww = TA._wave_width(cut_from or width)
    offs = TA._wave_geometry(m, n, max_m, max_n, max_m + max_n, ww)
    tb = K.align_wave_ref(q, r, m, n, offs, ww, SC)
    tb = tb[:, :, :TA._wave_width(width)].contiguous()
    return K.traceback_ref(tb, offs, q, r, m, n, True).numpy()


def _reference_buffer(q, r, m, n, width, cut_from=None):
    max_m = q.shape[1]
    kind = 'xla' if width == r.shape[1] + 1 else 'xla-wave'
    if cut_from is None:
        return np.asarray(A._align_and_trace_impl(q, r, m, n, max_m, width, *SC,
                                                  backend_kind=kind))
    wave = A._align_batch_wave

    def wide_band(q_, r_, m_, n_, max_m_, width_, *sc):
        tb, offs = wave(q_, r_, m_, n_, max_m_, cut_from, *sc)
        return tb[:, :, :A._wave_width(width_)], offs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(A, '_align_batch_wave', wide_band)
        return np.asarray(A._align_and_trace_impl(q, r, m, n, max_m, width, *SC,
                                                  backend_kind=kind))


CASES = [
    # name, inputs, max_m, max_n, width (max_n + 1: full width)
    ('row deletions, full', _row_deletions, 48, 384, 385),
    ('row deletions 16 x 512, full', _row_deletions, 16, 512, 513),
    ('column insertions, full', _column_insertions, 320, 48, 49),
    ('column insertions, wave', _column_insertions, 256, 192, 65),
    ('edges m = n = 0, full', _edges, 40, 200, 201),
    ('edges m = n = 0, wave', _edges, 160, 192, 65),
    ('long related, full', _related, 400, 400, 401),
    ('long related, wave', _related, 512, 512, 129),
]


@pytest.mark.parametrize('name,make,max_m,max_n,width', CASES, ids=[c[0] for c in CASES])
def test_walk_matches_jax_walker(name, make, max_m, max_n, width):
    rng = np.random.default_rng(sum(map(ord, name)))
    q, r, m, n = make(rng, max_m, max_n)
    want = _reference_buffer(q, r, m, n, width)
    got = _port_buffer(q, r, m, n, width)
    assert np.array_equal(got, want)
    pl = (want[:, -5:-1].astype(np.int64) << (8 * np.arange(4))).sum(axis=1)
    assert pl.max() > 0 and not want[:, -1].any()


@pytest.mark.parametrize('width,cut_from', [(65, 513), (257, 1025)])
def test_band_exit_matches_jax_walker(width, cut_from):
    """A wide band's tape walked within a narrower band: the walk leaves the
    band (err set) and reads clamped lanes from there on, in both walkers."""
    rng = np.random.default_rng(width)
    q, r, m, n = _related(rng, 600, 600)
    want = _reference_buffer(q, r, m, n, width, cut_from)
    got = _port_buffer(q, r, m, n, width, cut_from)
    assert want[:, -1].all(), 'every walk must leave the band'
    assert np.array_equal(got, want)
