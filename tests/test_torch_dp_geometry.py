"""The plain versions that csrc/dp_full.cu and csrc/dp_band.cu are held to
on the card, against the JAX reference on the CPU at those kernels'
geometry boundaries.

* ``align_full`` (CPU: ``align_full_ref``) == ``affine_dp._align_batch``
  at offset 0, at the widths of dp_full's strips: 4098 (the first), 8193
  (the 512 x 8192 class) and 8194, one row and several;
* ``align_band`` (CPU: ``align_band_ref`` with its score) ==
  ``affine_dp._align_batch`` at every ladder width 2^k + 1, k = 4..12,
  with items much longer in n than in m (a window shift s wider than a
  lane's C columns), and at an int32 wrap of i*n, where the offsets fall
  back to 0 (a negative shift).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pav_tpu.ops import affine_dp as A
from pav_tpu_torch.ops import dp_kernels as K

SC = (1, -5, 5, 56, 4, 1)


def _ragged(B, max_m, max_n, seed):
    """Codes 0-3 with m in [1, max_m] and n in [1, max_n], item 0 at the
    full size; code 4 past each length, as the aligner pads."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 4, (B, max_n)).astype(np.int8)
    m = rng.integers(1, max_m + 1, B).astype(np.int32)
    n = rng.integers(1, max_n + 1, B).astype(np.int32)
    m[0], n[0] = max_m, max_n
    for b in range(B):
        q[b, m[b]:] = 4
        r[b, n[b]:] = 4
    return q, r, m, n


def _reference(arrays, max_m, width):
    return [np.asarray(x) for x in A._align_batch(*(jnp.asarray(a) for a in arrays), max_m,
                                                  width, *SC)]


@pytest.mark.parametrize('shape', [(2, 5, 4097), (2, 1, 8192), (3, 4, 8192), (2, 3, 8193)],
                         ids=str)
def test_full_tape_at_strip_widths_matches_xla(shape):
    B, max_m, max_n = shape
    arrays = _ragged(B, max_m, max_n, 40 + max_m + max_n)
    _, tb_want, _ = _reference(arrays, max_m, max_n + 1)
    tb, offs = K.align_full(*(torch.from_numpy(a) for a in arrays), SC)
    assert np.array_equal(tb.numpy(), tb_want)
    assert not offs.any()


@pytest.mark.parametrize('k', range(4, 13))
def test_band_at_ladder_widths_matches_xla(k):
    """Width 2^k + 1 with max_n = 2 * width: n / m up to ~10, so the window
    moves by more than C columns a row."""
    width = (1 << k) + 1
    max_m, max_n = 24, 2 * width
    arrays = _ragged(3, max_m, max_n, 60 + k)
    want = _reference(arrays, max_m, width)
    got = K.align_band(*(torch.from_numpy(a) for a in arrays), width, SC)
    for name, g, w in zip(('score', 'tape', 'offsets'), got, want):
        assert np.array_equal(g.numpy(), w), name


def test_band_offsets_wrap_matches_xla():
    """n = 2^31 / 100 + 7: i*n passes 2^31 at row 100, the int32 product
    wraps negative and the offsets fall back to 0."""
    rng = np.random.default_rng(70)
    nbig = (1 << 31) // 100 + 7
    q = rng.integers(0, 4, (2, 130)).astype(np.int8)
    r = rng.integers(0, 4, (2, nbig)).astype(np.int8)
    m = np.array([130, 120], np.int32)
    n = np.array([nbig, nbig - 5], np.int32)
    want = _reference((q, r, m, n), 130, 33)
    got = K.align_band(*(torch.from_numpy(a) for a in (q, r, m, n)), 33, SC)
    offs = got[2].numpy()
    assert offs[0, 98] > 0 and offs[0, 100] == 0   # the wrap, as in the reference
    for name, g, w in zip(('score', 'tape', 'offsets'), got, want):
        assert np.array_equal(g.numpy(), w), name
