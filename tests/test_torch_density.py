"""Inversion density of the torch port against pav_tpu.ops.kde.

Host path (grids <= 2^14, float64 numpy in both packages): identical states
and densities. Device path (larger grids): the port's torch.fft float32
kernel against the reference's XLA float32 kernel at the decision level —
the two FFTs round differently, so the argmax states must agree wherever
the top two densities differ by more than 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pav_tpu.call import density as ref_density
from pav_tpu.kmer import KmerUtil as RefKmerUtil
from pav_tpu.ops import kde as ref_kde
from pav_tpu_torch.call import density
from pav_tpu_torch.kmer import KmerUtil
from pav_tpu_torch.ops import kde

from helpers import random_seq


def _state_runs(n, rng):
    """FWD / FWDREV / REV runs like a k-mer scan across an inversion."""
    out = np.zeros(n, dtype=np.int8)
    pos = 0
    while pos < n:
        ln = int(rng.integers(50, max(51, n // 6)))
        out[pos:pos + ln] = rng.choice(3, p=[0.5, 0.1, 0.4])
        pos += ln
    noise = rng.random(n) < 0.05
    out[noise] = rng.integers(0, 3, int(noise.sum()))
    return out


@pytest.mark.parametrize('n,seed', [(3000, 1), (16384, 2), (700, 3)])
def test_host_path_identical(n, seed):
    rng = np.random.default_rng(seed)
    state = _state_runs(n, rng)
    sig = kde.scott_sigmas(state, n ** (-0.2))
    assert np.array_equal(sig, ref_kde.scott_sigmas(state, n ** (-0.2)))
    want_s, want_d = ref_kde.smoothed_states(state, sig, with_density=True)
    got_s, got_d = kde.smoothed_states(state, sig, with_density=True,
                                       device=torch.device('cpu'))
    assert np.array_equal(got_s, want_s)
    assert np.array_equal(got_d, want_d)
    assert np.array_equal(kde.gaussian_density_states(state, sig),
                          ref_kde.gaussian_density_states(state, sig))


@pytest.mark.parametrize('n,seed', [(40000, 4), (70000, 5)])
def test_fft_path_decisions_match(n, seed):
    rng = np.random.default_rng(seed)
    state = _state_runs(n, rng)
    sig = kde.scott_sigmas(state, n ** (-0.2))
    n_pad = kde._next_pow2(n)
    padded = np.full(n_pad, -1, dtype=np.int8)
    padded[:n] = state
    ref_state, ref_dens = ref_kde._density_state_kernel(
        jnp.asarray(padded), jnp.asarray(sig, dtype=jnp.float32), n_pad, 3)
    ref_state = np.asarray(ref_state)[:n]
    ref_dens = np.asarray(ref_dens)[:, :n]

    got_state, got_dens = kde.smoothed_states(state, sig, with_density=True,
                                              device=torch.device('cpu'))
    top2 = np.sort(ref_dens, axis=0)[-2:]
    decided = (top2[1] - top2[0]) > 1e-4 * np.maximum(np.abs(top2[1]), 1e-30)
    assert decided.mean() > 0.99
    assert np.array_equal(got_state[decided], ref_state[decided])
    np.testing.assert_allclose(got_dens, ref_dens, rtol=1e-3, atol=1e-6)


def test_fft_path_needs_a_device():
    state = _state_runs(20000, np.random.default_rng(6))
    with pytest.raises(ValueError, match='device'):
        kde.smoothed_states(state, kde.scott_sigmas(state, 0.1))


def test_smoothed_density_table_matches_reference():
    """get_smoothed_density on an inverted contig region (host path)."""
    rng = np.random.default_rng(8)
    ref = random_seq(12000, rng)
    inv = ref.copy()
    inv[4000:8000] = (3 - inv[4000:8000])[::-1]
    ref_k_util = RefKmerUtil(31)
    want = ref_density.get_smoothed_density(
        inv, ref_density.ref_kmer_set(ref, ref_k_util), ref_k_util)
    k_util = KmerUtil(31)
    got = density.get_smoothed_density(inv, density.ref_kmer_set(ref, k_util), k_util,
                                       device=torch.device('cpu'))
    assert (got['STATE'] == 2).any() and (got['STATE'] == 0).any()
    pd.testing.assert_frame_equal(got, want)
