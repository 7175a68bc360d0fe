"""The port's batched density (``kde._conv_batch``,
``_density_state_kernel_batch``, ``smoothed_states_batch``) against
pav_tpu.ops.kde on the same numpy inputs.

Both sides are float32 FFTs (torch's pocketfft here, XLA's there), which
round differently: values are held to a float32 tolerance stated with each
test, and smoothed states at the decision level, as test_torch_density.py
does (states must agree wherever the reference's top two densities differ by
more than 1e-4 relative). The mesh split is bit for bit: the same FFT runs
per region in either layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pav_tpu.ops import kde as ref_kde
from pav_tpu_torch.ops import kde
from pav_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device('cpu')


@pytest.mark.parametrize('B,n,kw,fft_len', [(4, 1000, 301, 2048), (3, 4096, 8193, 16384)])
def test_conv_batch_matches_reference(B, n, kw, fft_len):
    """Tolerance: 1e-5 of the largest output magnitude (float32 FFT
    round-off over a 2^11-2^14 point transform, both sides)."""
    rng = np.random.default_rng(B * n)
    hist = (rng.random((B, n)) < 0.3).astype(np.float32)
    x = np.arange(kw, dtype=np.float32) - kw // 2
    sig = rng.uniform(5, 200, (B, 1)).astype(np.float32)
    kernels = np.exp(-0.5 * (x[None, :] / sig) ** 2).astype(np.float32)
    want = np.asarray(ref_kde._conv_batch(jnp.asarray(hist), jnp.asarray(kernels), fft_len))
    got = kde._conv_batch(torch.from_numpy(hist), torch.from_numpy(kernels), fft_len).numpy()
    assert got.shape == want.shape == (B, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _regions(seed=31, count=16):
    """The 16 regions of test_mesh_sharding.py: 500-3000 labels, Scott
    sigmas at bandwidth factor 0.25."""
    rng = np.random.default_rng(seed)
    regions, sigmas = [], []
    for _ in range(count):
        n = int(rng.integers(500, 3000))
        regions.append(rng.integers(0, 3, n).astype(np.int8))
        sigmas.append(kde.scott_sigmas(regions[-1], 0.25))
    return regions, sigmas


def test_smoothed_states_batch_matches_reference():
    regions, sigmas = _regions()
    want = ref_kde.smoothed_states_batch(regions, sigmas, mesh=None)
    got = kde.smoothed_states_batch(regions, sigmas, device=CPU)
    # Decision mask from the reference's own densities (same padded grid).
    n_pad = kde._next_pow2(max(len(r) for r in regions))
    batch = np.full((len(regions), n_pad), -1, dtype=np.int8)
    for i, r in enumerate(regions):
        batch[i, :len(r)] = r
    sig = np.asarray(sigmas, dtype=np.float32)
    _, ref_dens = ref_kde._density_state_kernel_batch(
        jnp.asarray(batch), jnp.asarray(sig), n_pad, 3)
    ref_dens = np.asarray(ref_dens)
    decided_total = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int8 and g.shape == w.shape == (len(regions[i]),)
        top2 = np.sort(ref_dens[i, :, :len(regions[i])], axis=0)[-2:]
        decided = (top2[1] - top2[0]) > 1e-4 * np.maximum(np.abs(top2[1]), 1e-30)
        decided_total += decided.mean()
        assert np.array_equal(g[decided], w[decided])
    assert decided_total / len(regions) > 0.99


def test_density_batch_kernel_matches_reference_densities():
    """Densities of the batch kernel: rtol 1e-3, atol 1e-6 (the float32 FFT
    tolerance of test_torch_density.py's FFT path)."""
    regions, sigmas = _regions(seed=5, count=4)
    n_pad = 4096
    batch = np.full((4, n_pad), -1, dtype=np.int8)
    for i, r in enumerate(regions):
        batch[i, :len(r)] = r
    sig = np.asarray(sigmas, dtype=np.float32)
    _, want = ref_kde._density_state_kernel_batch(jnp.asarray(batch), jnp.asarray(sig),
                                                  n_pad, 3)
    state, got = kde._density_state_kernel_batch(torch.from_numpy(batch),
                                                 torch.from_numpy(sig), n_pad, 3)
    assert state.dtype == torch.int8 and tuple(state.shape) == (4, n_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-6)


def test_mesh_split_is_bit_identical():
    regions, sigmas = _regions()
    plain = kde.smoothed_states_batch(regions, sigmas, device=CPU)
    sharded = kde.smoothed_states_batch(regions, sigmas, mesh=make_mesh(8, 'cpu'))
    assert len(sharded) == len(plain) == 16
    for s, p in zip(sharded, plain):
        assert np.array_equal(s, p)


def test_batch_equals_single_region_kernel():
    """On a pad-free grid, a one-region batch gives the states of the
    one-region kernel (_density_state_kernel) bit for bit."""
    regions, sigmas = _regions()
    n_pad = 4096
    one = np.full(n_pad, -1, dtype=np.int8)
    one[:len(regions[0])] = regions[0]
    state, _ = kde._density_state_kernel(
        torch.from_numpy(one), torch.tensor(sigmas[0], dtype=torch.float32), n_pad, 3)
    rebatched = kde.smoothed_states_batch(
        [np.concatenate([regions[0], np.full(n_pad - len(regions[0]) - 1, -1, np.int8)])],
        [sigmas[0]], device=CPU)[0][:len(regions[0])]
    assert np.array_equal(state.numpy()[:len(regions[0])], rebatched)


def test_batch_needs_a_device():
    regions, sigmas = _regions(count=3)
    with pytest.raises(ValueError, match='device'):
        kde.smoothed_states_batch(regions, sigmas)
    with pytest.raises(ValueError, match='device'):
        kde.smoothed_states_batch(regions, sigmas, mesh=make_mesh(2, 'cpu'))
    assert kde.smoothed_states_batch([], [], device=CPU) == []
