"""Gaussian KDE over integer positions as FFT convolution (port of
pav_tpu.ops.kde).

Because evaluation points are exactly the integer grid 0..n-1 and the data
points are a subset of that grid, the scaled KDE
  count_s * KDE_s(x) = sum_i N(x; p_i, sigma_s^2)
is exactly the linear convolution of the state's indicator histogram with a
Gaussian kernel, computed for every position at once with real FFTs.

Small grids (n <= 2^14) run on the host in float64 numpy, exactly as the
reference does. Larger grids run ``torch.fft`` in float32 on the device the
caller names: the Gaussian kernels are built there from the 3 sigmas with
full +-n_pad support (exact for every evaluated position, since data and
grid both lie in [0, n) with n <= n_pad), then histogram, convolution, spike
clamp and argmax, as ``pav_tpu.ops.kde._density_state_kernel`` does.
``smoothed_states_batch`` runs the same steps on a batch of regions padded
to one grid, optionally split by regions over a device mesh.
"""

import numpy as np
import torch

from ..parallel.mesh import on_device, place_batch

_TRUNC_SIGMAS = 8.0  # kernel support half-width in sigmas (host path)

# Grids at or below this run on the host (numpy float64 FFT).
_HOST_FFT_MAX = 1 << 14


def _next_pow2(x):
    n = 1
    while n < x:
        n <<= 1
    return n


def _conv_batch(hist, kernels, fft_len):
    """hist: [B, n] float32, kernels: [B, kw] float32 (kw odd, centred).
    Linear convolution, same size as hist: [B, n]."""
    half = kernels.shape[1] // 2
    H = torch.fft.rfft(hist, n=fft_len, dim=1)
    K = torch.fft.rfft(kernels, n=fft_len, dim=1)
    full = torch.fft.irfft(H * K, n=fft_len, dim=1)
    return full[:, half:half + hist.shape[1]]


def _density_state_kernel_batch(state_mers, sigmas, n_pad, n_states):
    """Batched ``_density_state_kernel``: state_mers int8 [B, n_pad], sigmas
    float32 [B, n_states] on one device. Returns (state int8 [B, n_pad],
    dens float32 [B, n_states, n_pad]); every step is independent per row.
    The Gaussians are built on the device with +-n_pad support."""
    dev = sigmas.device
    x = torch.arange(-n_pad, n_pad + 1, dtype=torch.float32, device=dev)
    sg = torch.clamp(sigmas[:, :, None], min=1e-30)
    kernels = torch.where(                                        # [B, S, 2n+1]
        sigmas[:, :, None] > 0,
        torch.exp(-0.5 * (x / sg) ** 2) / (sg * np.float32(np.sqrt(2 * np.pi))),
        torch.zeros((), dtype=torch.float32, device=dev))
    hist = torch.stack([(state_mers == s).to(torch.float32)
                        for s in range(n_states)], dim=1)         # [B, S, n]
    fft_len = 4 * n_pad  # >= n_pad + (2*n_pad+1) - 1, pow2
    H = torch.fft.rfft(hist, n=fft_len, dim=2)
    K = torch.fft.rfft(kernels, n=fft_len, dim=2)
    full = torch.fft.irfft(H * K, n=fft_len, dim=2)
    dens = full[:, :, n_pad:2 * n_pad]
    dens = torch.where(dens > 1.0, 1.0 / torch.clamp(dens, min=1e-30), dens)
    state = torch.argmax(dens, dim=1).to(torch.int8)              # [B, n]
    return state, dens


def smoothed_states_batch(state_mers, sigmas_list, n_states=3, mesh=None,
                          device=None):
    """A batch of independent density-smoothing problems in one FFT pass.

    Regions pad to a common power-of-two grid (label -1 past each region).
    With a ``mesh`` (``parallel.mesh``) whose size divides the batch, the
    regions split into equal shards, one per mesh device; otherwise the
    batch runs on ``device``.

    :param state_mers: list of int arrays (state labels per position).
    :param sigmas_list: list of per-state sigma arrays.
    :return: list of int8 state arrays, one per input, unpadded.
    """
    if not state_mers:
        return []
    lens = [len(s) for s in state_mers]
    n_pad = _next_pow2(max(max(lens), 16))
    B = len(state_mers)
    batch = np.full((B, n_pad), -1, dtype=np.int8)
    for i, s in enumerate(state_mers):
        batch[i, :lens[i]] = np.asarray(s, dtype=np.int8)
    sig = np.asarray(sigmas_list, dtype=np.float32).reshape(B, n_states)
    placed = place_batch([torch.from_numpy(batch), torch.from_numpy(sig)],
                         mesh, device)
    states = []
    for dev, (b, sg) in placed:        # launch every shard, then collect
        with on_device(dev):
            states.append(_density_state_kernel_batch(b, sg, n_pad, n_states)[0])
    state_np = torch.cat([s.cpu() for s in states]).numpy()
    return [state_np[i, :lens[i]] for i in range(B)]


def _density_state_kernel(state_mer, sigmas, n_pad, n_states):
    """state_mer: int8 [n_pad] tensor (0..n_states-1, or -1 padding);
    sigmas: float32 [n_states] tensor on the same device. Returns (state int8
    [n_pad], dens float32 [n_states, n_pad]) on that device."""
    state, dens = _density_state_kernel_batch(state_mer[None], sigmas[None],
                                              n_pad, n_states)
    return state[0], dens[0]


def _host_density_states(state_mer, sigmas, n_states):
    """Host numpy path for small grids: float64 FFT (closer to the scipy
    reference), float32 clamp + argmax to match the device's decision
    arithmetic."""
    n = len(state_mer)
    hist = np.zeros((n_states, n), dtype=np.float64)
    for s in range(n_states):
        hist[s, np.nonzero(state_mer == s)[0]] = 1.0

    max_sigma = float(np.max(sigmas)) if len(sigmas) else 0.0
    half = min(int(np.ceil(_TRUNC_SIGMAS * max(max_sigma, 1.0))), n)
    x = np.arange(-half, half + 1, dtype=np.float64)
    kernels = np.zeros((n_states, 2 * half + 1), dtype=np.float64)
    for s in range(n_states):
        sg = sigmas[s]
        if sg > 0 and np.any(state_mer == s):
            kernels[s] = np.exp(-0.5 * (x / sg) ** 2) / (sg * np.sqrt(2 * np.pi))

    fft_len = _next_pow2(n + 2 * half + 1)
    H = np.fft.rfft(hist, n=fft_len, axis=1)
    K = np.fft.rfft(kernels, n=fft_len, axis=1)
    full = np.fft.irfft(H * K, n=fft_len, axis=1)
    dens = full[:, half:half + n].astype(np.float32)
    dens = np.where(dens > 1.0, np.float32(1.0) / np.maximum(dens, 1e-30), dens)
    state = np.argmax(dens, axis=0).astype(np.int8)
    return state, dens


def smoothed_states(state_mer, sigmas, n_states=3, with_density=False,
                    device=None):
    """Density-smoothed state per grid position.

    :param state_mer: int array [n] of state labels in [0, n_states).
    :param sigmas: per-state Gaussian sigma.
    :param device: torch.device for grids above ``_HOST_FFT_MAX``.

    :return: (state int8 [n], dens float32 [n_states, n] or None), numpy.
    """
    state_mer = np.asarray(state_mer, dtype=np.int8)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(state_mer)

    if n <= _HOST_FFT_MAX:
        state_np, dens = _host_density_states(state_mer, sigmas, n_states)
        return state_np, (dens if with_density else None)

    if device is None:
        raise ValueError(f'a {n}-point density grid needs a torch device')
    n_pad = _next_pow2(max(n, 16))
    padded = np.full(n_pad, -1, dtype=np.int8)
    padded[:n] = state_mer
    state, dens = _density_state_kernel(
        torch.from_numpy(padded).to(device),
        torch.tensor(sigmas, dtype=torch.float32, device=device),
        n_pad, n_states)
    state_np = state[:n].cpu().numpy()
    if with_density:
        return state_np, dens[:, :n].cpu().numpy()
    return state_np, None


def gaussian_density_states(state_mer, sigmas, n_states=3):
    """Per-state scaled KDE at every grid position (spike clamp NOT applied;
    exact scipy-parity values). float32 array [n_states, n]. Host float64
    FFT: this is the scipy-parity evaluation surface."""
    state_mer = np.asarray(state_mer)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(state_mer)
    n_states = int(n_states)

    hist = np.zeros((n_states, n), dtype=np.float64)
    for s in range(n_states):
        hist[s, np.nonzero(state_mer == s)[0]] = 1.0

    max_sigma = float(np.max(sigmas)) if len(sigmas) else 0.0
    half = min(int(np.ceil(_TRUNC_SIGMAS * max(max_sigma, 1.0))), max(n, 1))
    x = np.arange(-half, half + 1, dtype=np.float64)
    kernels = np.zeros((n_states, 2 * half + 1), dtype=np.float64)
    for s in range(n_states):
        sg = sigmas[s]
        if sg > 0 and np.any(state_mer == s):
            kernels[s] = np.exp(-0.5 * (x / sg) ** 2) / (sg * np.sqrt(2 * np.pi))

    fft_len = _next_pow2(n + 2 * half + 1)
    H = np.fft.rfft(hist, n=fft_len, axis=1)
    K = np.fft.rfft(kernels, n=fft_len, axis=1)
    full = np.fft.irfft(H * K, n=fft_len, axis=1)
    return full[:, half:half + n].astype(np.float32)


def scott_sigmas(state_mer, bw_factor, n_states=3):
    """Per-state sigma replicating scipy.stats.gaussian_kde with a scalar
    bw_method: sigma_s = bw_factor * std(points_s, ddof=1)."""
    state_mer = np.asarray(state_mer)
    sigmas = np.zeros(n_states, dtype=np.float64)
    for s in range(n_states):
        pts = np.nonzero(state_mer == s)[0]
        if len(pts) > 1:
            sigmas[s] = bw_factor * np.std(pts, ddof=1)
        elif len(pts) == 1:
            # scipy would fail on singular covariance; a point mass with tiny
            # sigma keeps the state representable (low-count states are removed
            # upstream with min_state_count anyway).
            sigmas[s] = bw_factor
    return sigmas
