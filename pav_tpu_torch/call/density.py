"""K-mer orientation density for inversion calling.

Parity with the reference engine (pavlib/density.py:29-361 and
scripts/density.py): per-k-mer FWD/REV/FWDREV state from reference-set
membership, low-count-state removal, Scott-rule Gaussian density per state
scaled by state counts, spike clamping, argmax smoothing, and run-length
encoding. The density itself is computed exactly at every position via the FFT
kernel (pav_tpu_torch.ops.kde) instead of sampled evaluation + interpolation over a
process pool, and runs in-process (no subprocess/base64-pickle protocol:
pavlib/inv.py:249-288 replaced by a function call).

States: 0=FWD, 1=FWDREV, 2=REV, -1=NA (k-mer absent from reference region).
"""

import numpy as np
import pandas as pd

from pav_tpu import kmer as km
from pav_tpu.constants import ERR_INV_FAIL  # noqa: F401  (re-exported for callers)

from ..ops import kde

DENSITY_COLUMNS = ['INDEX', 'STATE_MER', 'STATE', 'KERN_FWD', 'KERN_FWDREV', 'KERN_REV', 'KMER']

# Max occurrences of a k-mer in the reference region before the region is
# considered low-complexity and the scan aborts (reference: scripts/density.py:47).
MAX_REF_KMER_COUNT = 100


class LowComplexityRegion(Exception):
    """Raised when the reference region's k-mer multiplicity indicates a
    low-complexity locus (reference soft-fail ERR_INV_FAIL path:
    scripts/density.py:516-527)."""


def ref_kmer_set(ref_region_codes, k_util, max_count=MAX_REF_KMER_COUNT):
    """Unique k-mers of the reference region; raises LowComplexityRegion when
    any k-mer occurs more than max_count times."""
    kmers, valid = km.kmer_codes(ref_region_codes, k_util.k_size)
    kmers = kmers[valid]
    if len(kmers) == 0:
        return np.zeros(0, dtype=np.uint64)
    uniq, counts = np.unique(kmers, return_counts=True)
    if counts.max() > max_count:
        raise LowComplexityRegion(
            f'K-mer count exceeds max ({counts.max()} > {max_count})')
    return uniq


def get_smoothed_density(
        tig_region_codes, ref_kmers_sorted, k_util,
        min_informative_kmers=2000, density_smooth_factor=1.0,
        min_state_count=20, with_density=True, device=None):
    """Smoothed k-mer orientation density table for a contig region.

    :param tig_region_codes: uint8 codes of the contig region (already oriented).
    :param ref_kmers_sorted: sorted uint64 array of reference-region k-mers.
    :param k_util: KmerUtil.
    :param device: torch.device for the FFT path of large grids.

    :return: DataFrame with DENSITY_COLUMNS, indexed by INDEX (contig k-mer
        offset within the region). Empty when not enough informative k-mers.
    """
    k = k_util.k_size
    kmers, valid = km.kmer_codes(tig_region_codes, k)
    idx = np.nonzero(valid)[0]
    kmers = kmers[idx]

    empty = pd.DataFrame([], columns=DENSITY_COLUMNS)
    if len(kmers) == 0:
        return empty

    in_fwd = km.in_sorted(ref_kmers_sorted, kmers)
    in_rev = km.in_sorted(ref_kmers_sorted, k_util.rev_complement(kmers))

    # State matrix (reference: pavlib/density.py:19-24).
    state = np.full(len(kmers), -1, dtype=np.int8)
    state[in_fwd & ~in_rev] = 0
    state[in_fwd & in_rev] = 1
    state[~in_fwd & in_rev] = 2

    keep = state != -1
    # Remove low-count states (density spike suppression,
    # reference: pavlib/density.py:107-117).
    for s in range(3):
        cnt = int((state == s).sum())
        if 0 < cnt < min_state_count:
            keep &= state != s

    idx = idx[keep]
    kmers = kmers[keep]
    state = state[keep]
    n = len(state)

    if n < min_informative_kmers or np.all(state == 0):
        return empty

    bw_factor = n ** (-1.0 / 5.0) * density_smooth_factor
    sigmas = kde.scott_sigmas(state, bw_factor)
    # Histogram, convolution, spike clamp (reference: pavlib/density.py:311-313)
    # and argmax run on device; densities transfer only when requested.
    smoothed, dens = kde.smoothed_states(state, sigmas, with_density=with_density,
                                         device=device)

    cols = {
        'INDEX': idx,
        'STATE_MER': state.astype(int),
        'STATE': smoothed.astype(int),
    }
    if dens is not None:
        cols['KERN_FWD'] = dens[0]
        cols['KERN_FWDREV'] = dens[1]
        cols['KERN_REV'] = dens[2]
    else:
        cols['KERN_FWD'] = np.nan
        cols['KERN_FWDREV'] = np.nan
        cols['KERN_REV'] = np.nan
    cols['KMER'] = kmers
    df = pd.DataFrame(cols)
    df.set_index(df['INDEX'], inplace=True, drop=False)
    return df


def rl_encoder(df, state_col='STATE'):
    """Run-length encode states: yields (state, count, first_index, last_index)
    (reference: pavlib/density.py:330-361). Vectorized."""
    if df.shape[0] == 0:
        return []
    states = df[state_col].to_numpy()
    index = df['INDEX'].to_numpy()
    boundary = np.concatenate([[True], states[1:] != states[:-1]])
    starts = np.nonzero(boundary)[0]
    ends = np.concatenate([starts[1:], [len(states)]])
    return [
        (int(states[s]), int(e - s), int(index[s]), int(index[e - 1]))
        for s, e in zip(starts, ends)
    ]
