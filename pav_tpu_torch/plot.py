"""Inversion figures: k-mer dotplots and density plots.

Parity with the reference's figure layer (pavlib/plot.py:15-415 driven by
rules/figures.snakefile): per-inversion dotplot of reference vs contig k-mers
with inner/outer/discovery annotation, and the two-pane state/density figure.
Matplotlib with the Agg backend (no display required).
"""

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt
import numpy as np

from . import kmer as km

_STATE_COLORS = {0: '#2c7fb8', 1: '#41ab5d', 2: '#e31a1c'}
_STATE_NAMES = {0: 'FWD', 1: 'FWD+REV', 2: 'REV'}


def kmer_dotplot(ref_codes, tig_codes, k=32, ax=None, title=None,
                 inner=None, outer=None, max_points=200000):
    """Dotplot of shared k-mers: forward matches ascending (blue), reverse
    matches descending (red) (reference: pavlib/plot.py:15-216 via
    kanapy.plot.dotplot)."""
    ku = km.KmerUtil(min(k, 31))
    k = ku.k_size

    ref_kmers, ref_valid = km.kmer_codes(ref_codes, k)
    tig_kmers, tig_valid = km.kmer_codes(tig_codes, k)
    ref_idx = np.nonzero(ref_valid)[0]
    tig_idx = np.nonzero(tig_valid)[0]
    ref_kmers = ref_kmers[ref_idx]
    tig_kmers = tig_kmers[tig_idx]

    order = np.argsort(ref_kmers, kind='stable')
    ref_sorted = ref_kmers[order]
    ref_pos_sorted = ref_idx[order]

    def match_positions(queries):
        lo = np.searchsorted(ref_sorted, queries, side='left')
        hi = np.searchsorted(ref_sorted, queries, side='right')
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        q_rep = np.repeat(np.arange(len(queries)), counts)
        cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.repeat(lo, counts) + (np.arange(total) - np.repeat(cum, counts))
        return q_rep, ref_pos_sorted[flat]

    fwd_q, fwd_r = match_positions(tig_kmers)
    rc = ku.rev_complement(tig_kmers)
    rev_q, rev_r = match_positions(rc)

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))

    def subsample(a, b):
        if len(a) > max_points:
            sel = np.random.default_rng(0).choice(len(a), max_points, replace=False)
            return a[sel], b[sel]
        return a, b

    fq, fr = subsample(fwd_q, fwd_r)
    rq, rr = subsample(rev_q, rev_r)
    ax.plot(fr, tig_idx[fq], '.', color='#2c7fb8', markersize=1, label='forward')
    ax.plot(rr, tig_idx[rq], '.', color='#e31a1c', markersize=1, label='reverse')

    for region, color, name in ((inner, '#41ab5d', 'inner'), (outer, '#ff7f00', 'outer')):
        if region is not None:
            ax.axvline(region[0], color=color, linestyle='--', linewidth=0.8)
            ax.axvline(region[1], color=color, linestyle='--', linewidth=0.8,
                       label=name)

    ax.set_xlabel('Reference position (bp)')
    ax.set_ylabel('Contig position (bp)')
    if title:
        ax.set_title(title)
    ax.legend(markerscale=8, fontsize=8)
    return ax


def density_plot(df_density, title=None, out_path=None):
    """Two-pane state/density figure for one inversion call
    (reference: pavlib/plot.py:219-415)."""
    fig, (ax_state, ax_dens) = plt.subplots(
        2, 1, figsize=(8, 5), sharex=True,
        gridspec_kw={'height_ratios': [1, 2]})

    idx = df_density['INDEX'].to_numpy()
    for state in (0, 1, 2):
        sel = df_density['STATE_MER'] == state
        if sel.any():
            ax_state.plot(idx[sel.to_numpy()], np.full(int(sel.sum()), state),
                          '.', markersize=1.5, color=_STATE_COLORS[state])
    ax_state.set_yticks([0, 1, 2])
    ax_state.set_yticklabels([_STATE_NAMES[s] for s in (0, 1, 2)])
    ax_state.set_ylabel('k-mer state')

    for col, state in (('KERN_FWD', 0), ('KERN_FWDREV', 1), ('KERN_REV', 2)):
        ax_dens.plot(idx, df_density[col].to_numpy(),
                     color=_STATE_COLORS[state], label=_STATE_NAMES[state])
    ax_dens.set_xlabel('Contig k-mer index')
    ax_dens.set_ylabel('Scaled density')
    ax_dens.legend(fontsize=8)
    if title:
        ax_state.set_title(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig
