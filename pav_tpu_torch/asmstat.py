"""Assembly statistics (reference: pavlib/asmstat.py:13-80)."""

import numpy as np
import pandas as pd


def n50(lengths, genome_size=None):
    """N50 (or NG50 when genome_size given): length of the contig at which the
    cumulative sorted-descending length crosses half the total (or half the
    genome size)."""
    lengths = np.sort(np.asarray(lengths))[::-1]
    if len(lengths) == 0:
        return 0
    half = (genome_size if genome_size is not None else lengths.sum()) / 2
    cum = np.cumsum(lengths)
    idx = np.searchsorted(cum, half)
    if idx >= len(lengths):
        return 0
    return int(lengths[idx])


def asm_stats(seq_store, genome_size=None):
    """Contig count, total bp, N50, NG50, max/min contig length."""
    lengths = [seq_store.length(name) for name in seq_store.names()]
    total = int(np.sum(lengths)) if lengths else 0
    return pd.Series({
        'CONTIGS': len(lengths),
        'TOTAL_BP': total,
        'N50': n50(lengths),
        'NG50': n50(lengths, genome_size) if genome_size else np.nan,
        'MAX_LEN': int(np.max(lengths)) if lengths else 0,
        'MIN_LEN': int(np.min(lengths)) if lengths else 0,
    })
