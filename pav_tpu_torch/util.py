"""General utilities (reference: pavlib/util.py)."""

import numpy as np
import pandas as pd


def as_bool(val, fail_to_none=False):
    """Interpret a value as a boolean (reference: pavlib/util.py:10-37)."""
    if isinstance(val, (bool, np.bool_)):
        return bool(val)
    sval = str(val).lower()
    if sval in {'true', '1', 'yes', 't', 'y'}:
        return True
    if sval in {'false', '0', 'no', 'f', 'n'}:
        return False
    if fail_to_none:
        return None
    raise ValueError(f'Cannot interpret as boolean value: {val}')


def merge_intervals(df, pad=0, keep_pad=False):
    """Merge intervals of a (#CHROM, POS, END) table. Intervals within `pad` of
    each other merge; by default the pad is removed from the output bounds
    (reference region_merge semantics: pavlib/util.py:40-104).

    :param df: DataFrame with #CHROM, POS, END.
    :param pad: Merge slop in bp.
    :param keep_pad: If True, output intervals keep the pad applied.
    """
    if df.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])

    df = df.sort_values(['#CHROM', 'POS', 'END'], ascending=[True, True, False]).reset_index(drop=True)

    out = []
    chrom, pos, end = None, None, None
    for row_chrom, row_pos, row_end in zip(df['#CHROM'], df['POS'], df['END']):
        row_pos, row_end = int(row_pos) - pad, int(row_end) + pad
        if row_chrom != chrom:
            if chrom is not None:
                out.append((chrom, pos, end))
            chrom, pos, end = row_chrom, row_pos, row_end
        elif row_pos <= end:
            pos = min(pos, row_pos)
            end = max(end, row_end)
        else:
            out.append((chrom, pos, end))
            pos, end = row_pos, row_end
    if chrom is not None:
        out.append((chrom, pos, end))

    res = pd.DataFrame(out, columns=['#CHROM', 'POS', 'END'])
    if pad and not keep_pad:
        res['POS'] += pad
        res['END'] -= pad
    res['POS'] = res['POS'].clip(lower=0)
    return res


def region_merge(file_list, pad=500):
    """Merge regions across BED files with slop (reference: pavlib/util.py:40-104)."""
    import os
    frames = [
        pd.read_csv(fn, sep='\t', usecols=('#CHROM', 'POS', 'END'))
        for fn in file_list if os.stat(fn).st_size > 0
    ]
    if not frames:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])
    return merge_intervals(pd.concat(frames, axis=0), pad=pad)


def collapse_to_set(lst, to_type=None):
    """Flatten nested lists/tuples into a set (reference: pavlib/util.py:107-122)."""
    stack = list(lst)
    out = set()
    while stack:
        v = stack.pop()
        if isinstance(v, (tuple, list)):
            stack.extend(v)
        else:
            out.add(to_type(v) if to_type is not None else v)
    return out


class IntervalIndex:
    """Static interval overlap index over sorted numpy arrays.

    Replaces intervaltree: build once from (start, end, payload-index) arrays;
    query via binary search. Overlap(qs, qe) = intervals with start < qe and
    end > qs. Query cost O(log n + hits) using a max-end prefix to bound the scan.
    """

    def __init__(self, starts, ends, data=None):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        order = np.argsort(starts, kind='stable')
        self.starts = starts[order]
        self.ends = ends[order]
        self.order = order
        self.data = None if data is None else [data[i] for i in order]
        # Running max of interval ends to allow early scan termination.
        self.max_end_prefix = np.maximum.accumulate(self.ends) if len(self.ends) else self.ends

    def __len__(self):
        return len(self.starts)

    def overlap_indices(self, qs, qe):
        """Indices (into the original arrays) of intervals overlapping [qs, qe)."""
        if len(self.starts) == 0 or qe <= qs:
            return np.zeros(0, dtype=np.int64)
        hi = np.searchsorted(self.starts, qe, side='left')
        # max_end_prefix is non-decreasing: every index < lo has end <= qs.
        lo = np.searchsorted(self.max_end_prefix[:hi], qs, side='right')
        sel = np.nonzero(self.ends[lo:hi] > qs)[0]
        if len(sel) == 0:
            return np.zeros(0, dtype=np.int64)
        return self.order[sel + lo]

    def overlap_join(self, qs, qe):
        """Vectorized overlap join over many queries at once.

        :param qs: int64 array of query starts.
        :param qe: int64 array of query ends.
        :return: (q_idx, iv_idx) parallel int64 arrays, one row per
            (query, interval) overlap; iv_idx indexes the ORIGINAL arrays.
            Pairs of one query appear in ascending sorted-start position
            (exactly the order overlap_indices enumerates them).
        """
        qs = np.asarray(qs, dtype=np.int64)
        qe = np.asarray(qe, dtype=np.int64)
        if len(self.starts) == 0 or len(qs) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        hi = np.searchsorted(self.starts, qe, side='left')
        # Global non-decreasing max-end prefix: positions < lo have end <= qs.
        lo = np.minimum(np.searchsorted(self.max_end_prefix, qs, side='right'), hi)
        counts = hi - lo
        q_idx = np.repeat(np.arange(len(qs), dtype=np.int64), counts)
        if len(q_idx) == 0:
            return q_idx, q_idx
        # Sorted positions lo[q] .. hi[q)-1 per query, flattened.
        cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.repeat(lo, counts) + (np.arange(len(q_idx)) - np.repeat(cum, counts))
        keep = self.ends[flat] > qs[q_idx]
        return q_idx[keep], self.order[flat[keep]]

    def any_contains(self, qs, qe):
        """True if any interval fully contains [qs, qe]."""
        if len(self.starts) == 0:
            return False
        hi = np.searchsorted(self.starts, qs, side='right')
        i = hi - 1
        while i >= 0 and self.max_end_prefix[i] >= qe:
            if self.ends[i] >= qe:
                return True
            i -= 1
        return False

    def contains_batch(self, qs, qe):
        """Vectorized any_contains over many queries: containment holds iff
        some interval has start <= qs and end >= qe, i.e. iff the running
        max-end over intervals with start <= qs reaches qe."""
        qs = np.asarray(qs, dtype=np.int64)
        qe = np.asarray(qe, dtype=np.int64)
        out = np.zeros(len(qs), dtype=bool)
        if len(self.starts) == 0 or len(qs) == 0:
            return out
        hi = np.searchsorted(self.starts, qs, side='right')
        ok = hi > 0
        out[ok] = self.max_end_prefix[hi[ok] - 1] >= qe[ok]
        return out

    def any_overlap(self, qs, qe):
        if len(self.starts) == 0 or qe <= qs:
            return False
        hi = np.searchsorted(self.starts, qe, side='left')
        i = hi - 1
        while i >= 0 and self.max_end_prefix[i] > qs:
            if self.ends[i] > qs:
                return True
            i -= 1
        return False


def join_ragged(flat, starts, counts, delim):
    """Delimiter-join contiguous ragged groups of an object string array.

    Equivalent to ``[delim.join(flat[s:s+c]) for s, c in zip(starts, counts)]``
    but vectorized over groups: one elementwise-concat pass per extra member,
    so cost scales with the number of multi-member groups (small for diploid
    merges) instead of paying a join + slice per row.
    """
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if len(starts) == 0:
        return np.zeros(0, dtype=object)
    out = flat[starts].copy()
    out[counts == 0] = ''   # contract: zero-member groups join to ''
    kmax = int(counts.max()) if len(counts) else 0
    for k in range(1, kmax):
        m = counts > k
        if not m.any():
            break
        out[m] = out[m] + delim
        out[m] = out[m] + flat[starts[m] + k]
    return out


def build_interval_index_by_chrom(df, pos_col='POS', end_col='END', chrom_col='#CHROM'):
    """{chrom: IntervalIndex over row positions of df}."""
    out = {}
    for chrom, sub in df.groupby(chrom_col):
        out[chrom] = IntervalIndex(
            sub[pos_col].to_numpy(), sub[end_col].to_numpy(),
            data=list(sub.index),
        )
    return out
