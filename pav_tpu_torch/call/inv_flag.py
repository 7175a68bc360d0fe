"""Inversion signature flagging from variant calls.

Parity with the reference's flagging rules (rules/call_inv.snakefile:480-692
and 321-477): matched INS/DEL pairs (SV and indel scale), indel clusters, and
SNV clusters are merged into flagged regions annotated with signature types and
an accept filter. Interval work is vectorized over sorted arrays.
"""

import numpy as np
import pandas as pd

from ..util import IntervalIndex

FLAG_COLUMNS = ['#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'TYPE',
                'COUNT_INDEL', 'COUNT_SNV', 'TRY_INV', 'BATCH']


def flag_insdel_cluster(df_insdel, vartype, flank_cluster=2, flank_merge=2000,
                        cluster_min_svlen=4, strict_parity=False):
    """Matched INS/DEL flagging: for each INS, find DELs within SVLEN*flank of
    its position; flag the span of matching DELs
    (reference: rules/call_inv.snakefile:480-603).

    strict_parity replicates a reference BUG: the rule's interval-merge loop
    (call_inv.snakefile:558-594) never flushes the final open region after
    the loop, silently dropping the last flagged region of the last
    chromosome. Default behavior keeps it."""
    df = df_insdel
    if 'FILTER' in df.columns:
        df = df.loc[df['FILTER'] == 'PASS']
    svlen_min = cluster_min_svlen if vartype == 'indel' else 50
    df = df.loc[df['SVLEN'] >= svlen_min]
    if vartype == 'indel':
        df = df.loc[df['SVLEN'] < 50]

    if df.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])

    df_ins = df.loc[df['SVTYPE'] == 'INS']
    df_del = df.loc[df['SVTYPE'] == 'DEL']
    if df_ins.shape[0] == 0 or df_del.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])

    # Vectorized per chromosome: for INS i with window [lo_i, hi_i), the
    # matching DELs are {j: dpos[j] < hi_i and dend[j] > lo_i} (IntervalIndex
    # overlap semantics). With DELs sorted by POS and a running max of END:
    # the FIRST hit (min POS) is the first j where cummax_end exceeds lo_i,
    # and the max END among hits is the prefix max at the last j with
    # dpos < hi_i — both single searchsorted calls per query batch.
    frames = []
    for chrom, sub_del in df_del.groupby('#CHROM'):
        sub_ins = df_ins.loc[df_ins['#CHROM'] == chrom]
        if sub_ins.shape[0] == 0:
            continue
        order = np.argsort(sub_del['POS'].to_numpy(), kind='stable')
        dpos = sub_del['POS'].to_numpy()[order]
        dend = sub_del['END'].to_numpy()[order]
        cummax_end = np.maximum.accumulate(dend)
        ipos = sub_ins['POS'].to_numpy().astype(np.int64)
        flank = sub_ins['SVLEN'].to_numpy().astype(np.int64) * flank_cluster
        lo = ipos - flank
        hi = ipos + flank
        r = np.searchsorted(dpos, hi, side='left')
        j0 = np.searchsorted(cummax_end, lo, side='right')
        has = (r > 0) & (j0 < r) & (lo < hi)
        if not has.any():
            continue
        end_max = cummax_end[np.maximum(r - 1, 0)]
        has &= end_max > lo
        frames.append(pd.DataFrame({
            '#CHROM': chrom,
            'POS': dpos[np.minimum(j0[has], len(dpos) - 1)],
            'END': end_max[has],
        }))

    if not frames:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])
    df_match = pd.concat(frames, ignore_index=True)
    # Merge intervals within flank_merge of each other (pad retained as span
    # extension is not applied in the reference; merge on raw bounds with gap
    # tolerance).
    return _merge_gap(df_match, flank_merge, drop_final=strict_parity)


def _merge_gap(df, gap, drop_final=False):
    """Merge sorted intervals whose start is within `gap` of the previous end
    (bounds kept unpadded; reference: rules/call_inv.snakefile:546-594).
    drop_final replicates the reference's missing final flush (see
    flag_insdel_cluster)."""
    df = df.sort_values(['#CHROM', 'POS']).reset_index(drop=True)
    if df.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])
    chrom = df['#CHROM'].to_numpy()
    pos = df['POS'].to_numpy(dtype=np.int64)
    end = df['END'].to_numpy(dtype=np.int64)
    # Boundary at i iff the chromosome changes or pos[i] - gap exceeds the
    # running max END of the open region. With POS sorted, the region's
    # running max equals the per-chromosome prefix cummax: if cummax[i-1]
    # reaches pos[i] - gap via some earlier row j, every row k in (j, i]
    # chains (pos[k] - gap <= pos[i] - gap <= end[j]), so j and i share a
    # region regardless of where earlier boundaries fell.
    boundary = np.ones(len(pos), dtype=bool)
    seg = np.nonzero(np.concatenate([[True], chrom[1:] != chrom[:-1]]))[0]
    for s, e in zip(seg, np.append(seg[1:], len(pos))):
        cm = np.maximum.accumulate(end[s:e])
        boundary[s + 1:e] = pos[s + 1:e] - gap > cm[:-1]
    starts = np.nonzero(boundary)[0]
    out = pd.DataFrame({
        '#CHROM': chrom[starts],
        'POS': pos[starts],
        'END': np.maximum.reduceat(end, starts),
    })
    if drop_final and out.shape[0]:
        out = out.iloc[:-1].reset_index(drop=True)
    return out


def flag_cluster(df, vartype, cluster_win=200, cluster_win_min=500,
                 cluster_min_snv=20, cluster_min_indel=10):
    """Cluster flagging for SNVs or indels
    (reference: rules/call_inv.snakefile:603-692)."""
    if df.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END', 'COUNT'])
    if 'FILTER' in df.columns:
        df = df.loc[df['FILTER'] == 'PASS']
    if vartype == 'indel':
        df = df.loc[df['SVLEN'] < 50]
        cluster_min = cluster_min_indel
    elif vartype == 'snv':
        cluster_min = cluster_min_snv
    else:
        raise ValueError(f'Bad variant type: {vartype}')

    df = df.sort_values(['#CHROM', 'POS'])
    if df.shape[0] == 0:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END', 'COUNT'])
    mid = ((df['END'].to_numpy(dtype=np.int64)
            + df['POS'].to_numpy(dtype=np.int64)) // 2)
    chroms = df['#CHROM'].to_numpy()

    # The chain test is pairwise (each row against the PREVIOUS row's
    # midpoint, not a running max), so boundaries come from one shifted
    # comparison; regions are the runs between boundaries.
    boundary = np.concatenate(
        [[True], (chroms[1:] != chroms[:-1]) | (mid[1:] >= mid[:-1] + cluster_win)])
    starts = np.nonzero(boundary)[0]
    last = np.append(starts[1:], len(mid)) - 1
    count = np.append(starts[1:], len(mid)) - starts
    cpos = mid[starts]
    cend = mid[last]
    keep = (count >= cluster_min) & ((cend - cpos) >= cluster_win_min)
    return pd.DataFrame({
        '#CHROM': chroms[starts[keep]],
        'POS': cpos[keep],
        'END': cend[keep],
        'COUNT': count[keep],
    })


def merge_flagged_loci(df_insdel_sv, df_insdel_indel, df_cluster_indel,
                       df_cluster_snv, flank=500, batch_count=60,
                       inv_sig_filter='svindel'):
    """Merge all flag sources into annotated flagged regions with TRY_INV and
    round-robin batch assignment (reference: rules/call_inv.snakefile:321-477)."""
    allow_single_cluster = False
    match_any = set()
    if inv_sig_filter is not None:
        if inv_sig_filter == 'single_cluster':
            allow_single_cluster = True
        elif inv_sig_filter == 'svindel':
            match_any |= {'MATCH_SV', 'MATCH_INDEL'}
        elif inv_sig_filter == 'sv':
            match_any.add('MATCH_SV')
        else:
            raise ValueError(f'Unrecognized region filter: {inv_sig_filter}')

    # Flag tags as a bitmask so the per-region union is one reduceat.
    _TAG_BITS = {'MATCH_SV': 1, 'MATCH_INDEL': 2, 'CLUSTER_INDEL': 4,
                 'CLUSTER_SNV': 8}
    frames = []
    for df_src, type_tag, count_col in (
            (df_insdel_sv, 'MATCH_SV', None),
            (df_insdel_indel, 'MATCH_INDEL', None),
            (df_cluster_indel, 'CLUSTER_INDEL', 'COUNT_INDEL'),
            (df_cluster_snv, 'CLUSTER_SNV', 'COUNT_SNV')):
        if df_src.shape[0] == 0:
            continue
        sub = df_src[['#CHROM', 'POS', 'END']].copy()
        sub['COUNT_INDEL'] = df_src['COUNT'].to_numpy() if count_col == 'COUNT_INDEL' else 0
        sub['COUNT_SNV'] = df_src['COUNT'].to_numpy() if count_col == 'COUNT_SNV' else 0
        sub['TYPE_BIT'] = _TAG_BITS[type_tag]
        frames.append(sub)

    if not frames:
        return pd.DataFrame([], columns=FLAG_COLUMNS)

    df = pd.concat(frames, axis=0).sort_values(['#CHROM', 'POS'])

    # Columnar interval chaining (the reference chains each row to the
    # PREVIOUS row's END + flank, not a running max: call_inv.snakefile
    # region merge): a region boundary is a chrom change or a gap.
    chrom_a = df['#CHROM'].to_numpy()
    pos_a = df['POS'].to_numpy(dtype=np.int64)
    end_a = df['END'].to_numpy(dtype=np.int64)
    bits_a = df['TYPE_BIT'].to_numpy(dtype=np.int64)
    ci_a = df['COUNT_INDEL'].to_numpy(dtype=np.int64)
    cs_a = df['COUNT_SNV'].to_numpy(dtype=np.int64)

    joined = (chrom_a[1:] == chrom_a[:-1]) & (pos_a[1:] < end_a[:-1] + flank)
    starts = np.nonzero(np.concatenate([[True], ~joined]))[0]
    last = np.append(starts[1:], len(pos_a)) - 1

    r_chrom = chrom_a[starts]
    r_pos = pos_a[starts]
    r_end = end_a[last]          # last joined row's END (reference semantics)
    r_bits = np.bitwise_or.reduceat(bits_a, starts)
    r_ci = np.add.reduceat(ci_a, starts)
    r_cs = np.add.reduceat(cs_a, starts)

    _BIT_TAGS = {v: k for k, v in _TAG_BITS.items()}
    type_sets = [{_BIT_TAGS[b] for b in _TAG_BITS.values() if m & b}
                 for m in r_bits.tolist()]
    svlen = r_end - r_pos
    ids = pd.Series(r_chrom).astype(str) + '-' + pd.Series(r_pos).astype(str) \
        + '-RGN-' + pd.Series(svlen).astype(str)
    out = pd.DataFrame({
        '#CHROM': r_chrom, 'POS': r_pos, 'END': r_end, 'ID': ids.to_numpy(),
        'SVTYPE': 'RGN', 'SVLEN': svlen, 'TYPE': type_sets,
        'COUNT_INDEL': r_ci, 'COUNT_SNV': r_cs})
    out = out.sort_values(['#CHROM', 'POS']).reset_index(drop=True)

    def accept(type_set):
        if not allow_single_cluster and type_set in ({'CLUSTER_SNV'}, {'CLUSTER_INDEL'}):
            return False
        if match_any and not (type_set & match_any):
            return False
        return True

    out['TRY_INV'] = out['TYPE'].apply(accept)
    out['BATCH'] = -1
    try_idx = np.nonzero(out['TRY_INV'].to_numpy())[0]
    out.iloc[try_idx, out.columns.get_loc('BATCH')] = \
        np.arange(len(try_idx)) % batch_count

    out['TYPE'] = out['TYPE'].apply(lambda vals: ','.join(sorted(vals)))
    return out
