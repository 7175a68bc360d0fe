"""Redundant-FAIL-call resolution.

Alignment trimming removes the same variant region from multiple overlapping
alignment records, so one real event can appear as several TRIM-filtered calls.
Parity with the reference's intersect machinery
(rules/call.snakefile:287-485): TRIM-failed calls are grouped per best source
alignment, intersected (svmerge) against the PASS set and each other, and only
one representative per site is kept in the nonredundant FAIL set; calls
intersecting a PASS variant move to the redundant set.
"""

import pandas as pd

from . import merge as svmerge


def intersect_fail(df_pass, df_fail, df_align_none, strategy):
    """Build the intersect table of FAIL calls vs PASS + per-alignment groups.

    :param df_pass: PASS variant table (one varsvtype).
    :param df_fail: FAIL variant table.
    :param df_align_none: trim-none alignment table (MAPQ/length priority).
    :param strategy: merge strategy string for this variant type.

    :return: DataFrame with ID, SOURCE (comma list), VARIANTS (comma list) per
        merged site (column naming parity: rules/call.snakefile:455-478).
    """
    cols = ['#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'ALIGN_INDEX', 'FILTER']
    extra = [c for c in ('REF', 'ALT', 'SEQ') if c in df_fail.columns]

    df_pass = df_pass[[c for c in cols + extra if c in df_pass.columns]].copy()
    df_fail = df_fail[[c for c in cols + extra if c in df_fail.columns]].copy()

    if df_fail.shape[0] == 0:
        return pd.DataFrame([], columns=['ID', 'SOURCE', 'VARIANTS'])

    is_trim = df_fail['FILTER'].astype(str).apply(lambda v: 'TRIM' in v.split(','))
    df_fail_trim = df_fail.loc[is_trim]
    df_fail_notrim = df_fail.loc[~is_trim]

    if df_fail_notrim.shape[0] > 0:
        df_pass = (pd.concat([df_pass, df_fail_notrim], axis=0)
                   if df_pass.shape[0] else df_fail_notrim)

    if df_fail_trim.shape[0] == 0:
        return pd.DataFrame([], columns=['ID', 'SOURCE', 'VARIANTS'])
    df_fail = df_fail_trim.copy()

    # Alignment priority: ascending (MAPQ, aligned length, INDEX); the last
    # entry is the best (reference: rules/call.snakefile:413-427).
    align = df_align_none[['INDEX', 'QRY_POS', 'QRY_END', 'MAPQ']].copy()
    needed = set()
    for val in df_fail['ALIGN_INDEX']:
        needed |= {int(v) for v in str(val).split(',')}
    align = align.loc[align['INDEX'].astype(int).isin(needed)].copy()
    align['LEN'] = align['QRY_END'] - align['QRY_POS']
    index_list = list(align.sort_values(['MAPQ', 'LEN', 'INDEX'])['INDEX'].astype(int))

    chosen = []
    for val in df_fail['ALIGN_INDEX']:
        aset = {int(v) for v in str(val).split(',')}
        chosen.append([v for v in index_list if v in aset][-1])
    df_fail = df_fail.copy()
    df_fail['ALIGN_INDEX'] = chosen

    used = set(chosen)
    index_list = [v for v in index_list if v in used]

    bed_list = [df_pass]
    names = ['PASS']
    for idx in index_list:
        bed_list.append(df_fail.loc[df_fail['ALIGN_INDEX'] == idx])
        names.append(f'TRIM_{idx}')

    merged = svmerge.merge_variants(bed_list, names, strategy)
    if merged.shape[0] == 0:
        return pd.DataFrame([], columns=['ID', 'SOURCE', 'VARIANTS'])

    out = pd.DataFrame({
        'ID': merged['ID'],
        'SOURCE': merged['MERGE_SAMPLES'].apply(lambda v: ','.join(
            (s[5:] if s.startswith('TRIM_') else s) for s in str(v).split(','))),
        'VARIANTS': merged['MERGE_VARIANTS'],
    })
    # SOURCE keeps the raw sample list for the PASS test below.
    out['SOURCE_RAW'] = merged['MERGE_SAMPLES']
    return out


def filter_redundant(df_fail, df_intersect):
    """Split the FAIL table into nonredundant and redundant sets
    (reference: rules/call.snakefile:287-327)."""
    if df_fail.shape[0] == 0:
        return df_fail.copy(), df_fail.copy()

    id_set = set(df_fail.loc[
        df_fail['FILTER'].astype(str).apply(lambda v: 'TRIM' not in v.split(',')), 'ID'])

    if df_intersect.shape[0] > 0:
        dfi = df_intersect
        dfi = dfi.loc[dfi['VARIANTS'].apply(
            lambda v: len(set(str(v).split(',')) & id_set) == 0)]
        src_col = 'SOURCE_RAW' if 'SOURCE_RAW' in dfi.columns else 'SOURCE'
        dfi = dfi.loc[~dfi[src_col].astype(str).str.startswith('PASS')]
        id_set |= set(dfi['VARIANTS'].apply(lambda v: str(v).split(',')[0]))

    keep = df_fail['ID'].isin(id_set)
    return df_fail.loc[keep].copy(), df_fail.loc[~keep].copy()


def resolve_fail_redundancy(df_pass, df_fail, df_align_none, strategy):
    """End-to-end: returns (df_fail_nonredundant, df_fail_redundant)."""
    df_int = intersect_fail(df_pass, df_fail, df_align_none, strategy)
    return filter_redundant(df_fail, df_int)
