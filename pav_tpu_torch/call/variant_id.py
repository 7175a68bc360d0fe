"""Variant ID construction and versioning (svpoplib.variant equivalents;
call sites: pavlib/cigarcall.py:318, pavlib/call.py:25-96)."""

import numpy as np
import pandas as pd


def version_id(id_series, existing_id_set=None):
    """De-duplicate variant IDs by appending ".1", ".2", ... to repeats.

    The first occurrence keeps the bare ID (unless it collides with
    existing_id_set); later occurrences get the lowest free version.
    """
    existing = set(existing_id_set) if existing_id_set else set()
    vals = (id_series.to_numpy(dtype=object) if isinstance(id_series, pd.Series)
            else np.array(list(id_series), dtype=object))
    # Fast path: no duplicates and no collisions -> IDs pass through as-is.
    if pd.Index(vals).is_unique and (
            not existing or not any(v in existing for v in vals)):
        if isinstance(id_series, pd.Series):
            return pd.Series(vals, index=id_series.index)
        return list(vals)
    next_version = {}
    out = []
    for vid in vals:
        if vid not in next_version and vid not in existing:
            next_version[vid] = 1
            out.append(vid)
            continue
        n = next_version.get(vid, 1)
        new_id = f'{vid}.{n}'
        while new_id in existing or new_id in next_version:
            n += 1
            new_id = f'{vid}.{n}'
        next_version[vid] = n + 1
        next_version[new_id] = 1
        out.append(new_id)
    if isinstance(id_series, pd.Series):
        return pd.Series(out, index=id_series.index)
    return out


def get_variant_id(df, apply_version=True):
    """Construct IDs from table fields: CHROM-POS1-SVTYPE-{SVLEN | REF+ALT
    for SNV}. Columnar string build (no per-row loop)."""
    if df.shape[0] == 0:
        ids = pd.Series([], dtype=object, index=df.index)
        return version_id(ids) if apply_version else ids
    svtype = df['SVTYPE'].astype(str)
    base = (df['#CHROM'].astype(str) + '-'
            + (df['POS'] + 1).astype(str) + '-' + svtype + '-')
    is_snv = (svtype == 'SNV').to_numpy()
    sv_tail = (df['SVLEN'].astype(str).to_numpy() if 'SVLEN' in df.columns
               else np.full(df.shape[0], '', dtype=object))
    if is_snv.any():
        snv_tail = (df['REF'].astype(str).str.upper()
                    + df['ALT'].astype(str).str.upper()).to_numpy()
        tail = np.where(is_snv, snv_tail, sv_tail)
    else:
        tail = sv_tail
    ids = base + pd.Series(tail, index=df.index)
    return version_id(ids) if apply_version else ids


def version_variant_bed_id(df, re_version=False):
    """Re-version IDs in a call table, PASS records first
    (reference: pavlib/call.py:25-96)."""
    work = pd.DataFrame(index=df.index)
    work['ID'] = df['ID'] if 'ID' in df.columns else get_variant_id(df, apply_version=False)
    work['FILTER'] = df['FILTER'] if 'FILTER' in df.columns else 'PASS'
    work['QRY_REGION'] = df['QRY_REGION'] if 'QRY_REGION' in df.columns else 'chrUn:0-0'

    if re_version:
        work['ID'] = [v.rsplit('.', 1)[0]
                      for v in work['ID'].astype(str).to_numpy(dtype=object)]

    work = work.reset_index(names='_orig')
    filt = work['FILTER'].fillna('').astype(str).to_numpy(dtype=object)
    work['FILTER'] = np.where(filt == 'PASS', 'a', 'b').astype(object) + filt
    qry = work['QRY_REGION'].astype(str).str.extract(r'^([^:]+):(\d+)-')
    work['QRY_ID'] = qry[0]
    work['QRY_POS'] = pd.to_numeric(qry[1], errors='coerce').fillna(0).astype(int)

    work = work.sort_values(['ID', 'FILTER', 'QRY_ID', 'QRY_POS'], kind='stable')

    is_pass = work['FILTER'] == 'aPASS'
    work.loc[is_pass, 'ID'] = version_id(work.loc[is_pass, 'ID'])
    work.loc[~is_pass, 'ID'] = version_id(
        work.loc[~is_pass, 'ID'], existing_id_set=set(work.loc[is_pass, 'ID']))

    work = work.sort_index()
    out = work['ID']
    out.index = df.index
    return out
