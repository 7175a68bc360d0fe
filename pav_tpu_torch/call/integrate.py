"""Callset integration: per-haplotype source merging, filters, depth
annotation, PASS/FAIL split, and the diploid haplotype merge.

Parity with the reference integration rule (rules/call.snakefile:488-747) and
merge machinery (pavlib/call.py:99-533, 650-733): QRY_FILTER regions, inversion
SVLEN bounds, COMPOUND filtering of small variants inside larger ones (with
inv_inner modes), mean-depth/coverage annotation from the trim-qry depth table,
PASS-first ID versioning, and svmerge-driven haplotype merging with
callable-region genotypes.
"""

import collections

import numpy as np
import pandas as pd

from ..util import IntervalIndex, build_interval_index_by_chrom, merge_intervals, as_bool
from ..regions import region_from_string
from . import merge as svmerge
from .variant_id import version_variant_bed_id


# --------------------------------------------------------------------- filters

def apply_qry_filter_tree(df, qry_filter_index, filter_dict):
    """Add QRY_FILTER for variants whose QRY_REGION intersects filter regions
    (reference: pavlib/call.py:521-539).

    Vectorized: the QRY_REGION column is parsed once ("chrom:pos-end",
    1-based closed, same grammar as regions.region_from_string) and each
    chromosome group runs one overlap join against its filter index."""
    if qry_filter_index is None or df.shape[0] == 0:
        return
    rgn = df['QRY_REGION'].astype(str).str.replace(',', '', regex=False)
    parts = rgn.str.rsplit(':', n=1, expand=True)
    coords = parts[1].str.split('-', n=1, expand=True)
    chrom_a = parts[0].to_numpy()
    pos_a = pd.to_numeric(coords[0]).to_numpy(dtype=np.int64) - 1
    end_a = pd.to_numeric(coords[1]).to_numpy(dtype=np.int64)
    index_a = df.index.to_numpy()
    order = np.argsort(chrom_a, kind='stable')
    bounds = np.nonzero(np.r_[True, chrom_a[order][1:] != chrom_a[order][:-1]])[0]
    for g, lo in enumerate(bounds):
        hi = bounds[g + 1] if g + 1 < len(bounds) else len(order)
        sel = order[lo:hi]
        idx = qry_filter_index.get(chrom_a[sel[0]])
        if idx is None:
            continue
        q_idx, _ = idx.overlap_join(pos_a[sel], end_a[sel])
        for i in np.unique(q_idx):
            filter_dict[index_a[sel[i]]].add('QRY_FILTER')


class CompoundFilterState:
    """Accumulates accepted large-variant regions across sources
    (reference compound_filter_tree: rules/call.snakefile:568). Queries run
    vectorized over lazily-rebuilt per-chromosome arrays."""

    def __init__(self):
        self.regions = collections.defaultdict(list)  # chrom -> [(pos, end, id)]
        self._arrays = {}

    def _get_arrays(self, chrom):
        cached = self._arrays.get(chrom)
        lst = self.regions[chrom]
        if cached is None or cached[0] != len(lst):
            pos = np.array([p for p, _, _ in lst], dtype=np.int64)
            end = np.array([e for _, e, _ in lst], dtype=np.int64)
            self._arrays[chrom] = (len(lst), pos, end)
            cached = self._arrays[chrom]
        return cached

    def overlaps(self, chrom, pos, end):
        if not self.regions[chrom]:
            return []
        _, p_arr, e_arr = self._get_arrays(chrom)
        hits = np.nonzero((p_arr < end) & (e_arr > pos))[0]
        lst = self.regions[chrom]
        return [lst[i][2] for i in hits]

    def add(self, chrom, pos, end, vid):
        self.regions[chrom].append((int(pos), int(end), vid))


def apply_compound_filter(df, state, filter_dict, compound_dict, update=True,
                          flag_inv_inner_only=True):
    """COMPOUND-filter variants inside already-accepted larger variants
    (reference: pavlib/call.py:475-518)."""
    if df.shape[0] == 0:
        return
    # Column arrays + a positional loop (per-row df.loc is the hot cost at
    # genome scale).
    order = np.lexsort((df['POS'].to_numpy(), -df['SVLEN'].to_numpy(dtype=np.int64)))
    chrom_a = df['#CHROM'].to_numpy()
    pos_a = df['POS'].to_numpy(dtype=np.int64)
    end_a = df['END'].to_numpy(dtype=np.int64)
    id_a = df['ID'].to_numpy()
    svtype_a = df['SVTYPE'].to_numpy() if 'SVTYPE' in df.columns else None
    src_a = df['CALL_SOURCE'].to_numpy() if 'CALL_SOURCE' in df.columns else None
    inner_a = df['RGN_REF_INNER'].to_numpy() if 'RGN_REF_INNER' in df.columns else None
    index_a = df.index.to_numpy()

    for p in order:
        index = index_a[p]
        hits = state.overlaps(chrom_a[p], pos_a[p], end_a[p])
        if hits:
            filter_dict[index].add('COMPOUND')
            compound_dict[index] |= set(hits)
        elif update and index not in filter_dict.keys():
            if flag_inv_inner_only and svtype_a is not None and svtype_a[p] == 'INV':
                if src_a is None:
                    raise ValueError('CALL_SOURCE column missing in variant callset')
                if str(src_a[p]).split('-', 1)[0].upper() == 'FLAG':
                    inner = region_from_string(inner_a[p])
                    state.add(inner.chrom, inner.pos, inner.end, id_a[p])
            else:
                state.add(chrom_a[p], pos_a[p], end_a[p], id_a[p])


def update_filter_compound_fields(df, filter_dict, compound_dict):
    """Write FILTER/COMPOUND columns from the accumulated dicts
    (reference: pavlib/call.py:446-472)."""
    if df.shape[0] == 0:
        if 'FILTER' not in df.columns:
            df['FILTER'] = pd.Series(dtype=object)
        df['COMPOUND'] = pd.Series(dtype=object)
        return
    df['FILTER'] = pd.Series(
        {k: ','.join(sorted(v)) for k, v in filter_dict.items()}
    ).reindex(df.index, fill_value='PASS')
    df['COMPOUND'] = pd.Series(
        {k: ','.join(sorted(v)) for k, v in compound_dict.items()}
    ).reindex(df.index, fill_value='')


# ---------------------------------------------------------------------- depth

def annotate_depth(df, df_depth):
    """Vectorized COV_MEAN / COV_PROP / COV_QRY from a depth table
    (reference DepthContainer: pavlib/call.py:286-444).

    The depth table must be contiguous per chromosome (it is, by construction
    from depth_table()). End-of-chromosome insertions take the last interval's
    depth (the reference's end-insertion rescue: pavlib/call.py:366-386).
    """
    if df.shape[0] == 0:
        df['COV_MEAN'] = pd.Series(dtype=float)
        df['COV_PROP'] = pd.Series(dtype=float)
        df['COV_QRY'] = pd.Series(dtype=object)
        return df

    cov_mean = np.full(df.shape[0], np.nan)
    cov_prop = np.full(df.shape[0], np.nan)
    cov_qry = np.full(df.shape[0], '', dtype=object)

    depth_by_chrom = {c: sub.reset_index(drop=True) for c, sub in df_depth.groupby('#CHROM')}

    for chrom, var_sub in df.reset_index().groupby('#CHROM'):
        dsub = depth_by_chrom.get(chrom)
        if dsub is None:
            raise ValueError(f'Variant chromosome not in depth table: {chrom}')
        dpos = dsub['POS'].to_numpy(dtype=np.int64)
        dend = dsub['END'].to_numpy(dtype=np.int64)
        ddepth = dsub['DEPTH'].to_numpy(dtype=np.float64)
        dqry = dsub['QRY_ID'].to_numpy(dtype=object)
        cum = np.concatenate([[0.0], np.cumsum(ddepth * (dend - dpos))])
        cum_cov = np.concatenate([[0.0], np.cumsum((ddepth > 0) * (dend - dpos))])

        vpos = var_sub['POS'].to_numpy(dtype=np.int64)
        vend = var_sub['END'].to_numpy(dtype=np.int64)
        rows = var_sub.index.to_numpy()

        first = np.searchsorted(dend, vpos, side='right')
        last = np.searchsorted(dpos, vend, side='left') - 1

        chrom_end = int(dend[-1])
        for vi, f, l in zip(range(len(rows)), first, last):
            pos, end = int(vpos[vi]), int(vend[vi])
            out_i = rows[vi]
            if f >= len(dpos):
                # End-of-chromosome insertion rescue.
                if pos == chrom_end and end == pos + 1:
                    f = len(dpos) - 1
                    cov_mean[out_i] = ddepth[f]
                    cov_prop[out_i] = 1 if ddepth[f] > 0 else 0
                    qset = set(str(dqry[f]).split(',')) - {''}
                    cov_qry[out_i] = ','.join(sorted(qset))
                    continue
                raise ValueError(f'Variant beyond depth records on {chrom}: {pos}-{end}')
            if l < f:
                l = f
            if end < dend[f] or (end == pos + 1 and pos >= dpos[f] and end <= dend[f]):
                # Fully contained in one interval.
                cov_mean[out_i] = ddepth[f]
                cov_prop[out_i] = 1 if ddepth[f] > 0 else 0
                qset = set(str(dqry[f]).split(',')) - {''}
                cov_qry[out_i] = ','.join(sorted(qset))
                continue
            # Weighted sum over overlapped intervals [f, l].
            lo = np.maximum(dpos[f:l + 1], pos)
            hi = np.minimum(dend[f:l + 1], end)
            seg = np.maximum(hi - lo, 0)
            tot = seg.sum()
            if tot != end - pos:
                raise ValueError(
                    f'Depth span mismatch for {chrom}:{pos}-{end}: covered {tot}')
            cov_mean[out_i] = float((ddepth[f:l + 1] * seg).sum() / tot)
            cov_prop[out_i] = float(((ddepth[f:l + 1] > 0) * seg).sum() / tot)
            qset = set()
            for q in dqry[f:l + 1][seg > 0]:
                qset |= set(str(q).split(','))
            qset -= {''}
            cov_qry[out_i] = ','.join(sorted(qset)) if qset else np.nan

    df = df.copy()
    df['COV_MEAN'] = cov_mean
    df['COV_PROP'] = cov_prop
    df['COV_QRY'] = cov_qry
    return df


# ----------------------------------------------------------------- integration

def read_variant_tables(df_list):
    """Concatenate variant tables and prepare filter/compound dicts
    (reference read_variant_table: pavlib/call.py:219-283)."""
    from .variant_id import version_id

    frames = [df for df in df_list if df is not None]
    if not frames:
        raise ValueError('No variant tables to read')
    frames = [df for df in frames]
    df = pd.concat(frames, axis=0) if len(frames) > 1 else frames[0].copy()
    df = df.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)

    if 'FILTER' not in df.columns:
        df['FILTER'] = 'PASS'
    df['FILTER'] = df['FILTER'].fillna('PASS')

    df['ID'] = version_id(df['ID'])
    df = df.set_index('ID', drop=False)
    df.index.name = 'INDEX'

    filter_dict = collections.defaultdict(set)
    compound_dict = collections.defaultdict(set)
    idx_arr = df.index.to_numpy(dtype=object)
    if 'COMPOUND' in df.columns:
        comp_arr = df['COMPOUND'].to_numpy(dtype=object)
        for p in range(len(comp_arr)):
            val = comp_arr[p]
            if isinstance(val, str) and val.strip():
                compound_dict[idx_arr[p]] |= {
                    v.strip() for v in val.split(',') if v.strip()}
        del df['COMPOUND']
    filt_arr = df['FILTER'].to_numpy(dtype=object)
    for p in np.nonzero(filt_arr != 'PASS')[0]:
        filter_dict[idx_arr[p]].add(filt_arr[p])
    return df, filter_dict, compound_dict


def integrate_sources(df_cigar_insdel, df_cigar_snv, df_lg_ins, df_lg_del,
                      df_lg_inv, df_inv, df_depth, config, qry_filter_df=None):
    """Integrate call sources for one haplotype; returns
    {('svindel_ins'|'svindel_del'|'sv_inv'|'snv_snv'): (df_pass, df_fail)}.

    Mirrors the reference rule control flow exactly
    (rules/call.snakefile:488-747).
    """
    inv_min = config.get('inv_min', 0)
    inv_max = config.get('inv_max', 1e10)
    inv_inner = config.get('inv_inner', 'filter_core')
    redundant_callset = as_bool(config.get('redundant_callset', False))

    inv_inner_bool = as_bool(inv_inner, fail_to_none=True) if inv_inner is not None else None
    if inv_inner_bool is not None:
        inv_inner = 'no_filter' if inv_inner_bool else 'filter'
    else:
        inv_inner = str(inv_inner).lower().strip()
        if inv_inner not in ('all', 'none', 'filter_core'):
            raise ValueError(f'Parameter "inv_inner" must be bool or known string: {inv_inner}')

    inv_min = int(inv_min) if inv_min not in (None, 'unlimited') else None
    inv_max = int(inv_max) if inv_max not in (None, 'unlimited') else None

    qry_filter_index = None
    if qry_filter_df is not None and qry_filter_df.shape[0] > 0:
        qry_filter_index = build_interval_index_by_chrom(qry_filter_df)

    compound_state = CompoundFilterState()
    out = {}
    df_insdel_list = []

    for vartype in ('inv', 'lg_del', 'lg_ins', 'insdel', 'snv'):
        do_write = True
        is_insdel = False
        is_inv = False
        add_compound = True
        filter_compound = True
        no_flag_core = False

        if vartype == 'inv':
            df, filter_dict, compound_dict = read_variant_tables([df_inv, df_lg_inv])
            df = df.loc[~df['ID'].duplicated(keep='first')]
            is_inv = True
        elif vartype == 'lg_del':
            df, filter_dict, compound_dict = read_variant_tables([df_lg_del])
            do_write = False
            is_insdel = True
        elif vartype == 'lg_ins':
            df, filter_dict, compound_dict = read_variant_tables([df_lg_ins])
            do_write = False
            is_insdel = True
        elif vartype == 'insdel':
            df, filter_dict, compound_dict = read_variant_tables([df_cigar_insdel])
            is_insdel = True
            add_compound = False
        else:
            df, filter_dict, compound_dict = read_variant_tables([df_cigar_snv])
            add_compound = False

        if redundant_callset:
            filter_compound = False
            add_compound = False
        elif inv_inner == 'no_filter':
            add_compound = add_compound and not is_inv
        elif inv_inner == 'no_flag_core':
            no_flag_core = is_inv

        if df.shape[0] > 0:
            apply_qry_filter_tree(df, qry_filter_index, filter_dict)
            if is_inv and inv_min is not None:
                for index in df.index[df['SVLEN'] < inv_min]:
                    filter_dict[index].add('SVLEN')
            if is_inv and inv_max is not None:
                for index in df.index[df['SVLEN'] > inv_max]:
                    filter_dict[index].add('SVLEN')
            if filter_compound:
                apply_compound_filter(df, compound_state, filter_dict, compound_dict,
                                      add_compound, no_flag_core)

        update_filter_compound_fields(df, filter_dict, compound_dict)
        df = annotate_depth(df, df_depth)
        df['ID'] = version_variant_bed_id(df)
        df.index = df['ID']

        if is_insdel:
            df_insdel_list.append(df)

        if do_write:
            if is_insdel:
                dfm = pd.concat(df_insdel_list, axis=0).sort_values(['#CHROM', 'POS'])
                for svtype in ('ins', 'del'):
                    sub = dfm.loc[dfm['SVTYPE'] == svtype.upper()]
                    out[f'svindel_{svtype}'] = (
                        sub.loc[sub['FILTER'] == 'PASS'].copy(),
                        sub.loc[sub['FILTER'] != 'PASS'].copy())
            elif is_inv:
                out['sv_inv'] = (df.loc[df['FILTER'] == 'PASS'].copy(),
                                 df.loc[df['FILTER'] != 'PASS'].copy())
            else:
                out['snv_snv'] = (df.loc[df['FILTER'] == 'PASS'].copy(),
                                  df.loc[df['FILTER'] != 'PASS'].copy())

    return out


# ----------------------------------------------------------- callable regions

def callable_regions(df_align, df_lg_del, df_lg_ins, df_lg_inv, flank=500):
    """Merge trimmed-alignment spans and large-SV spans into callable regions
    (reference: rules/call.snakefile:186-215, pavlib/util.py:40-104)."""
    frames = []
    for df in (df_align, df_lg_del, df_lg_ins, df_lg_inv):
        if df is not None and df.shape[0] > 0:
            frames.append(df[['#CHROM', 'POS', 'END']])
    if not frames:
        return pd.DataFrame([], columns=['#CHROM', 'POS', 'END'])
    return merge_intervals(pd.concat(frames, axis=0), pad=flank)


# ------------------------------------------------------------ haplotype merge

def val_per_hap(df, df_dict, col_name, delim=';'):
    """Pack per-haplotype values for merged variants
    (reference: pavlib/call.py:122-148). Thin wrapper over the columnar
    multi-column path."""
    return pd.Series(
        _pack_per_hap_columns(df, df_dict, [col_name], delim=delim)[col_name],
        index=df.index)


def _pack_per_hap_columns(df, df_dict, col_names, delim=';'):
    """Columnar val_per_hap over many columns at once: explode the
    (hap, variant-ID) pairs one time, resolve values with per-hap batched
    index lookups (no per-row scalar access), and group-concat per row
    (reference: pavlib/call.py:122-148).

    HAP holds combinations of at most len(hap_list) haplotype names, so it is
    factorized and only the unique combos are split; HAP_VARIANTS is per-row
    distinct and is split row-wise. Value stringification uses one vectorized
    astype(str) per (hap, column) and the row join is util.join_ragged (one
    concat pass per extra haplotype)."""
    from itertools import chain

    from ..util import join_ragged

    hap_codes, hap_uniq = pd.factorize(
        df['HAP'].astype(str).to_numpy(dtype=object))
    uniq_splits = [u.split(';') for u in hap_uniq]
    uniq_counts = np.array([len(s) for s in uniq_splits], dtype=np.int64)
    counts = (uniq_counts[hap_codes] if len(hap_codes)
              else np.zeros(0, dtype=np.int64))
    total = int(counts.sum())
    offsets = np.concatenate([[0], np.cumsum(counts)])

    uniq_arrs = [np.array(s, dtype=object) for s in uniq_splits]
    flat_hap = (np.concatenate([uniq_arrs[c] for c in hap_codes])
                if total else np.zeros(0, dtype=object))
    var_lists = [v.split(';')
                 for v in df['HAP_VARIANTS'].astype(str).to_numpy(dtype=object)]
    flat_var = np.fromiter(chain.from_iterable(var_lists), dtype=object,
                           count=total)
    hap_masks = {h: flat_hap == h
                 for h in dict.fromkeys(chain.from_iterable(uniq_splits))}

    # Vectorized hash lookup of variant IDs -> row positions per hap.
    hap_positions = {
        h: df_dict[h].index.get_indexer(pd.Index(flat_var[mask]))
        for h, mask in hap_masks.items()
    }
    for h, pos in hap_positions.items():
        if len(pos) and pos.min() < 0:
            missing = flat_var[hap_masks[h]][pos < 0][:3]
            raise KeyError(f'HAP_VARIANTS ids not in {h} callset: {missing}')

    out = {}
    for col in col_names:
        flat_vals = np.empty(total, dtype=object)
        for h, mask in hap_masks.items():
            col_arr = df_dict[h][col].astype(str).to_numpy(dtype=object)
            flat_vals[mask] = col_arr[hap_positions[h]]
        out[col] = join_ragged(flat_vals, offsets[:-1], counts, delim).tolist()
    return out


def _genotype_columns(df, hap_list, callable_idx_list):
    """Per-hap GT characters for merged variants: '1' if called on the hap,
    '0' if the span is contained in a callable region, '.' otherwise
    (reference: pavlib/call.py:99-119, containment per call.py:114-117).
    Columnar: numpy column arrays + interval-index binary searches, no per-row
    pandas access."""
    n = len(df)
    hap_codes, hap_uniq = pd.factorize(
        df['HAP'].astype(str).to_numpy(dtype=object))
    uniq_sets = [set(u.split(';')) for u in hap_uniq]
    chrom_arr = df['#CHROM'].to_numpy(dtype=object)
    pos_arr = df['POS'].to_numpy(dtype=np.int64) if n else np.zeros(0, np.int64)
    end_arr = df['END'].to_numpy(dtype=np.int64) if n else np.zeros(0, np.int64)

    cols = []
    for hap, cidx in zip(hap_list, callable_idx_list):
        member = np.array([hap in s for s in uniq_sets], dtype=bool)
        called = member[hap_codes] if n else np.zeros(0, dtype=bool)
        out = np.full(n, '.', dtype=object)
        out[called] = '1'
        miss = np.nonzero(~called)[0]
        if len(miss):
            miss_chroms = chrom_arr[miss]
            for chrom in dict.fromkeys(miss_chroms.tolist()):
                idx = cidx.get(chrom)
                if idx is None:
                    continue
                sel = miss[miss_chroms == chrom]
                contained = idx.contains_batch(pos_arr[sel], end_arr[sel])
                out[sel[contained]] = '0'
        cols.append(out)
    return cols


def merge_haplotypes(bed_list, callable_list, hap_list, config_def,
                     subset_chrom=None):
    """Diploid (or polyploid) merge of per-haplotype callsets
    (reference: pavlib/call.py:650-733)."""
    import re as _re

    n_hap = len(hap_list)
    if len(bed_list) != n_hap or len(callable_list) != n_hap:
        raise ValueError('bed_list/callable_list length does not match hap_list')

    df = svmerge.merge_variants(
        bed_list=bed_list, sample_names=hap_list, strategy=config_def,
        subset_chrom=subset_chrom)

    df = df.set_index('ID', drop=False)
    df.index.name = 'INDEX'

    for col in ('HAP', 'RGN_REF_DISC', 'RGN_QRY_DISC', 'FLAG_ID', 'FLAG_TYPE',
                'MERGE_SRC', 'MERGE_SRC_ID'):
        if col in df.columns:
            del df[col]

    df.columns = [_re.sub('^MERGE_', 'HAP_', c) for c in df.columns]
    df.columns = ['HAP' if c == 'HAP_SAMPLES' else c for c in df.columns]

    for col in ('HAP', 'HAP_VARIANTS', 'HAP_RO', 'HAP_SZRO', 'HAP_OFFSET',
                'HAP_OFFSZ', 'HAP_MATCH'):
        if col in df.columns:
            df[col] = df[col].astype(str).str.replace(',', ';', regex=False)

    df_dict = {}
    for hap, bed in zip(hap_list, bed_list):
        sub = bed if not isinstance(bed, str) else pd.read_csv(bed, sep='\t')
        sub = sub.set_index('ID', drop=False)
        df_dict[hap] = sub

    if df.shape[0] > 0:
        pack_cols = [col for col in (
            'QRY_REGION', 'QRY_STRAND', 'CI', 'ALIGN_INDEX', 'CALL_SOURCE',
            'RGN_REF_INNER', 'RGN_QRY_INNER', 'COV_MEAN', 'COV_PROP', 'COV_QRY')
            if col in df.columns]
        packed = _pack_per_hap_columns(df, df_dict, pack_cols)
        for col in pack_cols:
            df[col] = packed[col]

    callable_idx_list = []
    for item in callable_list:
        sub = item if not isinstance(item, str) else pd.read_csv(item, sep='\t')
        callable_idx_list.append(build_interval_index_by_chrom(sub))

    if df.shape[0] > 0:
        gt_cols = _genotype_columns(df, hap_list, callable_idx_list)
        df['GT'] = ['|'.join(vals) for vals in zip(*gt_cols)]
    else:
        df['GT'] = ''

    return df


def get_merge_params(svtype, config):
    """Merge strategy for a variant type (reference: pavlib/call.py:736-770)."""
    from ..constants import MERGE_PARAM_DEFAULT
    config_def = None
    if svtype in ('ins', 'del', 'inv'):
        # Key chain per reference code (pavlib/call.py:753-758) plus
        # 'merge_svindel', the name the reference DOCUMENTS (CONFIG.md:192)
        # but never reads — accepted here so documented configs work.
        for key in (f'merge_{svtype}', 'merge_insdel', 'merge_insdelinv',
                    'merge_svindel'):
            if key in config and config[key]:
                config_def = config[key]
                break
    elif svtype == 'snv' and config.get('merge_snv'):
        config_def = config['merge_snv']
    if config_def is None:
        config_def = MERGE_PARAM_DEFAULT.get(svtype)
    if config_def is None:
        raise ValueError(f'No merge parameters for svtype: {svtype}')
    return config_def
