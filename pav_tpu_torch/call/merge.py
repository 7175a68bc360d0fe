"""Nonredundant variant merging (svpoplib.svmerge equivalent).

The reference delegates haplotype merging and TRIM-redundancy intersects to the
absent svpop submodule via strategy strings (called at pavlib/call.py:675 and
rules/call.snakefile:458; grammar documented HAP_MERGING.md:7-28 and SURVEY.md
§2.9). This module re-implements the 'nr' / 'nrsnv' engines from that
documented behavior:

  nr::ro(p):szro(p,dist,prop)[:match]   — INS/DEL/INV merging
  nrsnv::exact[:match]                  — SNV merging

Stage semantics (documented behavior; exact svpop internals unavailable):
  * ro(p): reciprocal overlap of reference spans >= p (insertions use
    [POS, POS+SVLEN) notional spans).
  * szro(p, dist, prop): size ratio >= p AND breakpoint offset
    (min of |dPOS|, |dEND|) <= min(dist, prop * min(svlen)).
  * match: additionally require sequence identity >= 0.8 (exact for SNV REF/ALT).

Sources merge in order: the first source's variants lead; later sources attach
at most one variant per lead per source (greedy, best RO then smallest offset),
otherwise become new leads.

Ambiguity ledger — behaviors the reference documents only partially (svpop
submodule absent from the snapshot); each is a decision that could silently
diverge from real svpop output and is pinned by tests/test_svmerge_semantics.py:
  1. szro's proportional cap base: HAP_MERGING.md says 'offset may not be more
     than 2x variant size' without naming which variant; this engine uses
     min(svlen_lead, svlen_cand) (the tighter reading).
  2. Attach tie-break when one candidate matches several unclaimed leads:
     highest RO, then smallest offset. svpop's internal ordering is unknown.
  3. match identity metric: CHANGES.md gives alignment scoring params
     (match=2,-1,-4,-0.25); this engine scores identity as
     1 - edit_distance/max_len for pairs <= 2kb and k-mer (k=9) multiset
     Jaccard above (the reference switches at 500kb). Both agree on the
     documented 0.8 threshold for near-identical sequences; borderline pairs
     (~80%) may be judged differently.
  4. ro/szro stages short-circuit in declaration order (a pair passing any
     stage merges); svpop may evaluate all and record the best stage.
  5. The RO denominator is the larger span (reciprocal); MERGE_RO records
     that value for attached variants, 1.0 for the lead itself.
"""

import re

import numpy as np
import pandas as pd

from ..util import IntervalIndex

MATCH_IDENTITY = 0.8


class MergeStrategy:
    def __init__(self, engine, stages, match_seq):
        self.engine = engine
        self.stages = stages        # list of (name, params tuple)
        self.match_seq = match_seq


def parse_strategy(strategy):
    """Parse an svpop-style strategy string."""
    parts = strategy.split('::')
    if len(parts) != 2:
        raise ValueError(f'Unrecognized merge strategy: {strategy}')
    engine, stage_str = parts
    if engine not in ('nr', 'nrsnv'):
        raise ValueError(f'Unknown merge engine: {engine}')

    stages = []
    match_seq = False
    for tok in stage_str.split(':'):
        tok = tok.strip()
        if not tok:
            continue
        if tok == 'match':
            match_seq = True
            continue
        if tok == 'exact':
            stages.append(('exact', ()))
            continue
        m = re.match(r'^(ro|szro|distance|dist)\(([^)]*)\)$', tok)
        if not m:
            raise ValueError(f'Unknown merge stage: {tok} in {strategy}')
        params = tuple(float(v) for v in m[2].split(',') if v.strip())
        stages.append((m[1], params))
    return MergeStrategy(engine, stages, match_seq)


def _notional_span(df):
    """Reference spans; insertions take [POS, POS+SVLEN)."""
    pos = df['POS'].to_numpy(dtype=np.int64)
    end = df['END'].to_numpy(dtype=np.int64)
    if 'SVTYPE' in df.columns:
        is_ins = (df['SVTYPE'] == 'INS').to_numpy()
        svlen = df['SVLEN'].to_numpy(dtype=np.int64)
        end = np.where(is_ins, pos + np.maximum(svlen, 1), end)
    return pos, end


def _seq_identity(a, b):
    """Fast sequence identity in [0, 1]: exact, else banded edit-distance for
    short pairs, else k-mer Jaccard approximation for long ones."""
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    la, lb = len(a), len(b)
    if min(la, lb) / max(la, lb) < 0.5:
        return 0.0
    if max(la, lb) <= 2000:
        dist = _banded_edit_distance(a, b, band=max(32, abs(la - lb) + 16))
        return max(0.0, 1.0 - dist / max(la, lb))
    # K-mer multiset Jaccard (k=9) for long sequences.
    k = 9
    from collections import Counter
    ca = Counter(a[i:i + k] for i in range(la - k + 1))
    cb = Counter(b[i:i + k] for i in range(lb - k + 1))
    inter = sum((ca & cb).values())
    union = sum((ca | cb).values())
    return inter / union if union else 0.0


def _banded_edit_distance(a, b, band):
    la, lb = len(a), len(b)
    if la > lb:
        a, b, la, lb = b, a, lb, la
    big = la + lb
    prev = np.arange(lb + 1, dtype=np.int32)
    bn = np.frombuffer(b.encode('latin1'), dtype=np.uint8)
    an = np.frombuffer(a.encode('latin1'), dtype=np.uint8)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int32)
        cur[0] = i
        lo = max(1, i - band)
        hi = min(lb, i + band)
        if lo > 1:
            cur[1:lo] = big
        if hi < lb:
            cur[hi + 1:] = big
        sub = prev[lo - 1:hi] + (bn[lo - 1:hi] != an[i - 1])
        # Diagonal/up candidates, then the horizontal chain
        # run(j) = min(seg[j], run(j-1)+1) in closed form:
        # run(j) = min(min_{k<=j}(seg[k]-k) + j, run(-1)+1+j) — one
        # prefix-min instead of a Python loop over the band.
        seg = np.minimum(sub, prev[lo:hi + 1] + 1)
        j_idx = np.arange(hi - lo + 1, dtype=np.int32)
        pm = np.minimum.accumulate(seg - j_idx)
        cur[lo:hi + 1] = np.minimum(pm + j_idx, np.int32(cur[lo - 1]) + 1 + j_idx)
        prev = cur
    return int(prev[lb])


def merge_variants(bed_list, sample_names, strategy, threads=1, subset_chrom=None):
    """Merge variant tables from multiple sources into a nonredundant set.

    :param bed_list: List of DataFrames (or filenames) with at least
        #CHROM, POS, END, ID, SVTYPE, SVLEN (REF/ALT for SNV; SEQ for match).
    :param sample_names: Source names, parallel to bed_list.
    :param strategy: Strategy string.
    :param subset_chrom: Restrict to a chromosome or set of chromosomes.

    :return: Merged DataFrame: lead-variant columns + MERGE_SAMPLES,
        MERGE_VARIANTS, MERGE_RO, MERGE_OFFSET, MERGE_SZRO, MERGE_OFFSZ,
        MERGE_MATCH, MERGE_SRC, MERGE_SRC_ID.
    """
    strat = parse_strategy(strategy)

    dfs = []
    for item in bed_list:
        if isinstance(item, str):
            df = pd.read_csv(item, sep='\t', dtype={'#CHROM': str}, low_memory=False,
                             keep_default_na=False)
        else:
            df = item.copy()
        if subset_chrom is not None:
            chroms = {subset_chrom} if isinstance(subset_chrom, str) else set(subset_chrom)
            df = df.loc[df['#CHROM'].isin(chroms)]
        df = df.reset_index(drop=True)
        dfs.append(df)

    if strat.engine == 'nrsnv':
        # The nrsnv engine matches on exact (chrom, POS, REF, ALT) equality
        # only (_match_arrays), so the whole merge is a vectorized key join —
        # no per-row interval lookups.
        return _merge_nrsnv_exact(dfs, sample_names)

    # Per-source column arrays (avoids per-row Series construction in the
    # matching loop).
    arrs = [_source_arrays(df, strat) for df in dfs]
    leads, support = _merge_nr_leads(arrs, sample_names, strat)

    # Build output table: bulk-slice lead rows per source, then assign the
    # MERGE_* columns in one pass each.
    if not leads:
        cols = list(dfs[0].columns) if dfs else []
        cols += ['MERGE_SAMPLES', 'MERGE_VARIANTS', 'MERGE_RO', 'MERGE_OFFSET',
                 'MERGE_SZRO', 'MERGE_OFFSZ', 'MERGE_MATCH', 'MERGE_SRC', 'MERGE_SRC_ID']
        return pd.DataFrame([], columns=cols)

    frames = []
    order = []
    for si in range(len(dfs)):
        ris = [ri for (s, ri) in leads if s == si]
        lis = [li for li, (s, _) in enumerate(leads) if s == si]
        if not ris:
            continue
        sub = dfs[si].iloc[ris].copy()
        sub['MERGE_SRC'] = sample_names[si]
        frames.append(sub)
        order.extend(lis)

    out = pd.concat(frames, axis=0).reset_index(drop=True)
    sup_ordered = [support[li] for li in order]
    out['MERGE_SAMPLES'] = [','.join(s[0] for s in sup) for sup in sup_ordered]
    out['MERGE_VARIANTS'] = [','.join(str(s[1]) for s in sup) for sup in sup_ordered]
    out['MERGE_RO'] = [','.join(_fmt(s[2]) for s in sup) for sup in sup_ordered]
    out['MERGE_OFFSET'] = [','.join(str(int(s[3])) for s in sup) for sup in sup_ordered]
    out['MERGE_SZRO'] = [','.join(_fmt(s[4]) for s in sup) for sup in sup_ordered]
    out['MERGE_OFFSZ'] = [','.join(_fmt(s[5]) for s in sup) for sup in sup_ordered]
    out['MERGE_MATCH'] = [','.join(_fmt(s[6]) for s in sup) for sup in sup_ordered]
    out['MERGE_SRC_ID'] = out['ID']

    out = out.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)
    return out


_MERGE_COLS = ['MERGE_SAMPLES', 'MERGE_VARIANTS', 'MERGE_RO', 'MERGE_OFFSET',
               'MERGE_SZRO', 'MERGE_OFFSZ', 'MERGE_MATCH', 'MERGE_SRC',
               'MERGE_SRC_ID']

# Chromosomes pack into one coordinate axis (code * _CHROM_OFF + pos) so a
# single interval join covers all chromosomes; pads (2 kb) never cross the
# offset boundary.
_CHROM_OFF = np.int64(1) << 42


def _merge_nr_leads(arrs, sample_names, strat):
    """Columnar nr-engine merge: per source, one vectorized interval join +
    stage predicates, then a single claim pass in row order.

    Replaces the per-row candidate loop (VERDICT r2 next #3). Semantics are
    identical to the sequential greedy by construction:
      * candidate generation indexes leads on RAW [POS, END) and queries on
        notional spans padded 2 kb (the same superset the loop enumerated);
      * a source's rows claim leads in ascending row order; within a row,
        preference is (higher RO, smaller offset), ties broken by the
        candidate enumeration order (ascending sorted-start position) — a
        stable lexsort plus one pass over the sorted pairs reproduces the
        loop exactly (leads appended by the current source are not eligible
        for the source's own later rows, matching the per-source index).

    :return: (leads [(si, ri)], support [[(name, id, ro, offset, szro, offsz,
        match)]]) in the same format the sequential loop produced.
    """
    chrom_code = {}
    for a in arrs:
        a['chrom_code'] = np.fromiter(
            (chrom_code.setdefault(c, len(chrom_code)) for c in a['chrom']),
            dtype=np.int64, count=len(a['chrom']))
    svt_code = {}
    for a in arrs:
        a['svt_code'] = np.fromiter(
            (svt_code.setdefault(t, len(svt_code)) for t in a['svtype']),
            dtype=np.int64, count=len(a['svtype']))

    leads = []          # (source_i, row_i)
    support = []        # per lead: [(sample, id, ro, offset, szro, offsz, match)]
    # Columnar lead state, appended in chunks per source.
    lk = {k: [] for k in ('pos', 'end', 'pos_n', 'end_n', 'svlen',
                          'svt', 'cc', 'si', 'ri')}

    def append_leads(si, ris, a, name):
        for ri in ris:
            leads.append((si, int(ri)))
            support.append([_self_support_arr(name, a, int(ri))])
        lk['pos'].append(a['pos'][ris])
        lk['end'].append(a['end'][ris])
        lk['pos_n'].append(a['pos_n'][ris])
        lk['end_n'].append(a['end_n'][ris])
        lk['svlen'].append(a['svlen'][ris])
        lk['svt'].append(a['svt_code'][ris])
        lk['cc'].append(a['chrom_code'][ris])
        lk['si'].append(np.full(len(ris), si, dtype=np.int64))
        lk['ri'].append(np.asarray(ris, dtype=np.int64))

    for si, (a, name) in enumerate(zip(arrs, sample_names)):
        n = len(a['pos'])
        if n == 0:
            continue
        if not leads:
            append_leads(si, np.arange(n), a, name)
            continue

        L = {k: np.concatenate(v) for k, v in lk.items()}
        idx = IntervalIndex(L['cc'] * _CHROM_OFF + L['pos'],
                            L['cc'] * _CHROM_OFF + L['end'])
        q_lo = a['chrom_code'] * _CHROM_OFF + a['pos_n'] - 2000
        q_hi = a['chrom_code'] * _CHROM_OFF + a['end_n'] + 2000
        ri_p, li_p = idx.overlap_join(q_lo, q_hi)

        # Vectorized pair metrics on notional spans.
        pos_l, end_l = L['pos_n'][li_p], L['end_n'][li_p]
        pos_c, end_c = a['pos_n'][ri_p], a['end_n'][ri_p]
        svlen_l, svlen_c = L['svlen'][li_p], a['svlen'][ri_p]

        inter = np.maximum(0, np.minimum(end_l, end_c) - np.maximum(pos_l, pos_c))
        union_span = np.maximum(end_l - pos_l, end_c - pos_c)
        ro = np.where(union_span > 0, inter / np.maximum(union_span, 1), 0.0)
        offset = np.minimum(np.abs(pos_l - pos_c), np.abs(end_l - end_c))
        min_len = np.minimum(svlen_l, svlen_c)
        szro = min_len / np.maximum(np.maximum(svlen_l, svlen_c), 1)
        offsz = offset / np.maximum(min_len, 1)

        ok = (L['svt'][li_p] == a['svt_code'][ri_p]) & (svlen_l > 0) & (svlen_c > 0)
        accept = np.zeros(len(ri_p), dtype=bool)
        for stage, params in strat.stages:
            if stage == 'ro':
                accept |= ro >= params[0]
            elif stage == 'szro':
                p, dist, prop = (list(params) + [None, None])[:3]
                limit = np.full(len(ri_p), np.inf if dist is None else dist)
                if prop is not None:
                    limit = np.minimum(limit, prop * min_len)
                accept |= (szro >= p) & (offset <= limit)
            elif stage == 'exact':
                accept |= (pos_l == pos_c) & (end_l == end_c)
        keep = np.nonzero(ok & accept)[0]

        match_val = np.full(len(keep), np.nan)
        if strat.match_seq and len(keep):
            l_si, l_ri = L['si'][li_p[keep]], L['ri'][li_p[keep]]
            drop = np.zeros(len(keep), dtype=bool)
            for j in range(len(keep)):
                la, ca = arrs[int(l_si[j])], a
                seq_l = la['seq'][int(l_ri[j])] if la['seq'] is not None else ''
                seq_c = ca['seq'][int(ri_p[keep[j]])] if ca['seq'] is not None else ''
                seq_l = '' if seq_l is None or isinstance(seq_l, float) else str(seq_l)
                seq_c = '' if seq_c is None or isinstance(seq_c, float) else str(seq_c)
                if seq_l and seq_c:
                    ident = _seq_identity(seq_l.upper(), seq_c.upper())
                    if ident < MATCH_IDENTITY:
                        drop[j] = True
                    else:
                        match_val[j] = ident
            keep = keep[~drop]
            match_val = match_val[~drop]

        # Claim pass: pairs sorted stably by (row, -ro, offset) — equal keys
        # keep candidate enumeration order; one pass reproduces the greedy.
        order = np.lexsort((offset[keep], -ro[keep], ri_p[keep]))
        s_ri = ri_p[keep][order].tolist()
        s_li = li_p[keep][order].tolist()
        s_ro = ro[keep][order].tolist()
        s_off = offset[keep][order].tolist()
        s_szro = szro[keep][order].tolist()
        s_offsz = offsz[keep][order].tolist()
        s_match = match_val[order].tolist()

        claimed = np.zeros(len(leads), dtype=bool)
        row_done = np.zeros(n, dtype=bool)
        ids = a['id']
        for p in range(len(s_ri)):
            r, li = s_ri[p], s_li[p]
            if row_done[r] or claimed[li]:
                continue
            row_done[r] = True
            claimed[li] = True
            support[li].append((name, ids[r], s_ro[p], int(s_off[p]),
                                s_szro[p], s_offsz[p], s_match[p]))

        new_ris = np.nonzero(~row_done)[0]
        if len(new_ris):
            append_leads(si, new_ris, a, name)

    return leads, support


def _upper_codes(values):
    """Factorize an object/string array case-insensitively: factorize raw
    values (C-speed), then uppercase only the uniques and re-map."""
    codes, uniq = pd.factorize(values)
    up = np.array([str(u).upper() for u in uniq], dtype=object)
    ucodes, _ = pd.factorize(up)
    return ucodes[codes] if len(uniq) else codes


def _combine_codes(parts):
    """Pack several int code arrays into one group-id array, compressing
    (factorize) after each combine so products never overflow int64."""
    k = np.asarray(parts[0], dtype=np.int64)
    k, _ = pd.factorize(k)
    for nxt in parts[1:]:
        nxt = np.asarray(nxt, dtype=np.int64)
        nxt, _ = pd.factorize(nxt)
        k = k.astype(np.int64) * (int(nxt.max()) + 1 if len(nxt) else 1) + nxt
        k, _ = pd.factorize(k)
    return k.astype(np.int64)


def _merge_nrsnv_exact(dfs, sample_names):
    """Vectorized nrsnv merge: per-component factorize + integer code packing
    over (chrom, POS, REF, ALT, SVTYPE) replaces the per-row candidate loop.
    No string keys are materialized (pandas object-string Series concat was
    the single hottest call of the merge stage).

    Equivalent to the generic engine for nrsnv: every key-equal pair matches
    with metrics (1, 0, 1, 0, 1), and a source's k-th duplicate of a key
    claims the k-th existing lead of that key (the claim-set semantics), so
    pairing on (key, within-source occurrence rank) reproduces the loop
    exactly.
    """
    chrom_l, pos_l, ref_l, alt_l, svt_l = [], [], [], [], []
    srcs_l, rows_l, ids_l = [], [], []
    for si, df in enumerate(dfs):
        n = df.shape[0]
        if n == 0:
            continue
        chrom_l.append(df['#CHROM'].to_numpy(dtype=object))
        pos_l.append(df['POS'].to_numpy(dtype=np.int64))
        ref_l.append(df['REF'].to_numpy(dtype=object))
        alt_l.append(df['ALT'].to_numpy(dtype=object))
        svt_l.append(df['SVTYPE'].to_numpy(dtype=object) if 'SVTYPE' in df.columns
                     else np.full(n, '', dtype=object))
        srcs_l.append(np.full(n, si, dtype=np.int64))
        rows_l.append(np.arange(n, dtype=np.int64))
        ids_l.append(df['ID'].to_numpy(dtype=object) if 'ID' in df.columns
                     else np.full(n, '', dtype=object))
    if not srcs_l:
        cols = list(dfs[0].columns) if dfs else []
        return pd.DataFrame([], columns=cols + _MERGE_COLS)

    srcs = np.concatenate(srcs_l)
    rows = np.concatenate(rows_l)
    ids = np.concatenate(ids_l)

    codes = _combine_codes([
        pd.factorize(np.concatenate(chrom_l))[0],
        np.concatenate(pos_l),
        _upper_codes(np.concatenate(ref_l)),
        _upper_codes(np.concatenate(alt_l)),
        pd.factorize(np.concatenate(svt_l))[0],
    ])
    # Within-source occurrence rank of each key (groupby-free cumcount).
    sc = _combine_codes([srcs, codes])
    sc_order = np.argsort(sc, kind='stable')
    sc_sorted = sc[sc_order]
    sc_start = np.nonzero(np.concatenate([[True], sc_sorted[1:] != sc_sorted[:-1]]))[0]
    sc_counts = np.append(sc_start[1:], len(sc_order)) - sc_start
    occ = np.empty(len(sc_order), dtype=np.int64)
    occ[sc_order] = np.arange(len(sc_order)) - np.repeat(sc_start, sc_counts)
    pair = codes.astype(np.int64) * (int(occ.max()) + 1 if len(occ) else 1) + occ

    order2 = np.argsort(pair, kind='stable')   # groups contiguous, concat order
    p_sorted = pair[order2]
    g_start = np.nonzero(np.concatenate([[True], p_sorted[1:] != p_sorted[:-1]]))[0]
    g_end = np.append(g_start[1:], len(order2))
    lead_pos = order2[g_start]                 # first occurrence = lead

    from ..util import join_ragged

    names_arr = np.array(sample_names, dtype=object)[srcs]
    g_counts = g_end - g_start
    # Groups are contiguous in order2: join by one concat pass per extra
    # member (vectorized; the per-group Python join was the hot loop here).
    name_flat = names_arr[order2]
    id_flat = np.array([str(v) for v in ids], dtype=object)[order2]
    samples_s = join_ragged(name_flat, g_start, g_counts, ',')
    variants_s = join_ragged(id_flat, g_start, g_counts, ',')
    rep_cache = {int(k): (','.join(['1'] * int(k)), ','.join(['0'] * int(k)))
                 for k in np.unique(g_counts)}
    ones_s = np.array([rep_cache[int(k)][0] for k in g_counts], dtype=object)
    zeros_s = np.array([rep_cache[int(k)][1] for k in g_counts], dtype=object)

    lead_si = srcs[lead_pos]
    lead_ri = rows[lead_pos]
    frames = []
    order = []
    for si in range(len(dfs)):
        sel = np.nonzero(lead_si == si)[0]
        if len(sel) == 0:
            continue
        sub = dfs[si].iloc[lead_ri[sel]].copy()
        sub['MERGE_SRC'] = sample_names[si]
        frames.append(sub)
        order.extend(sel.tolist())

    out = pd.concat(frames, axis=0).reset_index(drop=True)
    out['MERGE_SAMPLES'] = [samples_s[g] for g in order]
    out['MERGE_VARIANTS'] = [variants_s[g] for g in order]
    out['MERGE_RO'] = [ones_s[g] for g in order]
    out['MERGE_OFFSET'] = [zeros_s[g] for g in order]
    out['MERGE_SZRO'] = [ones_s[g] for g in order]
    out['MERGE_OFFSZ'] = [zeros_s[g] for g in order]
    out['MERGE_MATCH'] = [ones_s[g] for g in order]
    out['MERGE_SRC_ID'] = out['ID']
    out = out.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)
    return out


def _source_arrays(df, strat):
    """Extract plain column arrays for fast pairwise matching."""
    n = df.shape[0]
    pos = df['POS'].to_numpy(dtype=np.int64) if n else np.zeros(0, dtype=np.int64)
    end = df['END'].to_numpy(dtype=np.int64) if n else np.zeros(0, dtype=np.int64)
    svtype = (df['SVTYPE'].astype(str).to_numpy() if 'SVTYPE' in df.columns
              else np.full(n, '', dtype=object))
    svlen = (df['SVLEN'].to_numpy(dtype=np.int64) if 'SVLEN' in df.columns
             else np.maximum(end - pos, 1))
    pos_n = pos.copy()
    end_n = np.where(svtype == 'INS', pos + np.maximum(svlen, 1), end) if n else end
    return {
        'chrom': df['#CHROM'].astype(str).to_numpy() if n else np.zeros(0, dtype=object),
        'pos': pos, 'end': end, 'svtype': svtype, 'svlen': svlen,
        'pos_n': pos_n, 'end_n': end_n,
        'id': df['ID'].to_numpy() if 'ID' in df.columns else np.full(n, '', dtype=object),
        'ref': df['REF'].astype(str).str.upper().to_numpy() if 'REF' in df.columns else None,
        'alt': df['ALT'].astype(str).str.upper().to_numpy() if 'ALT' in df.columns else None,
        'seq': df['SEQ'].to_numpy() if 'SEQ' in df.columns else None,
    }


def _self_support_arr(name, arr, ri):
    return (name, arr['id'][ri], 1.0, 0, 1.0, 0.0, 1.0)


def _match_arrays(lead_arr, lri, cand_arr, cri, strat):
    """Per-pair matching under the strategy stages — the scalar REFERENCE
    implementation of the semantics the columnar engine (_merge_nr_leads)
    vectorizes; kept for the randomized differential test
    (tests/test_svmerge_semantics.py::test_nr_columnar_vs_sequential).

    :return: (ro, offset, szro, offsz, match_identity) or None when unmatched.
    """
    if lead_arr['svtype'][lri] != cand_arr['svtype'][cri]:
        return None

    if strat.engine == 'nrsnv':
        if (lead_arr['pos'][lri] != cand_arr['pos'][cri]
                or lead_arr['chrom'][lri] != cand_arr['chrom'][cri]):
            return None
        if lead_arr['ref'] is None or cand_arr['ref'] is None:
            return None
        if (lead_arr['ref'][lri] != cand_arr['ref'][cri]
                or lead_arr['alt'][lri] != cand_arr['alt'][cri]):
            return None
        return (1.0, 0, 1.0, 0.0, 1.0)

    svlen_l = int(lead_arr['svlen'][lri])
    svlen_c = int(cand_arr['svlen'][cri])
    if svlen_l <= 0 or svlen_c <= 0:
        return None

    pos_l, end_l = int(lead_arr['pos_n'][lri]), int(lead_arr['end_n'][lri])
    pos_c, end_c = int(cand_arr['pos_n'][cri]), int(cand_arr['end_n'][cri])

    inter = max(0, min(end_l, end_c) - max(pos_l, pos_c))
    union_span = max(end_l - pos_l, end_c - pos_c)
    ro = inter / union_span if union_span else 0.0

    offset = min(abs(pos_l - pos_c), abs(end_l - end_c))
    szro = min(svlen_l, svlen_c) / max(svlen_l, svlen_c)
    offsz = offset / min(svlen_l, svlen_c)

    matched = False
    for stage, params in strat.stages:
        if stage == 'ro':
            if ro >= params[0]:
                matched = True
                break
        elif stage == 'szro':
            p, dist, prop = (list(params) + [None, None])[:3]
            limit = dist if dist is not None else np.inf
            if prop is not None:
                limit = min(limit, prop * min(svlen_l, svlen_c))
            if szro >= p and offset <= limit:
                matched = True
                break
        elif stage == 'exact':
            if pos_l == pos_c and end_l == end_c:
                matched = True
                break
    if not matched:
        return None

    match_val = np.nan
    if strat.match_seq:
        seq_l = lead_arr['seq'][lri] if lead_arr['seq'] is not None else ''
        seq_c = cand_arr['seq'][cri] if cand_arr['seq'] is not None else ''
        seq_l = '' if seq_l is None or (isinstance(seq_l, float)) else str(seq_l)
        seq_c = '' if seq_c is None or (isinstance(seq_c, float)) else str(seq_c)
        if seq_l and seq_c:
            match_val = _seq_identity(seq_l.upper(), seq_c.upper())
            if match_val < MATCH_IDENTITY:
                return None

    return (ro, offset, szro, offsz, match_val)


def _fmt(v):
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return 'NA'
    return f'{v:.4g}'
