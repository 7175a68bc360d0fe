"""Callset evaluation: VCF/BED concordance between two callsets.

Supports the north-star concordance check (BASELINE.json: "VCF concordance vs
PAV"): load two VCFs (or call tables), match records per variant class, and
report recall/precision/exact-match rates. Matching mirrors the merge engine's
stages: SNVs exact (pos+REF/ALT), indels/SVs by size ratio + offset, INV by
reciprocal overlap.
"""

import gzip
import re

import numpy as np
import pandas as pd

from .util import IntervalIndex


def read_vcf(path):
    """Parse a (bgzipped) VCF into a DataFrame with #CHROM, POS (0-based), END,
    ID, SVTYPE, SVLEN, REF, ALT, FILTER, GT."""
    opener = gzip.open if str(path).endswith('.gz') else open
    rows = []
    with opener(path, 'rt') as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            parts = line.rstrip('\n').split('\t')
            chrom, pos1, vid, ref, alt, _, filt, info = parts[:8]
            gt = parts[9].split(':')[0] if len(parts) > 9 else '.'
            info_d = dict(kv.split('=', 1) for kv in info.split(';') if '=' in kv)
            svtype = info_d.get('SVTYPE')
            if svtype is None:
                if alt.startswith('<'):
                    svtype = alt.strip('<>')
                elif len(ref) == 1 and len(alt) == 1:
                    svtype = 'SNV'
                elif len(alt) > len(ref):
                    svtype = 'INS'
                else:
                    svtype = 'DEL'
            svlen = abs(int(info_d.get('SVLEN', len(alt) - len(ref))))
            if svtype == 'SNV':
                svlen = 1
            pos0 = int(pos1) - 1
            if svtype == 'SNV':
                beg, end = pos0, pos0 + 1
            elif svtype == 'INS':
                beg, end = pos0 + 1, pos0 + 2
            elif svtype in ('DEL', 'INV'):
                beg, end = pos0 + (0 if alt.startswith('<') else 1), None
                beg = pos0 + 1 if not alt.startswith('<') else pos0
                end = beg + svlen
            else:
                beg, end = pos0, pos0 + max(svlen, 1)
            rows.append((chrom, beg, end, vid, svtype, svlen, ref, alt, filt, gt))
    return pd.DataFrame(rows, columns=['#CHROM', 'POS', 'END', 'ID', 'SVTYPE',
                                       'SVLEN', 'REF', 'ALT', 'FILTER', 'GT'])


def _match_class(df_a, df_b, svtype, szro_min=0.5, offset_max=200, ro_min=0.5):
    """Count matches of class svtype from df_a found in df_b."""
    a = df_a.loc[df_a['SVTYPE'] == svtype]
    b = df_b.loc[df_b['SVTYPE'] == svtype]
    if a.shape[0] == 0:
        return 0, 0
    if b.shape[0] == 0:
        return 0, a.shape[0]

    matched = 0
    if svtype == 'SNV':
        key_b = set(zip(b['#CHROM'], b['POS'], b['REF'].str.upper(), b['ALT'].str.upper()))
        for row in a.itertuples():
            if (row._1, row.POS, row.REF.upper(), row.ALT.upper()) in key_b:
                matched += 1
        return matched, a.shape[0]

    by_chrom = {}
    for chrom, sub in b.groupby('#CHROM'):
        by_chrom[chrom] = (
            IntervalIndex((sub['POS'] - offset_max - 1).to_numpy(),
                          (sub['END'] + offset_max + 1).to_numpy()),
            sub['POS'].to_numpy(), sub['END'].to_numpy(), sub['SVLEN'].to_numpy())
    for row in a.itertuples():
        entry = by_chrom.get(row._1)
        if entry is None:
            continue
        idx, bpos, bend, blen = entry
        ok = False
        for c in idx.overlap_indices(row.POS, row.END):
            szro = min(row.SVLEN, blen[c]) / max(row.SVLEN, blen[c])
            offset = min(abs(row.POS - bpos[c]), abs(row.END - bend[c]))
            inter = max(0, min(row.END, bend[c]) - max(row.POS, bpos[c]))
            ro = inter / max(row.END - row.POS, bend[c] - bpos[c])
            if (szro >= szro_min and offset <= max(offset_max, 2 * min(row.SVLEN, blen[c]))) \
                    or ro >= ro_min:
                ok = True
                break
        if ok:
            matched += 1
    return matched, a.shape[0]


def concordance(truth, callset, pass_only=True):
    """Concordance report between two callsets (paths or DataFrames).

    :return: DataFrame per variant class with N_TRUTH, N_CALL, RECALL, PRECISION.
    """
    df_t = read_vcf(truth) if isinstance(truth, str) else truth
    df_c = read_vcf(callset) if isinstance(callset, str) else callset
    if pass_only:
        df_t = df_t.loc[df_t['FILTER'].isin(['PASS', '.'])]
        df_c = df_c.loc[df_c['FILTER'].isin(['PASS', '.'])]

    rows = []
    for svtype in ('SNV', 'INS', 'DEL', 'INV'):
        tp_t, n_t = _match_class(df_t, df_c, svtype)
        tp_c, n_c = _match_class(df_c, df_t, svtype)
        rows.append((svtype, n_t, n_c,
                     tp_t / n_t if n_t else np.nan,
                     tp_c / n_c if n_c else np.nan))
    return pd.DataFrame(rows, columns=['SVTYPE', 'N_TRUTH', 'N_CALL', 'RECALL',
                                       'PRECISION'])


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(prog='pav_tpu.eval',
                                     description='VCF concordance report')
    parser.add_argument('truth')
    parser.add_argument('callset')
    parser.add_argument('--all', action='store_true', help='include non-PASS')
    args = parser.parse_args(argv)
    df = concordance(args.truth, args.callset, pass_only=not args.all)
    print(df.to_string(index=False))
    return 0


if __name__ == '__main__':
    main()
