"""Alignment table layer: schema, invariants, SAM ingestion, depth.

The alignment table is the central artifact between the aligner and every caller
(schema parity: reference API_ALIGN.md:31-64, produced by
pavlib/align/align.py:666-794). Tables are pandas DataFrames; hot operations
pull numpy columns.
"""

import numpy as np
import pandas as pd

from . import cigar as cg
from ..io.fasta import _open_text

ALIGN_COLUMNS = [
    '#CHROM', 'POS', 'END',
    'INDEX',
    'QRY_ID', 'QRY_POS', 'QRY_END', 'QRY_LEN',
    'RG', 'AO',
    'MAPQ',
    'REV', 'FLAGS',
    'HAP', 'CIGAR',
]

TRIM_COLUMNS = ['TRIM_REF_L', 'TRIM_REF_R', 'TRIM_QRY_L', 'TRIM_QRY_R']


def empty_align_table():
    return pd.DataFrame([], columns=ALIGN_COLUMNS)


def check_record(row, qry_fai):
    """Validate one alignment record's invariants; raises on violation
    (reference: pavlib/align/align.py:364-509)."""
    lens, ops = cg.parse(row['CIGAR'])
    try:
        ref_bp, qry_bp, *_ = cg.count(lens, ops)
    except Exception as ex:
        raise ValueError(
            f'CIGAR parsing error: {ex} (INDEX={row["INDEX"]}, '
            f'QRY={row["QRY_ID"]}:{row["QRY_POS"]}-{row["QRY_END"]}, '
            f'REF={row["#CHROM"]}:{row["POS"]}-{row["END"]})'
        ) from ex

    qry_len = qry_fai[row['QRY_ID']]
    ctx = (f'(INDEX={row["INDEX"]}, QRY={row["QRY_ID"]}:{row["QRY_POS"]}-{row["QRY_END"]}, '
           f'REF={row["#CHROM"]}:{row["POS"]}-{row["END"]})')

    if row['QRY_LEN'] != qry_len:
        raise ValueError(f'QRY_LEN != length from FAI ({row["QRY_LEN"]} != {qry_len}) {ctx}')
    if row['QRY_POS'] >= row['QRY_END']:
        raise ValueError(f'QRY_POS >= QRY_END {ctx}')
    if row['POS'] >= row['END']:
        raise ValueError(f'POS >= END {ctx}')
    if row['POS'] < 0 or row['QRY_POS'] < 0:
        raise ValueError(f'Negative position {ctx}')
    if row['POS'] + ref_bp != row['END']:
        raise ValueError(f'END mismatch: POS + ref_bp != END ({row["POS"] + ref_bp} != {row["END"]}) {ctx}')
    if row['QRY_POS'] + qry_bp != row['QRY_END']:
        raise ValueError(f'QRY_POS + qry_bp != QRY_END ({row["QRY_POS"] + qry_bp} != {row["QRY_END"]}) {ctx}')
    if row['QRY_END'] > qry_len:
        raise ValueError(f'QRY_END > qry_len ({row["QRY_END"]} > {qry_len}) {ctx}')


def check_table(df, qry_fai):
    """Validate all records."""
    for _, row in df.iterrows():
        check_record(row, qry_fai)


def sort_align_table(df):
    """Canonical order (reference: pavlib/align/align.py:788)."""
    return df.sort_values(
        ['#CHROM', 'POS', 'END', 'QRY_ID'], ascending=[True, True, False, True]
    ).reset_index(drop=True)


def finalize_align_table(df, batch_count=10):
    """Assign CALL_BATCH = INDEX % batch_count and zero TRIM_* fields
    (reference: rules/align.snakefile:163-169)."""
    df = df.copy()
    df['CALL_BATCH'] = df['INDEX'].astype(int) % int(batch_count)
    for col in TRIM_COLUMNS:
        df[col] = 0
    return df


def read_sam(path, qry_fai, hap, min_mapq=0):
    """Ingest a SAM text file (plain or gzip) into an alignment table, dropping
    unmapped/low-MAPQ records and converting soft clips to hard clips
    (reference: pavlib/align/align.py:666-794). Requires =/X CIGARs.
    """
    rows = []
    align_index = -1
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith('@'):
                continue
            tok = line.rstrip('\n').split('\t')
            if len(tok) < 11:
                continue
            align_index += 1
            qname, flag, rname, pos1, mapq, cigar_str = (
                tok[0], int(tok[1]), tok[2], int(tok[3]), int(tok[4]), tok[5])
            if flag & 0x4 or cigar_str == '*' or mapq < min_mapq:
                continue
            is_rev = bool(flag & 0x10)
            tags = {}
            for t in tok[11:]:
                parts = t.split(':', 2)
                if len(parts) == 3:
                    tags[parts[0]] = parts[2]

            lens, ops = cg.parse(cigar_str)
            if np.any(ops == cg.M):
                raise ValueError(
                    f'Found alignment match CIGAR operation (M) for record {qname} '
                    f'(start = {rname}:{pos1 - 1}): =/X required')
            lens, ops = cg.clip_soft_to_hard(lens, ops)
            ref_bp, qry_bp, clip_h_l, _, clip_h_r, _ = cg.count(lens, ops)

            qry_len = qry_fai[qname]
            map_pos = clip_h_l
            map_end = map_pos + qry_bp

            rows.append((
                rname, pos1 - 1, pos1 - 1 + ref_bp,
                align_index,
                qname,
                qry_len - map_end if is_rev else map_pos,
                qry_len - map_pos if is_rev else map_end,
                qry_len,
                tags.get('RG', 'NA'), tags.get('AO', 'NA'),
                mapq,
                is_rev, f'0x{flag:04x}',
                hap, cg.to_string(lens, ops),
            ))

    df = pd.DataFrame(rows, columns=ALIGN_COLUMNS) if rows else empty_align_table()
    df = sort_align_table(df)
    check_table(df, qry_fai)
    return df


def depth_table(df, ref_fai=None):
    """Per-interval alignment depth over the reference: vectorized sweep over
    record start/end events (reference algorithm: pavlib/align/align.py:54-283).

    Output columns: #CHROM, POS, END, DEPTH, QRY_ID (comma list), INDEX (comma
    list, same order). With ref_fai, pads to chromosome bounds and emits
    zero-depth rows for unaligned chromosomes.
    """
    out_rows = []

    by_chrom = {chrom: sub for chrom, sub in df.groupby('#CHROM')} if df.shape[0] else {}

    if ref_fai is not None:
        chrom_list = sorted(ref_fai.keys() if hasattr(ref_fai, 'keys') else ref_fai.index)
        missing = set(by_chrom) - set(chrom_list)
        if missing:
            raise ValueError(f'Missing chromosome in reference FAI index: {sorted(missing)[0]}')
    else:
        chrom_list = sorted(by_chrom)

    for chrom in chrom_list:
        chrom_len = int(ref_fai[chrom]) if ref_fai is not None else None
        sub = by_chrom.get(chrom)

        if sub is None:
            if chrom_len is not None:
                out_rows.append((chrom, 0, chrom_len, 0, '', ''))
            continue

        pos = sub['POS'].to_numpy(dtype=np.int64)
        end = sub['END'].to_numpy(dtype=np.int64)
        idx = sub['INDEX'].to_numpy(dtype=np.int64)
        qry = sub['QRY_ID'].to_numpy(dtype=object)
        if chrom_len is not None and end.max() > chrom_len:
            raise ValueError(f'Alignment END beyond chromosome length on {chrom}')

        # Sweep: events sorted by (position, end-before-start at same coord handled
        # by depth delta ordering irrelevance; query lists maintained in start order).
        events = np.concatenate([pos, end])
        kinds = np.concatenate([np.ones(len(pos), dtype=np.int8), np.zeros(len(end), dtype=np.int8)])
        recs = np.concatenate([np.arange(len(pos)), np.arange(len(end))])
        # Ends (kind 0) sort before starts (kind 1) at equal positions, matching the
        # reference's sorted() over (chrom, pos, event) tuples.
        order = np.lexsort((kinds, events))

        open_list = []  # list of local record ids, in start order
        last_pos = 0 if chrom_len is not None else int(events[order[0]])
        for oi in order:
            p = int(events[oi])
            if p > last_pos:
                out_rows.append((
                    chrom, last_pos, p, len(open_list),
                    ','.join(qry[i] for i in open_list),
                    ','.join(str(idx[i]) for i in open_list),
                ))
                last_pos = p
            if kinds[oi] == 1:
                open_list.append(int(recs[oi]))
            else:
                open_list.remove(int(recs[oi]))
        if chrom_len is not None and last_pos < chrom_len:
            out_rows.append((chrom, last_pos, chrom_len, 0, '', ''))

    return pd.DataFrame(out_rows, columns=['#CHROM', 'POS', 'END', 'DEPTH', 'QRY_ID', 'INDEX'])
