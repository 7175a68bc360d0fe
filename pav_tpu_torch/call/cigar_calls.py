"""CIGAR-walk variant extraction: SNV + INS/DEL (indel and SV) calls.

Semantics parity with the reference caller (pavlib/cigarcall.py:24-362):
X ops emit per-base SNVs; I/D ops emit INS/DEL with tandem-repeat left-shift
through preceding '=' runs and breakpoint-homology annotation on both reference
and contig, in both directions. DEL output coordinates remain unshifted while
INS coordinates shift, matching the reference's emitted tables exactly.

Unlike the reference's per-op Python walk (which appends one Python row per
variant — millions of interpreter iterations at genome scale), extraction here
is columnar end to end: ops are processed as whole numpy arrays per alignment
record, all homology searches of a record resolve in one batched kernel call,
per-record arrays accumulate into column buffers, and the string columns
(ID, REF/ALT, QRY_REGION, HOM_*) are built vectorized over the concatenated
arrays. No per-variant Python tuple is ever created.
"""

import numpy as np
import pandas as pd

from .. import seqcodec
from ..align import cigar as cg
from ..constants import CALL_SOURCE_CIGAR
from . import homology as hom
from .variant_id import version_id

SNV_COLUMNS = [
    '#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'REF', 'ALT', 'HAP',
    'QRY_REGION', 'QRY_STRAND', 'CI', 'ALIGN_INDEX', 'CALL_SOURCE',
]

INSDEL_COLUMNS = [
    '#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'HAP',
    'QRY_REGION', 'QRY_STRAND', 'CI', 'ALIGN_INDEX',
    'LEFT_SHIFT', 'HOM_REF', 'HOM_TIG', 'CALL_SOURCE', 'SEQ',
]

# Ops advancing the contig cursor in the caller's walk (the full contig sequence
# is in hand, so clipped bases advance too — reference: pavlib/cigarcall.py:286-287).
_ADV_QRY = np.zeros(9, dtype=np.int64)
_ADV_QRY[[cg.EQ, cg.X, cg.I, cg.S, cg.H]] = 1
_ADV_REF = np.zeros(9, dtype=np.int64)
_ADV_REF[[cg.EQ, cg.X, cg.D]] = 1

_BASE_OBJ = np.array(['A', 'C', 'G', 'T', 'N'], dtype=object)


def _u(arr):
    """int array -> fixed-width unicode array (np.char operand)."""
    return np.asarray(arr).astype('U')


def make_insdel_snv_calls(df_align, ref_store, qry_store, hap, version_ids=True):
    """Extract SNV and INS/DEL calls from every alignment record's CIGAR.

    :param df_align: Alignment table (post-trim).
    :param ref_store: SeqStore of the reference.
    :param qry_store: SeqStore of the haplotype contigs.
    :param hap: Haplotype label.
    :param version_ids: De-duplicate IDs when True.

    :return: (df_snv, df_insdel).
    """
    # Per-record metadata (few records; variants index into these via `rec`).
    meta = {'chrom': [], 'qry': [], 'strand': [], 'aidx': []}
    snv = {'rec': [], 'pos': [], 'tig': [], 'ref': [], 'alt': []}
    ind = {'rec': [], 'pos': [], 'end': [], 'is_ins': [], 'svlen': [],
           'tig_pos': [], 'tig_end': [], 'left_shift': [],
           'hom_ref_l': [], 'hom_ref_r': [], 'hom_tig_l': [], 'hom_tig_r': [],
           'seqs': []}

    cols = {c: df_align[c].to_numpy() for c in
            ('#CHROM', 'POS', 'QRY_ID', 'REV', 'INDEX', 'CIGAR')}
    for k in range(df_align.shape[0]):
        ri = len(meta['chrom'])
        rd = {c: cols[c][k] for c in cols}
        meta['chrom'].append(rd['#CHROM'])
        meta['qry'].append(rd['QRY_ID'])
        meta['strand'].append('-' if bool(rd['REV']) else '+')
        meta['aidx'].append(rd['INDEX'])
        _call_record(rd, ri, ref_store, qry_store, snv, ind)

    df_snv = _assemble_snv(snv, meta, hap)
    df_insdel = _assemble_insdel(ind, meta, hap)

    if df_snv.shape[0]:
        if version_ids:
            df_snv['ID'] = version_id(df_snv['ID'])
        df_snv = df_snv.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)
    if df_insdel.shape[0]:
        if version_ids:
            df_insdel['ID'] = version_id(df_insdel['ID'])
        df_insdel = df_insdel.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)

    return df_snv, df_insdel


def _call_record(rd, ri, ref_store, qry_store, snv, ind):
    chrom = rd['#CHROM']
    qry_id = rd['QRY_ID']
    is_rev = bool(rd['REV'])
    align_index = rd['INDEX']

    ref_seq = ref_store.get(chrom)
    tig_seq = qry_store.fetch_codes(qry_id, rev_compl=is_rev)
    tig_len = len(tig_seq)

    lens, ops = cg.parse(rd['CIGAR'])
    lens64 = lens.astype(np.int64)

    if np.any(ops == cg.M):
        raise ValueError(
            f'Illegal M operation in CIGAR (=/X required): align-index={align_index}')

    # Cursor positions at the start of each op.
    ref_pos = int(rd['POS']) + np.concatenate([[0], np.cumsum(lens64 * _ADV_REF[ops])])[:-1]
    tig_pos = np.concatenate([[0], np.cumsum(lens64 * _ADV_QRY[ops])])[:-1]

    # --- SNVs from X ops (vectorized across all X bases of the record) ---
    x_idx = np.nonzero(ops == cg.X)[0]
    if len(x_idx):
        reps = lens64[x_idx]
        offsets = np.concatenate([np.arange(r) for r in reps])
        pos_ref_snv = np.repeat(ref_pos[x_idx], reps) + offsets
        pos_tig_snv = np.repeat(tig_pos[x_idx], reps) + offsets
        pos_tig_out = tig_len - pos_tig_snv - 1 if is_rev else pos_tig_snv

        snv['rec'].append(np.full(len(pos_ref_snv), ri, dtype=np.int64))
        snv['pos'].append(pos_ref_snv)
        snv['tig'].append(pos_tig_out)
        snv['ref'].append(ref_seq[pos_ref_snv])
        snv['alt'].append(tig_seq[pos_tig_snv])

    # --- INS / DEL ---
    ins_idx = np.nonzero(ops == cg.I)[0]
    del_idx = np.nonzero(ops == cg.D)[0]
    var_idx = np.sort(np.concatenate([ins_idx, del_idx]))
    if len(var_idx) == 0:
        return

    is_ins = ops[var_idx] == cg.I
    oplen = lens64[var_idx]
    v_ref = ref_pos[var_idx]
    v_tig = tig_pos[var_idx]

    # Left-shift bound: length of an immediately-preceding '=' run, else 0.
    prev_eq_len = np.zeros(len(var_idx), dtype=np.int64)
    has_prev = var_idx > 0
    prev_ops = ops[np.maximum(var_idx - 1, 0)]
    mask = has_prev & (prev_ops == cg.EQ)
    prev_eq_len[mask] = lens64[np.maximum(var_idx - 1, 0)][mask]

    # SV sequences (unshifted): INS from contig, DEL from reference.
    sv_seqs = [
        (tig_seq[v_tig[i]:v_tig[i] + oplen[i]] if is_ins[i]
         else ref_seq[v_ref[i]:v_ref[i] + oplen[i]])
        for i in range(len(var_idx))
    ]
    arena, offs, svlens = hom.make_arena(sv_seqs)

    # Left shift = min(preceding '=' run, upstream ref homology with the SV seq).
    ls_hom = hom.left_homology_batch(v_ref - 1, ref_seq, arena, offs, svlens)
    left_shift = np.minimum(prev_eq_len, ls_hom)

    sv_pos_ref = v_ref - left_shift
    sv_pos_tig = v_tig - left_shift

    # Re-extract INS sequences at the shifted contig position
    # (reference: pavlib/cigarcall.py:162-163; DEL seq stays unshifted: :221, :233-245).
    shifted = is_ins & (left_shift > 0)
    if shifted.any():
        for i in np.nonzero(shifted)[0]:
            sv_seqs[i] = tig_seq[sv_pos_tig[i]:sv_pos_tig[i] + oplen[i]]
        arena, offs, svlens = hom.make_arena(sv_seqs)

    sv_end_ref = np.where(is_ins, sv_pos_ref + 1, sv_pos_ref + oplen)

    # Breakpoint homology, four directions in two batched calls per sequence space.
    hom_ref_l = hom.left_homology_batch(sv_pos_ref - 1, ref_seq, arena, offs, svlens)
    hom_ref_r_pos = np.where(is_ins, sv_pos_ref, sv_end_ref)
    hom_ref_r = hom.right_homology_batch(hom_ref_r_pos, ref_seq, arena, offs, svlens)

    hom_tig_l = hom.left_homology_batch(sv_pos_tig - 1, tig_seq, arena, offs, svlens)
    hom_tig_r_pos = np.where(is_ins, sv_pos_tig + oplen, sv_pos_tig)
    hom_tig_r = hom.right_homology_batch(hom_tig_r_pos, tig_seq, arena, offs, svlens)

    # Output positions (reference: INS coordinates shift, DEL stay unshifted).
    out_pos = np.where(is_ins, sv_pos_ref, v_ref)
    out_end = np.where(is_ins, sv_pos_ref + 1, v_ref + oplen)

    # Contig coordinates in original orientation.
    if is_rev:
        ins_end_out = tig_len - sv_pos_tig
        ins_pos_out = ins_end_out - oplen
        del_pos_out = tig_len - sv_pos_tig
    else:
        ins_pos_out = sv_pos_tig
        ins_end_out = sv_pos_tig + oplen
        del_pos_out = sv_pos_tig
    tig_pos_out = np.where(is_ins, ins_pos_out, del_pos_out)
    tig_end_out = np.where(is_ins, ins_end_out, del_pos_out)

    n = len(var_idx)
    ind['rec'].append(np.full(n, ri, dtype=np.int64))
    ind['pos'].append(out_pos)
    ind['end'].append(out_end)
    ind['is_ins'].append(is_ins)
    ind['svlen'].append(oplen)
    ind['tig_pos'].append(tig_pos_out)
    ind['tig_end'].append(tig_end_out)
    ind['left_shift'].append(left_shift)
    ind['hom_ref_l'].append(hom_ref_l)
    ind['hom_ref_r'].append(hom_ref_r)
    ind['hom_tig_l'].append(hom_tig_l)
    ind['hom_tig_r'].append(hom_tig_r)
    ind['seqs'].extend(sv_seqs)


def _meta_col(meta, key, rec, dtype=object):
    return np.array(meta[key], dtype=dtype)[rec] if len(meta[key]) else np.zeros(0, dtype)


def _assemble_snv(snv, meta, hap):
    if not snv['rec']:
        return pd.DataFrame([], columns=SNV_COLUMNS)
    rec = np.concatenate(snv['rec'])
    pos = np.concatenate(snv['pos'])
    tig = np.concatenate(snv['tig'])
    ref_b = _BASE_OBJ[np.concatenate(snv['ref'])]
    alt_b = _BASE_OBJ[np.concatenate(snv['alt'])]

    chrom = _meta_col(meta, 'chrom', rec)
    qry = _meta_col(meta, 'qry', rec)
    strand = _meta_col(meta, 'strand', rec)
    aidx = np.array(meta['aidx'])[rec]

    pos1 = _u(pos + 1)
    vid = np.char.add(np.char.add(np.char.add(chrom.astype('U'), '-'), pos1),
                      np.char.add('-SNV-', np.char.add(ref_b.astype('U'),
                                                       alt_b.astype('U'))))
    tig1 = _u(tig + 1)
    qreg = np.char.add(np.char.add(qry.astype('U'), ':'),
                       np.char.add(np.char.add(tig1, '-'), tig1))

    return pd.DataFrame({
        '#CHROM': chrom, 'POS': pos, 'END': pos + 1, 'ID': vid.astype(object),
        'SVTYPE': 'SNV', 'SVLEN': 1, 'REF': ref_b, 'ALT': alt_b, 'HAP': hap,
        'QRY_REGION': qreg.astype(object), 'QRY_STRAND': strand, 'CI': 0,
        'ALIGN_INDEX': aidx, 'CALL_SOURCE': CALL_SOURCE_CIGAR,
    }, columns=SNV_COLUMNS)


def _assemble_insdel(ind, meta, hap):
    if not ind['rec']:
        return pd.DataFrame([], columns=INSDEL_COLUMNS)
    rec = np.concatenate(ind['rec'])
    pos = np.concatenate(ind['pos'])
    end = np.concatenate(ind['end'])
    is_ins = np.concatenate(ind['is_ins'])
    svlen = np.concatenate(ind['svlen'])
    tig_pos = np.concatenate(ind['tig_pos'])
    tig_end = np.concatenate(ind['tig_end'])
    left_shift = np.concatenate(ind['left_shift'])

    chrom = _meta_col(meta, 'chrom', rec)
    qry = _meta_col(meta, 'qry', rec)
    strand = _meta_col(meta, 'strand', rec)
    aidx = np.array(meta['aidx'])[rec]

    svtype = np.where(is_ins, 'INS', 'DEL').astype(object)
    vid = np.char.add(
        np.char.add(np.char.add(chrom.astype('U'), '-'), _u(pos + 1)),
        np.char.add(np.char.add('-', svtype.astype('U')),
                    np.char.add('-', _u(svlen))))

    # QRY_REGION: INS spans [tig_pos+1, tig_end]; DEL is the point tig_pos+1.
    q_lo = _u(tig_pos + 1)
    q_hi = np.where(is_ins, _u(tig_end), q_lo)
    qreg = np.char.add(np.char.add(qry.astype('U'), ':'),
                       np.char.add(np.char.add(q_lo, '-'), q_hi))

    hom_ref = np.char.add(np.char.add(_u(np.concatenate(ind['hom_ref_l'])), ','),
                          _u(np.concatenate(ind['hom_ref_r'])))
    hom_tig = np.char.add(np.char.add(_u(np.concatenate(ind['hom_tig_l'])), ','),
                          _u(np.concatenate(ind['hom_tig_r'])))

    seqs = [seqcodec.decode(s) for s in ind['seqs']]

    return pd.DataFrame({
        '#CHROM': chrom, 'POS': pos, 'END': end, 'ID': vid.astype(object),
        'SVTYPE': svtype, 'SVLEN': svlen, 'HAP': hap,
        'QRY_REGION': qreg.astype(object), 'QRY_STRAND': strand, 'CI': 0,
        'ALIGN_INDEX': aidx, 'LEFT_SHIFT': left_shift,
        'HOM_REF': hom_ref.astype(object), 'HOM_TIG': hom_tig.astype(object),
        'CALL_SOURCE': CALL_SOURCE_CIGAR, 'SEQ': seqs,
    }, columns=INSDEL_COLUMNS)
