"""Alignment trimming: resolve redundantly-mapped bases between overlapping
alignment records, in query space then reference space.

Matches the reference's behavior (pavlib/align/trim.py:11-917) through an
original columnar design: cut candidates for a CIGAR are derived in one
vectorized pass (prefix sums over runs), and the optimal cut pair is selected
with searchsorted windows + one vectorized lexicographic argmin — no per-op
Python walk and no per-candidate two-pointer loop. The behavior contract
(which pair of cut sites wins, including every tie-break) is pinned by the
differential tests in tests/test_reference_parity.py.

Tiers produced by the pipeline: trim-none / trim-qry ("tig") / trim-qryref
("tigref") — reference rules/align.snakefile:54-97.
"""

import numpy as np
import pandas as pd

from . import cigar as cg
from .table import check_table, sort_align_table


class CutCandidates:
    """Cut candidates for one CIGAR walked from its cutting end.

    One row per =/X run reachable within the cut budget; all fields are
    parallel numpy arrays (columnar, not per-op tuples):

      run_i    index of the run in the walked (lens, ops) arrays
      run_len  bases in the run
      mism     True where the run is mismatch ('X')
      spent    cut-dimension bases consumed by all runs before this one
      gain     cut-dimension bases this run can contribute (== run_len)
      ev_lo    events (X bases + indel run count) strictly before this run
      ev_run   events inside this run (run_len for X, 0 for =)
      ref_bp   reference bases consumed before this run
      qry_bp   query bases consumed before this run
      sclip    soft-clipped bases seen before this run
      hclip    hard-clipped bases seen before this run
    """

    __slots__ = ('run_i', 'run_len', 'mism', 'spent', 'gain', 'ev_lo',
                 'ev_run', 'ref_bp', 'qry_bp', 'sclip', 'hclip')

    @property
    def size(self):
        return len(self.run_i)


def cut_candidates(lens, ops, budget, in_query):
    """Enumerate cut candidates in one vectorized pass over CIGAR runs.

    The walk covers every run up to (and including) the first '=' run whose
    cumulative cut-dimension consumption exceeds `budget` — aligned bases past
    the overlap cannot host a better cut (behavior contract with reference
    trim.py:779-917, pinned differentially in tests).
    """
    lens64 = np.asarray(lens, dtype=np.int64)
    opsv = np.asarray(ops)
    n = len(opsv)

    eq = opsv == cg.EQ
    x = opsv == cg.X
    ins = opsv == cg.I
    dele = opsv == cg.D
    sclip = opsv == cg.S
    hclip = opsv == cg.H
    if not (eq | x | ins | dele | sclip | hclip).all():
        bad = opsv[~(eq | x | ins | dele | sclip | hclip)][0]
        raise ValueError(f'Illegal CIGAR operation while trimming: op code {bad}')

    ref_c = np.where(eq | x | dele, lens64, 0)
    qry_c = np.where(eq | x | ins, lens64, 0)
    cut_c = qry_c if in_query else ref_c
    ev_c = np.where(x, lens64, 0) + (ins | dele)

    cum_cut = np.cumsum(cut_c)
    over = eq & (cum_cut > budget)
    last = int(np.argmax(over)) if over.any() else n - 1
    sel = np.nonzero((eq | x) & (np.arange(n) <= last))[0]

    cand = CutCandidates()
    cand.run_i = sel
    cand.run_len = lens64[sel]
    cand.mism = x[sel]
    cand.spent = cum_cut[sel] - cut_c[sel]
    cand.gain = cut_c[sel]
    cand.ev_lo = (np.cumsum(ev_c) - ev_c)[sel]
    cand.ev_run = ev_c[sel]
    cand.ref_bp = (np.cumsum(ref_c) - ref_c)[sel]
    cand.qry_bp = (np.cumsum(qry_c) - qry_c)[sel]
    cand.sclip = np.cumsum(np.where(sclip, lens64, 0))[sel]
    cand.hclip = np.cumsum(np.where(hclip, lens64, 0))[sel]
    return cand


def select_cut_pair(cand_l, cand_r, budget):
    """Pick the candidate pair removing >= budget cut-dimension bases while
    maximizing removed events.

    For each left row l the feasible right rows form a contiguous window:
    it opens at the first row whose full-run cut reaches the budget and
    closes at the last row whose minimal cut still fits within it (both found
    by searchsorted — `spent` and `spent + gain - 1` are strictly increasing).
    All windows are scored at once and the winner is the lexicographic best of
    (max events, min residual, max left row, min right row) — the same
    preference order the reference applies through nested strict-improvement
    loops (left cuts nearest the shared boundary win ties).

    Returns (li, ri) row indices into the candidate tables, or (None, None)
    when either side has no candidates.
    """
    L, R = cand_l.size, cand_r.size
    if L == 0 or R == 0:
        return None, None

    lo_l = cand_l.spent
    hi_l = cand_l.spent + cand_l.gain - 1
    reach_r = cand_r.spent + cand_r.gain - 1

    start = np.minimum(
        np.searchsorted(reach_r, budget - hi_l, side='left'), R - 1)
    end = np.maximum(
        np.searchsorted(cand_r.spent, budget - lo_l, side='right') - 1, start)

    counts = end - start + 1
    total = int(counts.sum())
    l_rows = np.repeat(np.arange(L), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    r_rows = start[l_rows] + offs

    slack = budget - (hi_l[l_rows] + reach_r[r_rows])
    events = cand_l.ev_lo[l_rows] + cand_r.ev_lo[r_rows]
    pe_l = cand_l.ev_run[l_rows]
    pe_r = cand_r.ev_run[r_rows]
    # When the full-run cut overshoots the budget, part of the cut runs'
    # events still count — capped at the bases actually removed from them.
    bonus = np.minimum(budget - slack,
                       pe_l + pe_r - (pe_l > 0) - (pe_r > 0))
    events = np.where(slack <= 0, events + bonus, events)
    residual = np.maximum(slack, 0)

    best = np.lexsort((r_rows, -l_rows, residual, -events))[0]
    return int(l_rows[best]), int(r_rows[best])


def _shave_cut_runs(cand_l, li, cand_r, ri, residual):
    """Distribute leftover cut bases inside the two winning runs.

    Mismatch runs absorb first (right side, then left), aligned runs after
    (left side, then right); a run always keeps its last base so the trimmed
    record still begins on an aligned op. Returns (shave_l, shave_r).
    """
    shave = {'l': 0, 'r': 0}
    is_x = {'l': bool(cand_l.mism[li]), 'r': bool(cand_r.mism[ri])}
    room = {'l': int(cand_l.run_len[li]) - 1, 'r': int(cand_r.run_len[ri]) - 1}
    for side, want_x in (('r', True), ('l', True), ('l', False), ('r', False)):
        if residual <= 0:
            break
        if is_x[side] == want_x:
            take = min(residual, room[side] - shave[side])
            shave[side] += take
            residual -= take
    return shave['l'], shave['r']


def trim_record_pair(rec_l, rec_r, in_query, back_l=True, back_r=False):
    """Trim the overlapping ends of two records (reference behavior:
    trim.py:357-608). Records are plain dicts carrying the table fields plus
    'cig' = (lens, ops); returns modified copies.

    :param back_l/back_r: walk that record's CIGAR from its tail (cut its
        right end) instead of its head.
    """
    rec_l = dict(rec_l)
    rec_r = dict(rec_r)

    if in_query:
        if rec_l['QRY_POS'] < rec_r['QRY_POS']:
            budget = rec_l['QRY_END'] - rec_r['QRY_POS']
        else:
            budget = rec_r['QRY_END'] - rec_l['QRY_POS']
        if budget <= 0:
            raise ValueError(f'Cannot trim to negative distance {budget}')
    else:
        if rec_l['POS'] > rec_r['POS']:
            raise ValueError('Records are incorrectly ordered in subject space')
        budget = rec_l['END'] - rec_r['POS']
        if budget <= 0:
            raise ValueError(f'Cannot trim to negative distance {budget}')

    lens_l, ops_l = rec_l['cig']
    lens_r, ops_r = rec_r['cig']
    if back_l:
        lens_l, ops_l = lens_l[::-1], ops_l[::-1]
    if back_r:
        lens_r, ops_r = lens_r[::-1], ops_r[::-1]

    cand_l = cut_candidates(lens_l, ops_l, budget, in_query)
    cand_r = cut_candidates(lens_r, ops_r, budget, in_query)
    li, ri = select_cut_pair(cand_l, cand_r, budget)
    if li is None or ri is None:
        raise RuntimeError('Program bug: found no cut-sites')

    residual = budget - int(cand_l.spent[li] + cand_r.spent[ri])
    shave_l, shave_r = _shave_cut_runs(cand_l, li, cand_r, ri, residual)

    for rec, cand, row, shave, back, lens_w, ops_w in (
            (rec_l, cand_l, li, shave_l, back_l, lens_l, ops_l),
            (rec_r, cand_r, ri, shave_r, back_r, lens_r, ops_r)):
        cut_ref = int(cand.ref_bp[row]) + shave
        cut_qry = int(cand.qry_bp[row]) + shave

        if back:
            rec['END'] -= cut_ref
            if rec['REV']:
                rec['QRY_POS'] += cut_qry
            else:
                rec['QRY_END'] -= cut_qry
            rec['TRIM_REF_R'] += cut_ref
            rec['TRIM_QRY_R'] += cut_qry
        else:
            rec['POS'] += cut_ref
            if rec['REV']:
                rec['QRY_END'] -= cut_qry
            else:
                rec['QRY_POS'] += cut_qry
            rec['TRIM_REF_L'] += cut_ref
            rec['TRIM_QRY_L'] += cut_qry

        # Rebuild the CIGAR: clip runs cover everything removed.
        keep_i = int(cand.run_i[row])
        lens_new = lens_w[keep_i:].astype(np.int32, copy=True)
        ops_new = ops_w[keep_i:].astype(np.int8, copy=True)
        lens_new[0] -= shave
        pre_lens, pre_ops = [], []
        if cand.hclip[row] > 0:
            pre_lens.append(int(cand.hclip[row])); pre_ops.append(cg.H)
        soft = int(cand.sclip[row]) + cut_qry
        if soft > 0:
            pre_lens.append(soft); pre_ops.append(cg.S)
        lens_new = np.concatenate(
            [np.array(pre_lens, dtype=np.int32), lens_new])
        ops_new = np.concatenate([np.array(pre_ops, dtype=np.int8), ops_new])
        if back:
            lens_new, ops_new = lens_new[::-1], ops_new[::-1]
        rec['cig'] = (lens_new, ops_new)

    return rec_l, rec_r


# ------------------------------------------------------------------- driver


_INT_COLS = ('POS', 'END', 'QRY_POS', 'QRY_END', 'QRY_LEN', 'INDEX',
             'TRIM_REF_L', 'TRIM_REF_R', 'TRIM_QRY_L', 'TRIM_QRY_R')


def _records_from_df(df):
    """DataFrame -> list of plain dicts with parsed CIGAR arrays (the pair
    passes run on Python scalars + numpy runs; no pandas scalar access)."""
    cols = {c: df[c].to_numpy() for c in df.columns}
    recs = []
    for i in range(df.shape[0]):
        rec = {}
        for c, arr in cols.items():
            if c == 'CIGAR':
                continue
            v = arr[i]
            rec[c] = int(v) if c in _INT_COLS else (
                bool(v) if c == 'REV' else v)
        rec['cig'] = cg.parse(cols['CIGAR'][i])
        recs.append(rec)
    return recs


def _df_from_records(recs, columns):
    rows = []
    for rec in recs:
        rec = dict(rec)
        lens, ops = rec.pop('cig')
        rec['CIGAR'] = cg.to_string(lens, ops)
        rows.append(rec)
    return pd.DataFrame(rows, columns=list(columns))


def trim_alignments(df, min_trim_tig_len, qry_fai, match_tig=False, mode='both'):
    """Trim redundantly mapped bases (reference driver: trim.py:11-354).

    :param df: Alignment table with TRIM_* columns initialized.
    :param min_trim_tig_len: Records with a shorter aligned query span are dropped.
    :param qry_fai: {contig: length} for the final invariant check.
    :param match_tig: Reference-space trimming only between records of the same
        contig (redundant_callset mode).
    :param mode: 'tig' (query space), 'ref' (reference space), or 'both'.
    """
    mode = (mode or 'both').lower()
    if mode not in ('tig', 'ref', 'both'):
        raise ValueError(f'Unrecognized trimming mode: {mode}')

    df = df.copy()
    for col in ('TRIM_REF_L', 'TRIM_REF_R', 'TRIM_QRY_L', 'TRIM_QRY_R'):
        if col not in df.columns:
            df[col] = 0
    columns = df.columns

    # Remove short alignments up front.
    df = df.loc[(df['QRY_END'] - df['QRY_POS']) >= min_trim_tig_len]
    recs = _records_from_df(df)

    if mode in ('tig', 'both'):
        recs.sort(key=lambda r: (r['QRY_ID'], -r['QRY_LEN']))
        recs = _trim_pass_query(recs, min_trim_tig_len)
        recs = [r for r in recs if r['INDEX'] >= 0]

    if mode in ('ref', 'both'):
        recs.sort(key=lambda r: (r['#CHROM'], r['POS'] - r['END']))
        recs = _trim_pass_ref(recs, min_trim_tig_len, match_tig)
        recs = [r for r in recs if r['INDEX'] >= 0]

    recs = [r for r in recs
            if r['END'] - r['POS'] > 0 and r['QRY_END'] - r['QRY_POS'] > 0]
    df = _df_from_records(recs, columns)
    df = sort_align_table(df)
    check_table(df, qry_fai)
    return df


def _trim_pass_query(recs, min_trim_tig_len):
    """Query-space pairwise overlap resolution (reference: trim.py:71-248)."""
    index_max = len(recs)
    il = 0
    while il < index_max:
        ir = il + 1
        while ir < index_max and recs[il]['QRY_ID'] == recs[ir]['QRY_ID']:
            if recs[il]['QRY_POS'] <= recs[ir]['QRY_POS']:
                index_l, index_r = il, ir
            else:
                index_l, index_r = ir, il
            rl, rr = recs[index_l], recs[index_r]

            if rl['INDEX'] < 0 or rr['INDEX'] < 0:
                ir += 1
                continue
            if rr['QRY_POS'] >= rl['QRY_END']:
                ir += 1
                continue
            if rr['QRY_END'] <= rl['QRY_END']:
                rr['INDEX'] = -1  # contained
                ir += 1
                continue

            back_l = not rl['REV']  # trim right end of l
            back_r = rr['REV']      # trim left end of r

            # Reference-space overlap between the two records?
            if back_l == back_r or rl['#CHROM'] != rr['#CHROM']:
                ref_overlap = False
            elif rl['POS'] < rr['POS']:
                ref_overlap = rr['POS'] < rl['END']
            elif rr['POS'] < rl['POS']:
                ref_overlap = rl['POS'] < rr['END']
            else:
                ref_overlap = False

            if ref_overlap:
                # Same-orientation reference overlap: try both trim orders and
                # keep the better left-aligned outcome (reference: trim.py:130-197).
                rec_l_a, rec_r_a = trim_record_pair(
                    rl, rr, True, back_l=back_l, back_r=back_r)
                rec_l_b, rec_r_b = trim_record_pair(
                    rr, rl, True, back_l=back_r, back_r=back_l)

                keep = None
                rm_l_a = rec_l_a['QRY_END'] - rec_l_a['QRY_POS'] < min_trim_tig_len
                rm_l_b = rec_l_b['QRY_END'] - rec_l_b['QRY_POS'] < min_trim_tig_len
                rm_r_a = rec_r_a['QRY_END'] - rec_r_a['QRY_POS'] < min_trim_tig_len
                rm_r_b = rec_r_b['QRY_END'] - rec_r_b['QRY_POS'] < min_trim_tig_len
                rm_any_a = rm_l_a or rm_r_a
                rm_any_b = rm_l_b or rm_r_b

                if rm_any_a and not rm_any_b:
                    if not rm_l_a and rm_r_a:
                        keep = 'a'
                elif rm_any_b and not rm_any_a:
                    if not rm_l_b and rm_r_b:
                        keep = 'b'
                if keep is None and rm_any_a:
                    keep = 'a'
                if keep is None and rm_any_b:
                    keep = 'b'
                if keep is None:
                    trim_pos_l_a = rec_l_a['END'] if not rec_l_a['REV'] else rec_l_a['POS']
                    trim_pos_l_b = rec_l_b['END'] if not rec_l_b['REV'] else rec_l_b['POS']
                    keep = 'a' if trim_pos_l_a <= trim_pos_l_b else 'b'

                if keep == 'a':
                    record_l, record_r = rec_l_a, rec_r_a
                else:
                    record_l, record_r = rec_r_b, rec_l_b
            else:
                # Swap so the upstream-aligned end is trimmed preferentially
                # (left-aligns around large SVs; reference: trim.py:199-228).
                if rl['#CHROM'] == rr['#CHROM'] and back_l != back_r:
                    trim_pos_l = rl['END'] if not rl['REV'] else rl['POS']
                    trim_pos_r = rr['POS'] if not rr['REV'] else rr['END']
                    if trim_pos_r < trim_pos_l:
                        back_l, back_r = back_r, back_l
                        index_l, index_r = index_r, index_l
                        rl, rr = recs[index_l], recs[index_r]

                record_l, record_r = trim_record_pair(
                    rl, rr, True, back_l=back_l, back_r=back_r)

            if record_l['QRY_END'] - record_l['QRY_POS'] >= min_trim_tig_len:
                recs[index_l] = record_l
            else:
                rl['INDEX'] = -1
            if record_r['QRY_END'] - record_r['QRY_POS'] >= min_trim_tig_len:
                recs[index_r] = record_r
            else:
                rr['INDEX'] = -1

            ir += 1
        il += 1
    return recs


def _trim_pass_ref(recs, min_trim_tig_len, match_tig):
    """Reference-space pairwise overlap resolution (reference: trim.py:256-331)."""
    index_max = len(recs)
    il = 0
    while il < index_max:
        ir = il + 1
        while ir < index_max and recs[il]['#CHROM'] == recs[ir]['#CHROM']:
            rl, rr = recs[il], recs[ir]
            if rl['INDEX'] < 0 or rr['INDEX'] < 0:
                ir += 1
                continue
            if match_tig and rl['QRY_ID'] != rr['QRY_ID']:
                ir += 1
                continue

            if rl['POS'] <= rr['POS']:
                index_l, index_r = il, ir
            else:
                index_l, index_r = ir, il
                rl, rr = recs[index_l], recs[index_r]

            if rr['POS'] < rl['END']:
                if rr['END'] <= rl['END']:
                    rr['INDEX'] = -1  # contained
                else:
                    record_l, record_r = trim_record_pair(rl, rr, False)
                    if record_l['QRY_END'] - record_l['QRY_POS'] >= min_trim_tig_len:
                        recs[index_l] = record_l
                    else:
                        rl['INDEX'] = -1
                    if record_r['QRY_END'] - record_r['QRY_POS'] >= min_trim_tig_len:
                        recs[index_r] = record_r
                    else:
                        rr['INDEX'] = -1
            ir += 1
        il += 1
    return recs
