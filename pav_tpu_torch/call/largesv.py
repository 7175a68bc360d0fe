"""Alignment-truncating (large) SV calling: INS/DEL/INV from split alignments.

Parity with the reference caller (pavlib/lgsv.py:31-643): for contigs with
multiple trimmed alignment records on one chromosome, classify inter-record
gaps — reference-gap >= 50 with query-gap < 50 is a DEL, the converse an INS,
both large an inversion attempt; a +,-,+ three-record signature attempts an
inversion with a no-density fallback call. Distance-proportion gating with the
long-and-confident rescue (pavlib/lgsv.py:19-23).

Port of pav_tpu.call.largesv: the same caller, with inversion scans going
through the torch port's density on the device the caller names.
"""

import collections
import sys

import pandas as pd

from .. import seqcodec
from ..align import cigar as cg
from ..align.lift import AlignLift
from ..call import homology as hom
from ..call.variant_id import version_id
from ..constants import (CALL_SOURCE_ALNTRUNC, CALL_SOURCE_ALNTRUNC_DEN,
                               CALL_SOURCE_ALNTRUNC_NODEN)
from ..kmer import KmerUtil
from ..regions import Region

from . import inv as inv_mod

MAX_QRY_DIST_PROP = 1
MAX_REF_DIST_PROP = 3
DIST_PROP_LEN_MAPQ = (20000, 40)

INSDEL_COLUMNS = [
    '#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'HAP',
    'QRY_REGION', 'QRY_STRAND', 'CI', 'ALIGN_INDEX',
    'LEFT_SHIFT', 'HOM_REF', 'HOM_TIG', 'CALL_SOURCE', 'FILTER', 'SEQ',
]

INV_COLUMNS = [
    '#CHROM', 'POS', 'END', 'ID', 'SVTYPE', 'SVLEN', 'HAP',
    'QRY_REGION', 'QRY_STRAND', 'CI',
    'RGN_REF_INNER', 'RGN_QRY_INNER', 'RGN_REF_DISC', 'RGN_QRY_DISC',
    'FLAG_ID', 'FLAG_TYPE', 'ALIGN_INDEX', 'CALL_SOURCE', 'FILTER', 'SEQ',
]


def scan_for_events(df, ref_store, qry_store, hap, k_size=31, n_index=None,
                    log=None, max_qry_dist_prop=None, max_ref_dist_prop=None,
                    max_region_size=None, version_ids=True, strict_parity=False,
                    inv_call_out=None, device=None):
    """Scan trimmed alignments for alignment-truncating SVs.

    :param df: Trimmed alignment table (trim-qryref tier).
    :return: (df_ins, df_del, df_inv).
    """
    log = log if log is not None else sys.stdout
    max_qry_dist_prop = max_qry_dist_prop if max_qry_dist_prop is not None else MAX_QRY_DIST_PROP
    max_ref_dist_prop = max_ref_dist_prop if max_ref_dist_prop is not None else MAX_REF_DIST_PROP

    df = df.copy()
    df['ALN_LEN'] = df['END'] - df['POS']

    qry_fai = qry_store.fai()
    align_lift = AlignLift(df, qry_fai, strict_parity=strict_parity)
    k_util = KmerUtil(k_size)

    ins_list, del_list, inv_list = [], [], []
    inv_id_set = set()

    pair_counts = collections.Counter(zip(df['#CHROM'], df['QRY_ID']))
    multi = [(chrom, qid) for (chrom, qid), n in pair_counts.items() if n > 1]

    oriented_cache = {}

    def tig_oriented(qid, is_rev):
        key = (qid, bool(is_rev))
        if key not in oriented_cache:
            codes = qry_store.get(qid)
            oriented_cache.clear()  # single-entry cache like the reference SeqCache
            oriented_cache[key] = seqcodec.revcomp(codes) if is_rev else codes
        return oriented_cache[key]

    # Pre-split the table into per-(chrom, qry) row-dict groups: the pair scan
    # below is O(n^2) with data-dependent breaks, so it stays a Python loop, but
    # per-row access must be plain dicts, not pandas scalar .loc (50 us/row).
    group_rows = {}
    if multi:
        multi_set = set(multi)
        for rec in df.to_dict('records'):
            key = (rec['#CHROM'], rec['QRY_ID'])
            if key in multi_set:
                group_rows.setdefault(key, []).append(rec)

    def direct_scan(region_flag, scan_log=None):
        return inv_mod.scan_for_inv(
            region_flag, ref_store, qry_store, align_lift, k_util,
            n_index=n_index, max_region_size=max_region_size,
            log=log if scan_log is None else scan_log,
            min_exp_count=1, strict_parity=strict_parity, device=device)

    def walk(scan_fn, emit):
        """The pair scan. With emit=False this is the candidate-collection
        (pessimistic) pass: scan_fn records the region and returns None, and
        no variant rows are built. With emit=True it is the real sequential
        pass producing rows in deterministic order."""
        for chrom, qid in multi:
            ref_seq = ref_store.get(chrom) if emit else None
            rows = group_rows[(chrom, qid)]
            n_idx = len(rows)

            for sub1 in range(n_idx - 1):
                row1 = rows[sub1]
                is_rev = bool(row1['REV'])
                sub2 = sub1 + 1

                while sub2 < n_idx:
                    row2 = rows[sub2]

                    if bool(row2['REV']) == is_rev:
                        # INS/DEL/2-record-INV scan
                        if row1['QRY_POS'] < row2['QRY_POS']:
                            if row2['QRY_POS'] < row1['QRY_END']:
                                raise RuntimeError(
                                    'Contig ranges overlap for two alignment records '
                                    '(should not occur after trimming)')
                            query_pos = row1['QRY_END']
                            query_end = row2['QRY_POS']
                        else:
                            if row1['QRY_POS'] < row2['QRY_END']:
                                raise RuntimeError(
                                    'Contig ranges overlap for two alignment records '
                                    '(should not occur after trimming)')
                            query_pos = row2['QRY_END']
                            query_end = row1['QRY_POS']

                        dist_tig = query_end - query_pos
                        dist_ref = row2['POS'] - row1['END']

                        if dist_tig < 0:
                            raise RuntimeError('Contig query positions out of order (program bug)')

                        min_aln_len = min(row1['ALN_LEN'], row2['ALN_LEN'])
                        min_mapq = min(row1['MAPQ'], row2['MAPQ'])

                        if min_aln_len < DIST_PROP_LEN_MAPQ[0] or min_mapq < DIST_PROP_LEN_MAPQ[1]:
                            if (abs(dist_tig) / min_aln_len > max_qry_dist_prop
                                    or abs(dist_ref) / min_aln_len > max_ref_dist_prop):
                                sub2 += 1
                                continue

                        if dist_ref >= 50 and dist_tig < 50:
                            if emit:
                                del_list.append(_call_del(
                                    chrom, qid, row1, row2, query_pos, dist_ref, dist_tig,
                                    ref_seq, tig_oriented(qid, is_rev), is_rev, hap, log,
                                    strict_parity=strict_parity))
                            break
                        elif dist_ref < 50 and dist_tig >= 50:
                            if emit:
                                ins_list.append(_call_ins(
                                    chrom, qid, row1, row2, query_pos, query_end,
                                    dist_ref, dist_tig, ref_seq,
                                    tig_oriented(qid, is_rev), is_rev, hap, log,
                                    qry_store, strict_parity=strict_parity))
                            break
                        elif dist_ref >= 50 and dist_tig >= 50:
                            region_flag = Region(chrom, row1['END'], row2['POS'],
                                                 is_rev=is_rev)
                            inv_call = scan_fn(region_flag)
                            if inv_call is not None and inv_call.id not in inv_id_set:
                                _log(log, f'INV (2-tig): {inv_call}')
                                inv_list.append(_inv_row(
                                    inv_call, hap, is_rev, CALL_SOURCE_ALNTRUNC_DEN,
                                    f"{row1['INDEX']},{row2['INDEX']}", qry_store))
                                inv_id_set.add(inv_call.id)
                                if inv_call_out is not None:
                                    inv_call_out.append(inv_call)
                                break
                        sub2 += 1

                    elif sub2 + 1 < n_idx:
                        # 3-record inversion signature (+,-,+ or -,+,-)
                        sub3 = sub2 + 1
                        row2_mid = row2
                        row3 = rows[sub3]
                        mid = (row2_mid['QRY_POS'] + row2_mid['QRY_END']) // 2
                        if (bool(row3['REV']) == bool(row1['REV'])
                                and ((not row1['REV'] and row1['QRY_END'] < mid < row3['QRY_POS'])
                                     or (row1['REV'] and row3['QRY_POS'] < mid < row1['QRY_END']))):

                            region_flag = Region(chrom, row1['END'], row3['POS'],
                                                 is_rev=bool(row1['REV']))
                            inv_call = scan_fn(region_flag)

                            if inv_call is None and sub2 == sub1 + 1 and sub3 == sub1 + 2:
                                # Alignment-supported fallback without density
                                region_ref = Region(chrom, row2_mid['POS'], row2_mid['END'])
                                region_tig = Region(row2_mid['QRY_ID'],
                                                    row2_mid['QRY_POS'], row2_mid['QRY_END'])
                                inv_call = inv_mod.InvCall(
                                    region_ref, region_ref, region_tig, region_tig,
                                    region_ref, region_tig, region_ref, None)
                                call_source = CALL_SOURCE_ALNTRUNC_NODEN
                            else:
                                call_source = CALL_SOURCE_ALNTRUNC_DEN

                            if inv_call is not None and inv_call.id not in inv_id_set:
                                if emit:
                                    _log(log, f'INV (3-tig): {inv_call}')
                                    inv_list.append(_inv_row(
                                        inv_call, hap, is_rev, call_source,
                                        f"{row1['INDEX']},{row2_mid['INDEX']},{row3['INDEX']}",
                                        qry_store))
                                    inv_id_set.add(inv_call.id)
                                    if inv_call_out is not None:
                                        inv_call_out.append(inv_call)
                                break
                        sub2 += 1
                    else:
                        sub2 += 1

    # Phase 1 (pessimistic walk): collect every INV-scan region the
    # sequential pass could reach, assuming all scans fail. Failures do not
    # alter control flow, and classification/gating is pure pair geometry, so
    # the collected set is a superset of the regions the real pass scans
    # (a successful scan only *breaks earlier*).
    cand_keys, cand_regions = [], []
    seen = set()

    def collect_scan(region_flag):
        key = (region_flag.chrom, region_flag.pos, region_flag.end,
               bool(region_flag.is_rev))
        if key not in seen:
            seen.add(key)
            cand_keys.append(key)
            cand_regions.append(region_flag)
        return None

    walk(collect_scan, emit=False)
    # Phase-1 emit=False never touches inv_list even on the 3-tig no-density
    # fallback path; assert the pessimistic pass stayed side-effect-free.
    assert not ins_list and not del_list and not inv_list

    # Phase 2: speculative scans in parallel. scan_for_inv is a pure function
    # of the region (stores/lift/params fixed), so results memoize by region
    # key; the device KDE dispatch of one region overlaps the host k-mer work
    # of others (same threading model as the inv_scan stage).
    memo = {}
    if len(cand_regions) > 1:
        import io as _io

        from ..parallel import pools

        def scan_capture(region):
            # Catch EVERY exception, not just RuntimeError: the phase-1
            # candidate set is a superset of the regions the real sequential
            # pass reaches (a successful scan breaks earlier), so a failure
            # from a never-reached region must not abort the caller — it is
            # re-raised only if the phase-3 replay actually gets there. Log
            # lines go to a per-region buffer, flushed to the real log only
            # by the replay (never-reached regions leave no log trace, and
            # the sequential log order is deterministic).
            buf = _io.StringIO()
            try:
                return ('ok', direct_scan(region, scan_log=buf), buf.getvalue())
            except Exception as ex:
                return ('raise', ex, buf.getvalue())

        with pools.Executor('largesv', min(4, len(cand_regions))) as pool:
            for key, result in zip(cand_keys, pool.map(scan_capture, cand_regions)):
                memo[key] = result

    # Phase 3: exact sequential replay with memoized results (deterministic
    # row order, ID versioning, and dedup regardless of thread timing). A
    # memo miss (only possible after a duplicate-ID accept, which breaks
    # later in the real pass than the pessimistic one) scans directly.
    def replay_scan(region_flag):
        key = (region_flag.chrom, region_flag.pos, region_flag.end,
               bool(region_flag.is_rev))
        kind, val, logged = memo.get(key, (None, None, ''))
        if kind is None:
            return direct_scan(region_flag)
        if logged and log is not None:
            log.write(logged)
            log.flush()
        if kind == 'raise':
            raise val
        return val

    walk(replay_scan, emit=True)

    df_ins = _finish(ins_list, INSDEL_COLUMNS, version_ids)
    df_del = _finish(del_list, INSDEL_COLUMNS, version_ids)
    df_inv = _finish(inv_list, INV_COLUMNS, version_ids)
    return df_ins, df_del, df_inv


def _match_bp(row, right_end):
    lens, ops = cg.parse(row['CIGAR'])
    return cg.match_bp(lens, ops, right_end)


def _call_del(chrom, qid, row1, row2, query_pos, dist_ref, dist_tig,
              ref_seq, tig_seq, is_rev, hap, log, strict_parity=False):
    svlen = int(dist_ref)
    pos_ref = int(row1['END'])
    end_ref = int(row2['POS'])
    pos_tig = int(query_pos)
    end_tig = pos_tig + 1

    seq = ref_seq[pos_ref:end_ref]
    # strict_parity replicates a reference BUG: pavlib/align/align.py:337-360
    # match_bp compares char CIGAR ops ('=','H') against int codes ({4,5}, 7),
    # so it always returns 0 and the reference lgsv caller NEVER left-shifts
    # (left_shift = min(0, homology) = 0; LEFT_SHIFT column is 0 on every
    # reference output row). Default behavior keeps the intended shift.
    left_shift = 0 if strict_parity else min(
        _match_bp(row1, True),
        hom.left_homology(pos_ref - 1, ref_seq, seq))
    if left_shift > 0:
        pos_ref -= left_shift
        end_ref -= left_shift
        pos_tig -= left_shift
        end_tig -= left_shift
        seq = ref_seq[pos_ref:end_ref]

    sv_id = f'{chrom}-{pos_ref}-DEL-{svlen}'
    _log(log, f'DEL: {sv_id}')

    hom_ref_l = hom.left_homology(pos_ref - 1, ref_seq, seq)
    hom_ref_r = hom.right_homology(end_ref, ref_seq, seq)
    hom_tig_l = hom.left_homology(pos_tig - 1, tig_seq, seq)
    hom_tig_r = hom.right_homology(pos_tig, tig_seq, seq)

    return (
        chrom, pos_ref, end_ref, sv_id, 'DEL', svlen, hap,
        f'{qid}:{pos_tig + 1}-{end_tig}', '-' if is_rev else '+',
        int(dist_tig), f"{row1['INDEX']},{row2['INDEX']}",
        int(left_shift), f'{hom_ref_l},{hom_ref_r}', f'{hom_tig_l},{hom_tig_r}',
        CALL_SOURCE_ALNTRUNC, 'PASS', seqcodec.decode(seq))


def _call_ins(chrom, qid, row1, row2, query_pos, query_end, dist_ref, dist_tig,
              ref_seq, tig_seq, is_rev, hap, log, qry_store, strict_parity=False):
    pos_ref = int(row1['END'])
    end_ref = pos_ref + 1
    pos_tig = int(query_pos)
    end_tig = int(query_end)
    svlen = int(dist_tig)

    def tig_region_seq(p, e):
        return qry_store.fetch_region(Region(qid, p, e, is_rev=is_rev))

    seq = tig_region_seq(pos_tig, end_tig)
    # strict_parity: reference match_bp bug, see _call_del.
    left_shift = 0 if strict_parity else min(
        _match_bp(row1, True),
        hom.left_homology(pos_ref - 1, ref_seq, seq))
    if left_shift > 0:
        pos_ref -= left_shift
        end_ref -= left_shift
        pos_tig -= left_shift
        end_tig -= left_shift
        seq = tig_region_seq(pos_tig, end_tig)

    sv_id = f'{chrom}-{pos_ref}-INS-{svlen}'
    _log(log, f'INS: {sv_id}')

    hom_ref_l = hom.left_homology(pos_ref - 1, ref_seq, seq)
    hom_ref_r = hom.right_homology(pos_ref, ref_seq, seq)
    hom_tig_l = hom.left_homology(pos_tig - 1, tig_seq, seq)
    hom_tig_r = hom.right_homology(end_tig, tig_seq, seq)

    return (
        chrom, pos_ref, end_ref, sv_id, 'INS', svlen, hap,
        Region(qid, pos_tig, end_tig, is_rev=is_rev).to_base1_string(),
        '-' if is_rev else '+',
        int(dist_ref), f"{row1['INDEX']},{row2['INDEX']}",
        int(left_shift), f'{hom_ref_l},{hom_ref_r}', f'{hom_tig_l},{hom_tig_r}',
        CALL_SOURCE_ALNTRUNC, 'PASS', seqcodec.decode(seq))


def _inv_row(inv_call, hap, is_rev, call_source, align_index, qry_store):
    seq = qry_store.fetch_region(inv_call.region_tig_outer, rev_compl=is_rev)
    return (
        inv_call.region_ref_outer.chrom,
        inv_call.region_ref_outer.pos,
        inv_call.region_ref_outer.end,
        inv_call.id, 'INV', inv_call.svlen, hap,
        inv_call.region_tig_outer.to_base1_string(),
        '-' if is_rev else '+',
        0,
        inv_call.region_ref_inner.to_base1_string(),
        inv_call.region_tig_inner.to_base1_string(),
        inv_call.region_ref_discovery.to_base1_string(),
        inv_call.region_tig_discovery.to_base1_string(),
        inv_call.region_flag.region_id(), 'ALNTRUNC',
        align_index, call_source, 'PASS', seqcodec.decode(seq))


def _finish(rows, columns, version_ids):
    df = pd.DataFrame(rows, columns=columns)
    if df.shape[0]:
        if version_ids:
            df['ID'] = version_id(df['ID'])
        df = df.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)
    return df


def _log(log, message):
    if log is None:
        return
    log.write(message + '\n')
    log.flush()
