"""Bidirectional reference<->query coordinate liftover over alignment records.

Functional parity with the reference AlignLift (pavlib/align/lift.py:12-488),
re-built on sorted numpy block arrays + searchsorted instead of interval trees:
each record's CIGAR becomes two sorted block tables (ref-indexed and
query-indexed), and chromosome/contig-level lookup uses span arrays. Lift
results carry (id, pos, is_rev, pos_min, pos_max, align_index) like the
reference's tuples.

Known deviation: the reference's alignment-gap interpolation returns query-
coordinate midpoints as subject positions (lift.py:369-378, an apparent bug);
here the interpolated subject position is the midpoint of the flanking records'
nearest reference edges.
"""

import numpy as np

from ..regions import Region
from . import cigar as cg


class _RecordLift:
    """Per-record block tables derived from one CIGAR."""

    __slots__ = ('ref_starts', 'ref_ends', 'ref_q0', 'ref_q1',
                 'qry_starts', 'qry_ends', 'qry_r0', 'qry_r1')

    def __init__(self, pos, lens, ops):
        ref_blocks = []
        qry_blocks = []
        sub_bp = int(pos)
        qry_bp = 0
        for op_len, op in zip(lens, ops):
            op_len = int(op_len)
            if op in (cg.EQ, cg.X, cg.M):
                ref_blocks.append((sub_bp, sub_bp + op_len, qry_bp, qry_bp + op_len))
                qry_blocks.append((qry_bp, qry_bp + op_len, sub_bp, sub_bp + op_len))
                sub_bp += op_len
                qry_bp += op_len
            elif op == cg.I:
                qry_blocks.append((qry_bp, qry_bp + op_len, sub_bp, sub_bp + 1))
                qry_bp += op_len
            elif op == cg.D:
                ref_blocks.append((sub_bp, sub_bp + op_len, qry_bp, qry_bp + 1))
                sub_bp += op_len
            elif op in (cg.S, cg.H):
                qry_bp += op_len
            else:
                raise ValueError(f'Unhandled CIGAR operation in lift: {op}')

        rb = np.array(ref_blocks, dtype=np.int64).reshape(-1, 4)
        qb = np.array(qry_blocks, dtype=np.int64).reshape(-1, 4)
        self.ref_starts, self.ref_ends, self.ref_q0, self.ref_q1 = rb.T if len(rb) else (np.zeros(0, dtype=np.int64),) * 4
        self.qry_starts, self.qry_ends, self.qry_r0, self.qry_r1 = qb.T if len(qb) else (np.zeros(0, dtype=np.int64),) * 4

    def ref_to_qry(self, pos):
        i = np.searchsorted(self.ref_starts, pos, side='right') - 1
        if i < 0 or pos >= self.ref_ends[i]:
            return None
        q0, q1 = int(self.ref_q0[i]), int(self.ref_q1[i])
        if q1 - q0 > 1:
            return q0 + (pos - int(self.ref_starts[i]))
        return q1

    def qry_to_ref(self, pos, allow_end=True):
        i = np.searchsorted(self.qry_starts, pos, side='right') - 1
        if i < 0 or pos >= self.qry_ends[i]:
            # Allow positions landing exactly at a block end (reference: lift.py:122-128).
            if allow_end and i >= 0 and pos == self.qry_ends[i]:
                pass
            else:
                return None
        r0, r1 = int(self.qry_r0[i]), int(self.qry_r1[i])
        if r1 - r0 > 1:
            return r0 + (pos - int(self.qry_starts[i]))
        return r1


class AlignLift:
    """Liftover across an alignment table (post-trim)."""

    def __init__(self, df, qry_fai, cache_align=None, strict_parity=False):
        if len(set(df.index)) != df.shape[0]:
            raise ValueError('Cannot create AlignLift with duplicate index values')
        self.df = df
        self.qry_fai = qry_fai
        self.strict_parity = strict_parity
        self._record_cache = {}

        # Chromosome-level span arrays.
        self._ref_spans = {}
        for chrom, sub in df.groupby('#CHROM'):
            order = np.argsort(sub['POS'].to_numpy(), kind='stable')
            self._ref_spans[chrom] = (
                sub['POS'].to_numpy()[order].astype(np.int64),
                sub['END'].to_numpy()[order].astype(np.int64),
                np.asarray(list(sub.index))[order])
        self._qry_spans = {}
        for qid, sub in df.groupby('QRY_ID'):
            order = np.argsort(sub['QRY_POS'].to_numpy(), kind='stable')
            self._qry_spans[qid] = (
                sub['QRY_POS'].to_numpy()[order].astype(np.int64),
                sub['QRY_END'].to_numpy()[order].astype(np.int64),
                np.asarray(list(sub.index))[order])

    def _containing(self, spans, pos):
        if spans is None:
            return []
        starts, ends, idx = spans
        hits = [int(i) for s, e, i in zip(starts, ends, idx) if s <= pos < e]
        return hits

    def _rec(self, index):
        rl = self._record_cache.get(index)
        if rl is None:
            row = self.df.loc[index]
            lens, ops = cg.parse(row['CIGAR'])
            rl = _RecordLift(row['POS'], lens, ops)
            self._record_cache[index] = rl
        return rl

    # ------------------------------------------------------------------ lifts

    def lift_to_qry(self, subject_id, coord):
        """Reference -> query lift (reference: lift.py:177-272)."""
        ret_list = isinstance(coord, (list, tuple))
        coords = coord if ret_list else (coord,)
        out = []
        for pos in coords:
            hits = self._containing(self._ref_spans.get(subject_id), pos)
            if len(hits) != 1:
                out.append(None)
                continue
            index = hits[0]
            row = self.df.loc[index]
            qry_pos = self._rec(index).ref_to_qry(pos)
            if qry_pos is None:
                raise RuntimeError(
                    f'Program bug: no match in record lift within a containing record: '
                    f'{subject_id}:{pos} (index={index})')
            if row['REV']:
                qry_pos = self.qry_fai[row['QRY_ID']] - qry_pos
            out.append((row['QRY_ID'], qry_pos, bool(row['REV']),
                        qry_pos, qry_pos, (row['INDEX'],)))
        return out if ret_list else out[0]

    def lift_to_sub(self, query_id, coord, gap=False):
        """Query -> reference lift (reference: lift.py:51-175)."""
        ret_list = isinstance(coord, (list, tuple))
        coords = coord if ret_list else (coord,)
        out = []
        for pos in coords:
            hits = self._containing(self._qry_spans.get(query_id), pos)
            if len(hits) == 0 and gap:
                out.append(self._subject_gap(query_id, pos))
                continue
            if len(hits) != 1:
                out.append(None)
                continue
            index = hits[0]
            row = self.df.loc[index]
            pos_aln = pos
            if row['REV']:
                pos_aln = self.qry_fai[query_id] - pos
            sub_pos = self._rec(index).qry_to_ref(pos_aln)
            if sub_pos is None:
                raise RuntimeError(
                    f'Found no matches in a record lift for a contained query position: '
                    f'{query_id}:{pos} (index={index}, gap={gap})')
            out.append((row['#CHROM'], sub_pos, bool(row['REV']),
                        sub_pos, sub_pos, (row['INDEX'],)))
        return out if ret_list else out[0]

    def lift_region_to_qry(self, region):
        """Lift a reference region to query (reference: lift.py:304-331)."""
        lifted = self.lift_to_qry(region.chrom, (region.pos, region.end))
        qpos, qend = lifted
        if qpos is None or qend is None:
            return None
        if qpos[0] != qend[0] or qpos[2] != qend[2]:
            return None
        return Region(qpos[0], qpos[1], qend[1], is_rev=qpos[2],
                      pos_min=qpos[3], pos_max=qpos[4],
                      end_min=qend[3], end_max=qend[4],
                      pos_aln_index=(qpos[5],), end_aln_index=(qend[5],))

    def lift_region_to_sub(self, region, gap=False):
        """Lift a query region to reference (reference: lift.py:274-302)."""
        lifted = self.lift_to_sub(region.chrom, (region.pos, region.end), gap)
        spos, send = lifted
        if spos is None or send is None:
            return None
        if spos[0] != send[0] or (spos[2] is not None and send[2] is not None
                                  and spos[2] != send[2]):
            return None
        return Region(spos[0], spos[1], send[1], is_rev=False,
                      pos_min=spos[3], pos_max=spos[4],
                      end_min=send[3], end_max=send[4],
                      pos_aln_index=(spos[5],), end_aln_index=(send[5],))

    def _subject_gap(self, query_id, pos):
        """Interpolate a subject position inside an alignment gap between two
        flanking records of the same contig (reference: lift.py:333-378; see
        module docstring for the coordinate-space deviation)."""
        if pos is None:
            return None
        sub = self.df.loc[self.df['QRY_ID'] == query_id]
        if self.strict_parity:
            # Reproduce the reference exactly (lift.py:350-378): strict < on
            # the left flank, and interpolated positions/bounds in QUERY
            # coordinates returned as the subject position (apparent reference
            # bug, kept verbatim for output parity).
            left = sub.loc[sub['QRY_END'] < pos]
            right = sub.loc[sub['QRY_POS'] > pos]
            if left.shape[0] == 0 or right.shape[0] == 0:
                return None
            row_l = left.loc[left['QRY_END'].idxmax()]
            row_r = right.loc[right['QRY_POS'].idxmin()]
            if row_l['#CHROM'] != row_r['#CHROM']:
                return None
            return (
                row_l['#CHROM'],
                int((row_l['QRY_END'] + row_r['QRY_POS']) / 2),
                row_l['REV'] if row_l['REV'] == row_r['REV'] else None,
                row_l['QRY_END'], row_r['QRY_POS'],
                (row_l['INDEX'], row_r['INDEX']),
            )
        # <= / > so a position exactly at a record's (exclusive) end still
        # interpolates (the reference's strict < drops it: lift.py:350).
        left = sub.loc[sub['QRY_END'] <= pos]
        right = sub.loc[sub['QRY_POS'] > pos]
        if left.shape[0] == 0 or right.shape[0] == 0:
            return None
        row_l = left.loc[left['QRY_END'].idxmax()]
        row_r = right.loc[right['QRY_POS'].idxmin()]
        if row_l['#CHROM'] != row_r['#CHROM']:
            return None
        edge_l = row_l['END'] if not row_l['REV'] else row_l['POS']
        edge_r = row_r['POS'] if not row_r['REV'] else row_r['END']
        lo, hi = (edge_l, edge_r) if edge_l <= edge_r else (edge_r, edge_l)
        return (
            row_l['#CHROM'],
            (lo + hi) // 2,
            row_l['REV'] if row_l['REV'] == row_r['REV'] else None,
            lo, hi,
            (row_l['INDEX'], row_r['INDEX']),
        )
