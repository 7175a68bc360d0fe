"""SAM/BAM emission: alignment tables -> SAM text or indexed binary BAM.

Parity with the reference's alignment reconstruction
(scripts/reconstruct_sam.py:28-102 + rules/align.snakefile:305-327, which pipes
through `samtools view -O CRAM`); SAM (optionally gzip) and BAM+BAI are emitted
directly from the engine's own BGZF layer. CRAM 3.0 emission lives in
pav_tpu.io.cram; SAM parsing in pav_tpu.align.table.read_sam.
"""

import gzip
import struct

import numpy as np

from .. import seqcodec
from ..align import cigar as cg


def write_sam(df_align, qry_store, ref_fai, out_path, hard_to_soft=True):
    """Write alignment records as SAM.

    :param df_align: Alignment table (any trim tier).
    :param qry_store: Contig SeqStore (sequences for SEQ field).
    :param ref_fai: {chrom: length} for @SQ headers.
    :param hard_to_soft: Emit clipped contig bases as soft clips with full
        sequence (reconstructed records carry the whole contig, matching the
        reference's reconstruction; reference: scripts/reconstruct_sam.py:60-84).
    """
    opener = gzip.open if str(out_path).endswith('.gz') else open
    with opener(out_path, 'wt') as fh:
        fh.write('@HD\tVN:1.6\tSO:coordinate\n')
        for chrom, length in ref_fai.items():
            fh.write(f'@SQ\tSN:{chrom}\tLN:{length}\n')
        fh.write('@PG\tID:pav_tpu\tPN:pav_tpu\n')

        for _, row in df_align.iterrows():
            lens, ops = cg.parse(row['CIGAR'])
            flag = int(str(row['FLAGS']), 16) if isinstance(row['FLAGS'], str) else int(row['FLAGS'])
            codes = qry_store.fetch_codes(row['QRY_ID'], rev_compl=bool(row['REV']))

            if hard_to_soft:
                ops = ops.copy()
                ops[ops == cg.H] = cg.S
                seq = seqcodec.decode(codes)
            else:
                # Drop hard-clipped bases from SEQ.
                clip_l = int(lens[0]) if len(ops) and ops[0] == cg.H else 0
                clip_r = int(lens[-1]) if len(ops) > 1 and ops[-1] == cg.H else 0
                seq = seqcodec.decode(codes[clip_l:len(codes) - clip_r or None])

            fh.write('\t'.join((
                str(row['QRY_ID']), str(flag), str(row['#CHROM']),
                str(int(row['POS']) + 1), str(int(row['MAPQ'])),
                cg.to_string(lens, ops), '*', '0', '0', seq, '*',
                f'RG:Z:{row["RG"]}' if row.get('RG', 'NA') != 'NA' else 'RG:Z:NA',
            )) + '\n')


# ----------------------------------------------------------------------- BAM

# Our op codes (cigar.py: MIDNSHP=X = 0..8) equal BAM's CIGAR op encoding, so
# ops pack directly as (len << 4) | op. SEQ packs 4-bit per base
# ('=ACMGRSVTWYHKDBN' nibbles): codes A,C,G,T,AMBIG -> 1,2,4,8,15.
_BAM_NIBBLE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)


def _record_to_seq(row, qry_store, lens, ops, hard_to_soft):
    codes = qry_store.fetch_codes(row['QRY_ID'], rev_compl=bool(row['REV']))
    if hard_to_soft:
        ops = ops.copy()
        ops[ops == cg.H] = cg.S
        return codes, lens, ops
    clip_l = int(lens[0]) if len(ops) and ops[0] == cg.H else 0
    clip_r = int(lens[-1]) if len(ops) > 1 and ops[-1] == cg.H else 0
    return codes[clip_l:len(codes) - clip_r or None], lens, ops


def write_bam(df_align, qry_store, ref_fai, out_path, hard_to_soft=True,
              index=True):
    """Write alignment records as coordinate-sorted BAM (+ .bai index).

    Replaces the reference's CRAM reconstruction output
    (scripts/reconstruct_sam.py:28-102, rules/align.snakefile:305-327) with a
    self-contained binary emitter over the engine's BGZF writer; the .bai uses
    the same UCSC binning scheme as the tabix layer (io/tabix.py:reg2bin).

    :param index: Also write `out_path + '.bai'`.
    """
    from .bgzf import BgzfWriter
    from .tabix import reg2bin

    ref_names = list(ref_fai.keys())
    ref_id = {name: i for i, name in enumerate(ref_names)}

    header_text = '@HD\tVN:1.6\tSO:coordinate\n' + ''.join(
        f'@SQ\tSN:{c}\tLN:{ref_fai[c]}\n' for c in ref_names
    ) + '@PG\tID:pav_tpu\tPN:pav_tpu\n'

    df = df_align.sort_values(['#CHROM', 'POS'],
                              key=lambda s: s.map(ref_id) if s.name == '#CHROM' else s)

    # Per-reference index state: {bin: [(voff_beg, voff_end)]} + 16kb linear.
    bin_chunks = [dict() for _ in ref_names]
    linear = [dict() for _ in ref_names]

    with BgzfWriter(out_path) as bw:
        bw.write(b'BAM\x01')
        htext = header_text.encode('ascii')
        bw.write(struct.pack('<i', len(htext)) + htext)
        bw.write(struct.pack('<i', len(ref_names)))
        for name in ref_names:
            nb = name.encode('ascii') + b'\x00'
            bw.write(struct.pack('<i', len(nb)) + nb
                     + struct.pack('<i', int(ref_fai[name])))

        for _, row in df.iterrows():
            lens, ops = cg.parse(row['CIGAR'])
            codes, lens, ops = _record_to_seq(row, qry_store, lens, ops,
                                              hard_to_soft)
            flag = (int(str(row['FLAGS']), 16)
                    if isinstance(row['FLAGS'], str) else int(row['FLAGS']))
            rid = ref_id[row['#CHROM']]
            pos = int(row['POS'])
            end = int(row['END'])
            name = str(row['QRY_ID']).encode('ascii') + b'\x00'

            cig = ((lens.astype(np.uint32) << 4)
                   | ops.astype(np.uint32)).tobytes()
            nib = _BAM_NIBBLE[codes]
            if len(nib) % 2:
                nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
            seq4 = ((nib[0::2] << 4) | nib[1::2]).tobytes()
            qual = b'\xff' * len(codes)  # '*' (no quality)

            body = struct.pack(
                '<iiBBHHHiiii',
                rid, pos,
                len(name), int(row['MAPQ']),
                reg2bin(pos, max(end, pos + 1)),
                len(lens), flag, len(codes),
                -1, -1, 0,           # next_refID, next_pos, tlen
            ) + name + cig + seq4 + qual

            v_beg = bw.tell_virtual()
            bw.write(struct.pack('<i', len(body)) + body)
            v_end = bw.tell_virtual()

            b = reg2bin(pos, max(end, pos + 1))
            bin_chunks[rid].setdefault(b, []).append((v_beg, v_end))
            for win in range(pos >> 14, ((max(end, pos + 1) - 1) >> 14) + 1):
                if win not in linear[rid] or v_beg < linear[rid][win]:
                    linear[rid][win] = v_beg

    if index:
        _write_bai(f'{out_path}.bai', ref_names, bin_chunks, linear)
    return out_path


def _write_bai(path, ref_names, bin_chunks, linear):
    """BAI index (SAM spec §5.2): per-reference binned chunks + 16kb linear
    index of minimum virtual offsets."""
    with open(path, 'wb') as fh:
        fh.write(b'BAI\x01' + struct.pack('<i', len(ref_names)))
        for rid in range(len(ref_names)):
            bins = bin_chunks[rid]
            fh.write(struct.pack('<i', len(bins)))
            for b in sorted(bins):
                chunks = _coalesce_chunks(bins[b])
                fh.write(struct.pack('<Ii', b, len(chunks)))
                for beg, end in chunks:
                    fh.write(struct.pack('<QQ', beg, end))
            lin = linear[rid]
            n_intv = (max(lin) + 1) if lin else 0
            fh.write(struct.pack('<i', n_intv))
            filled = 0
            for win in range(n_intv):
                filled = lin.get(win, filled)
                fh.write(struct.pack('<Q', filled))


def _coalesce_chunks(chunks):
    """Merge adjacent/overlapping virtual-offset chunks."""
    out = []
    for beg, end in sorted(chunks):
        if out and beg <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((beg, end))
    return out
