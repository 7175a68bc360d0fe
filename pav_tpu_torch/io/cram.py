"""Native CRAM v3.0 emission (and a verifying reader).

The reference pipeline reconstructs alignments and pipes them through
`samtools view -O CRAM` (scripts/reconstruct_sam.py:28-102,
rules/align.snakefile:305-327). This module writes the CRAM 3.0 container
format directly — no htslib — so the framework's alignment outputs match the
reference's output surface byte-format for byte-format.

Design choices (all within the spec):
  * one mapped slice per container, records chunked per chromosome;
  * every data series uses the EXTERNAL codec (ints as ITF-8, bytes raw) or
    BYTE_ARRAY_STOP for variable byte arrays, so no core bit-stream is needed;
  * the reference span of each slice is embedded as an external block
    (slice header "embedded reference bases" content id), making the file
    self-contained — decoders never need the original FASTA;
  * block payloads are gzip-compressed (CRAM compression method 1);
  * mismatch runs are stored verbatim via the 'b' (bases) feature, matches
    come from the embedded reference, so no substitution-matrix dependence;
  * a .crai (gzipped text) index is written alongside.

Layout references: CRAM 3.0 specification (container/block structure, ITF-8 /
LTF-8 integer forms, slice header, record decode order).
"""

import gzip
import struct
import zlib

import numpy as np

from .. import seqcodec
from ..align import cigar as cg

CRAM_MAGIC = b'CRAM\x03\x00'

# Block content types.
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_MAPPED_SLICE = 2
CT_EXTERNAL = 4
CT_CORE = 5

# Compression methods.
M_RAW = 0
M_GZIP = 1

# BAM record flags (subset used here).
FLAG_UNMAPPED = 0x4

# CRAM record flags (CF).
CF_DETACHED = 0x2

# External block content ids, one per data series we emit.
_SERIES = ['BF', 'CF', 'RL', 'AP', 'RG', 'RN', 'MF', 'NS', 'NP', 'TS',
           'TL', 'FN', 'FC', 'FP', 'DL', 'BB', 'IN', 'SC', 'HC', 'MQ']
_CID = {k: i + 1 for i, k in enumerate(_SERIES)}
_EMBEDDED_REF_CID = len(_SERIES) + 1

_BYTE_ARRAY_SERIES = {'RN', 'BB', 'IN', 'SC'}   # BYTE_ARRAY_STOP, stop=\t
_BYTE_SERIES = {'FC'}                           # single raw bytes
_STOP = 9  # '\t'

# CRAM 3.0 EOF container (fixed 38 bytes defined by the spec).
EOF_CONTAINER = bytes([
    0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
    0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
    0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
    0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b,
])


# ------------------------------------------------------------ ITF-8 / LTF-8

def itf8(v):
    """Encode a 32-bit signed int as ITF-8 bytes."""
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf, off):
    """Decode ITF-8 -> (signed int, new offset)."""
    b0 = buf[off]
    if b0 < 0x80:
        v, off = b0, off + 1
    elif b0 < 0xC0:
        v, off = ((b0 & 0x7F) << 8) | buf[off + 1], off + 2
    elif b0 < 0xE0:
        v = ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        off += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x1F) << 24) | (buf[off + 1] << 16) \
            | (buf[off + 2] << 8) | buf[off + 3]
        off += 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) \
            | (buf[off + 2] << 12) | (buf[off + 3] << 4) | (buf[off + 4] & 0x0F)
        off += 5
    if v >= 0x80000000:
        v -= 0x100000000
    return v, off


def ltf8(v):
    """Encode a 64-bit signed int as LTF-8 bytes."""
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    for n, prefix in ((1, 0x80), (2, 0xC0), (3, 0xE0), (4, 0xF0),
                      (5, 0xF8), (6, 0xFC), (7, 0xFE)):
        if v < (1 << (7 * (n + 1))):
            body = v.to_bytes(n + 1, 'big')
            return bytes([prefix | body[0]]) + body[1:]
    return bytes([0xFF]) + v.to_bytes(8, 'big')


def read_ltf8(buf, off):
    b0 = buf[off]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 8:
        v = int.from_bytes(buf[off + 1:off + 9], 'big')
        off += 9
    else:
        v = b0 & (0x7F >> n)
        for k in range(n):
            v = (v << 8) | buf[off + 1 + k]
        off += n + 1
    if v >= 0x8000000000000000:
        v -= 0x10000000000000000
    return v, off


# ------------------------------------------------------------------ blocks

def _block(content_type, content_id, data, method=M_GZIP):
    """Serialize one CRAM block (method, type, id, sizes, payload, CRC32)."""
    raw_size = len(data)
    if method == M_GZIP:
        payload = zlib.compress(data, 6)
        if len(payload) >= raw_size:
            method, payload = M_RAW, data
    else:
        payload = data
    head = (bytes([method, content_type]) + itf8(content_id)
            + itf8(len(payload)) + itf8(raw_size))
    body = head + payload
    return body + struct.pack('<I', zlib.crc32(body) & 0xFFFFFFFF)


def _read_block(buf, off):
    method, ctype = buf[off], buf[off + 1]
    off += 2
    cid, off = read_itf8(buf, off)
    csize, off = read_itf8(buf, off)
    rsize, off = read_itf8(buf, off)
    payload = bytes(buf[off:off + csize])
    off += csize
    crc = struct.unpack('<I', buf[off:off + 4])[0]
    off += 4
    if method == M_GZIP:
        data = zlib.decompress(payload)
    elif method == M_RAW:
        data = payload
    else:
        raise ValueError(f'unsupported CRAM compression method {method}')
    if len(data) != rsize:
        raise ValueError('CRAM block raw size mismatch')
    del crc
    return ctype, cid, data, off


def _container_header(length, ref_id, start, span, n_rec, counter, bases,
                      n_blocks, landmarks):
    body = (struct.pack('<i', length) + itf8(ref_id) + itf8(start)
            + itf8(span) + itf8(n_rec) + ltf8(counter) + ltf8(bases)
            + itf8(n_blocks) + itf8(len(landmarks))
            + b''.join(itf8(x) for x in landmarks))
    return body + struct.pack('<I', zlib.crc32(body) & 0xFFFFFFFF)


def _read_container_header(fh):
    head = fh.read(4)
    if len(head) < 4:
        return None
    length = struct.unpack('<i', head)[0]
    # Read a bounded chunk covering the variable-length fields.
    rest = fh.read(128)
    buf = rest
    off = 0
    ref_id, off = read_itf8(buf, off)
    start, off = read_itf8(buf, off)
    span, off = read_itf8(buf, off)
    n_rec, off = read_itf8(buf, off)
    counter, off = read_ltf8(buf, off)
    bases, off = read_ltf8(buf, off)
    n_blocks, off = read_itf8(buf, off)
    n_land, off = read_itf8(buf, off)
    landmarks = []
    for _ in range(n_land):
        v, off = read_itf8(buf, off)
        landmarks.append(v)
    off += 4  # crc32
    fh.seek(off - len(rest), 1)
    return dict(length=length, ref_id=ref_id, start=start, span=span,
                n_rec=n_rec, counter=counter, bases=bases,
                n_blocks=n_blocks, landmarks=landmarks)


# --------------------------------------------------- compression header

def _preservation_map():
    # RN=1 (names kept), AP=0 (absolute positions), RR=1 (reference required;
    # every slice embeds its own span), SM identity matrix, TD single empty
    # tag line.
    items = []
    items.append(b'RN' + bytes([1]))
    items.append(b'AP' + bytes([0]))
    items.append(b'RR' + bytes([1]))
    items.append(b'SM' + bytes([0x1B] * 5))
    td = b'\x00'
    items.append(b'TD' + itf8(len(td)) + td)
    body = itf8(len(items)) + b''.join(items)
    return itf8(len(body)) + body


def _encoding_external(cid):
    params = itf8(cid)
    return itf8(1) + itf8(len(params)) + params      # codec 1 = EXTERNAL


def _encoding_byte_array_stop(stop, cid):
    params = bytes([stop]) + itf8(cid)
    return itf8(5) + itf8(len(params)) + params      # codec 5 = BYTE_ARRAY_STOP


def _data_series_map():
    items = []
    for key in _SERIES:
        if key in _BYTE_ARRAY_SERIES:
            enc = _encoding_byte_array_stop(_STOP, _CID[key])
        else:
            enc = _encoding_external(_CID[key])
        items.append(key.encode('ascii') + enc)
    body = itf8(len(items)) + b''.join(items)
    return itf8(len(body)) + body


def _tag_encoding_map():
    body = itf8(0)
    return itf8(len(body)) + body


def _compression_header_block():
    data = _preservation_map() + _data_series_map() + _tag_encoding_map()
    return _block(CT_COMPRESSION_HEADER, 0, data)


# ----------------------------------------------------------------- writer

class _SeriesBuf:
    """Per-slice external buffers, one per data series."""

    def __init__(self):
        self.buf = {k: bytearray() for k in _SERIES}

    def put_int(self, key, v):
        self.buf[key] += itf8(int(v))

    def put_byte(self, key, v):
        self.buf[key].append(int(v))

    def put_bytes(self, key, b):
        self.buf[key] += b + bytes([_STOP])


def _encode_record(sb, name, flag, rl, pos1, mapq, lens, ops, codes,
                   seq_text, ref_codes, ref_off):
    """Append one mapped record to the slice series buffers.

    codes: full read 2-bit codes (clip included); ref_codes/ref_off: the
    chromosome code array and the slice's reference-relative origin (unused —
    matches come from the embedded reference at decode time).
    """
    sb.put_int('BF', flag)
    sb.put_int('CF', CF_DETACHED)
    sb.put_int('RL', rl)
    sb.put_int('AP', pos1)
    sb.put_int('RG', -1)
    sb.put_bytes('RN', name)
    # Detached mate fields (single-end: no mate).
    sb.put_int('MF', 0)
    sb.put_int('NS', -1)
    sb.put_int('NP', 0)
    sb.put_int('TS', 0)
    sb.put_int('TL', 0)

    if flag & FLAG_UNMAPPED:
        raise ValueError('unmapped records are not produced by this engine')

    # Features from the CIGAR. Read position is 1-based; FP is delta-coded
    # (first feature: delta from position 0).
    feats = []          # (code_char, read_pos_1based, payload_fn)
    rpos = 0            # 0-based read offset
    for ln, op in zip(lens, ops):
        ln = int(ln)
        if op == cg.S:
            feats.append((b'S', rpos + 1,
                          ('SC', seq_text[rpos:rpos + ln])))
            rpos += ln
        elif op == cg.H:
            feats.append((b'H', rpos + 1, ('HC', ln)))
        elif op == cg.I:
            feats.append((b'I', rpos + 1,
                          ('IN', seq_text[rpos:rpos + ln])))
            rpos += ln
        elif op == cg.D:
            feats.append((b'D', rpos + 1, ('DL', ln)))
        elif op == cg.X:
            feats.append((b'b', rpos + 1,
                          ('BB', seq_text[rpos:rpos + ln])))
            rpos += ln
        elif op in (cg.EQ, cg.M):
            rpos += ln
        elif op == cg.N:
            feats.append((b'N', rpos + 1, ('RS', ln)))
        else:
            raise ValueError(f'unsupported CIGAR op {op}')

    sb.put_int('FN', len(feats))
    prev = 0
    for code, fpos, (skey, payload) in feats:
        sb.put_byte('FC', code[0])
        sb.put_int('FP', fpos - prev)
        prev = fpos
        if skey in ('SC', 'IN', 'BB'):
            sb.put_bytes(skey, payload)
        else:
            sb.put_int(skey, payload)
    sb.put_int('MQ', mapq)
    # CF bit 0x1 unset: no quality scores stored ('*').


def _slice_blocks(sb, ref_id, start1, span, n_rec, counter, embedded_ref):
    """Serialize slice header + core + external blocks; return (bytes, nblk)."""
    ext_blocks = []
    content_ids = []
    for key in _SERIES:
        data = bytes(sb.buf[key])
        ext_blocks.append(_block(CT_EXTERNAL, _CID[key], data))
        content_ids.append(_CID[key])
    ext_blocks.append(_block(CT_EXTERNAL, _EMBEDDED_REF_CID, embedded_ref))
    content_ids.append(_EMBEDDED_REF_CID)

    n_blocks = 1 + len(ext_blocks)          # core + externals
    header = (itf8(ref_id) + itf8(start1) + itf8(span) + itf8(n_rec)
              + ltf8(counter) + itf8(n_blocks)
              + itf8(len(content_ids))
              + b''.join(itf8(c) for c in content_ids)
              + itf8(_EMBEDDED_REF_CID)
              + bytes(16))                  # reference MD5 unset (embedded)
    blocks = _block(CT_MAPPED_SLICE, 0, header)
    blocks += _block(CT_CORE, 0, b'', method=M_RAW)
    for b in ext_blocks:
        blocks += b
    return blocks, n_blocks


def write_cram(df_align, qry_store, ref_store, out_path, hard_to_soft=True,
               index=True, slice_records=1000):
    """Write alignment records as CRAM 3.0 (+ .crai index).

    Mirrors io.sam.write_bam's record conventions (reference:
    scripts/reconstruct_sam.py:28-102): one record per alignment-table row,
    coordinate sorted, hard clips re-expanded to soft clips by default.

    :param ref_store: reference SeqStore (slices embed their reference span).
    """
    ref_fai = ref_store.fai()
    ref_names = list(ref_fai.keys())
    ref_id = {name: i for i, name in enumerate(ref_names)}

    header_text = ('@HD\tVN:1.6\tSO:coordinate\n' + ''.join(
        f'@SQ\tSN:{c}\tLN:{ref_fai[c]}\n' for c in ref_names)
        + '@PG\tID:pav_tpu\tPN:pav_tpu\n').encode('ascii')

    df = df_align.sort_values(['#CHROM', 'POS'],
                              key=lambda s: s.map(ref_id)
                              if s.name == '#CHROM' else s)

    crai_lines = []
    counter = 0
    with open(out_path, 'wb') as fh:
        fh.write(CRAM_MAGIC + (b'pav_tpu' + bytes(13))[:20])

        # SAM header container: single FILE_HEADER block, text preceded by
        # its int32 length.
        hblock = _block(CT_FILE_HEADER, 0,
                        struct.pack('<i', len(header_text)) + header_text)
        fh.write(_container_header(len(hblock), 0, 0, 0, 0, 0, 0, 1, [0]))
        fh.write(hblock)

        rows = list(df.iterrows())
        i = 0
        while i < len(rows):
            chrom = rows[i][1]['#CHROM']
            j = i
            while j < len(rows) and rows[j][1]['#CHROM'] == chrom \
                    and j - i < slice_records:
                j += 1
            chunk = [r for _, r in rows[i:j]]
            i = j

            sb = _SeriesBuf()
            beg = min(int(r['POS']) for r in chunk)
            end = max(int(r['END']) for r in chunk)
            bases = 0
            for row in chunk:
                lens, ops = cg.parse(row['CIGAR'])
                codes = qry_store.fetch_codes(row['QRY_ID'],
                                              rev_compl=bool(row['REV']))
                if hard_to_soft:
                    ops = ops.copy()
                    ops[ops == cg.H] = cg.S
                else:
                    clip_l = int(lens[0]) if len(ops) and ops[0] == cg.H else 0
                    clip_r = (int(lens[-1])
                              if len(ops) > 1 and ops[-1] == cg.H else 0)
                    codes = codes[clip_l:len(codes) - clip_r or None]
                seq_text = seqcodec.decode(codes).encode('ascii')
                flag = (int(str(row['FLAGS']), 16)
                        if isinstance(row['FLAGS'], str)
                        else int(row['FLAGS']))
                _encode_record(sb, str(row['QRY_ID']).encode('ascii'), flag,
                               len(codes), int(row['POS']) + 1,
                               int(row['MAPQ']), lens, ops, codes, seq_text,
                               None, beg)
                bases += len(codes)

            rid = ref_id[chrom]
            span = end - beg
            embedded = seqcodec.decode(
                ref_store.fetch_codes(chrom, beg, end)).encode('ascii')
            slice_bytes, _ = _slice_blocks(
                sb, rid, beg + 1, span, len(chunk), counter, embedded)
            comp = _compression_header_block()
            landmarks = [len(comp)]
            blocks = comp + slice_bytes
            n_blocks = 1 + 1 + 1 + len(_SERIES) + 1  # comp+slice hdr+core+ext
            cont_off = fh.tell()
            chead = _container_header(len(blocks), rid, beg + 1, span,
                                      len(chunk), counter, bases,
                                      n_blocks, landmarks)
            fh.write(chead + blocks)
            crai_lines.append(
                f'{rid}\t{beg + 1}\t{span}\t{cont_off}\t{len(comp)}'
                f'\t{len(slice_bytes)}\n')
            counter += len(chunk)

        fh.write(EOF_CONTAINER)

    if index:
        with gzip.open(f'{out_path}.crai', 'wt') as gz:
            gz.writelines(crai_lines)
    return out_path


# ----------------------------------------------------------------- reader

class _SeriesReader:
    def __init__(self, blocks):
        self.data = {cid: memoryview(d) for cid, d in blocks.items()}
        self.off = {cid: 0 for cid in blocks}

    def get_int(self, key):
        cid = _CID[key]
        v, self.off[cid] = read_itf8(self.data[cid], self.off[cid])
        return v

    def get_byte(self, key):
        cid = _CID[key]
        v = self.data[cid][self.off[cid]]
        self.off[cid] += 1
        return v

    def get_bytes(self, key):
        cid = _CID[key]
        buf, off = self.data[cid], self.off[cid]
        end = off
        while buf[end] != _STOP:
            end += 1
        self.off[cid] = end + 1
        return bytes(buf[off:end])


def read_cram(path):
    """Parse a CRAM file written by write_cram; return (header_text, records).

    Each record: dict(name, flag, chrom_id, pos (0-based), mapq, cigar, seq).
    Sequence is reconstructed from features + the embedded reference — an
    independent decode path exercising the container format end-to-end.
    """
    records = []
    with open(path, 'rb') as fh:
        magic = fh.read(26)
        if magic[:6] != CRAM_MAGIC:
            raise ValueError('not a CRAM 3.0 file')

        hdr = _read_container_header(fh)
        hdata = fh.read(hdr['length'])
        _, _, hblock, _ = _read_block(memoryview(hdata), 0)
        hlen = struct.unpack('<i', hblock[:4])[0]
        header_text = hblock[4:4 + hlen].decode('ascii')

        while True:
            hdr = _read_container_header(fh)
            if hdr is None:
                break
            body = memoryview(fh.read(hdr['length']))
            if hdr['ref_id'] == -1 and hdr['n_rec'] == 0:
                continue    # EOF container
            off = 0
            ctype, _, _, off = _read_block(body, off)   # compression header
            assert ctype == CT_COMPRESSION_HEADER
            ctype, _, shdr, off = _read_block(body, off)
            assert ctype == CT_MAPPED_SLICE
            p = 0
            s_ref, p = read_itf8(shdr, p)
            s_start, p = read_itf8(shdr, p)
            s_span, p = read_itf8(shdr, p)
            s_nrec, p = read_itf8(shdr, p)
            _, p = read_ltf8(shdr, p)
            s_nblk, p = read_itf8(shdr, p)
            n_ids, p = read_itf8(shdr, p)
            for _ in range(n_ids):
                _, p = read_itf8(shdr, p)
            emb_cid, p = read_itf8(shdr, p)

            blocks = {}
            for _ in range(s_nblk):   # core + external blocks
                ctype, cid, data, off = _read_block(body, off)
                if ctype == CT_EXTERNAL:
                    blocks[cid] = data
            ref_span = blocks[emb_cid]
            sr = _SeriesReader(blocks)

            for _ in range(s_nrec):
                bf = sr.get_int('BF')
                cf = sr.get_int('CF')
                rl = sr.get_int('RL')
                ap = sr.get_int('AP')
                sr.get_int('RG')
                name = sr.get_bytes('RN')
                if cf & CF_DETACHED:
                    sr.get_int('MF')
                    sr.get_int('NS')
                    sr.get_int('NP')
                    sr.get_int('TS')
                sr.get_int('TL')

                fn = sr.get_int('FN')
                seq = bytearray(b'N' * rl)
                cig = []    # (length, op char)

                def emit(op, ln):
                    if cig and cig[-1][1] == op:
                        cig[-1][0] += ln
                    else:
                        cig.append([ln, op])

                rpos = 0        # 0-based read cursor
                gpos = ap - s_start  # 0-based offset into embedded ref span
                prev_fp = 0
                for _ in range(fn):
                    fc = chr(sr.get_byte('FC'))
                    fp = sr.get_int('FP') + prev_fp
                    prev_fp = fp
                    # Matched stretch before this feature.
                    gap = (fp - 1) - rpos
                    if gap > 0:
                        seq[rpos:rpos + gap] = ref_span[gpos:gpos + gap]
                        emit('=', gap)
                        rpos += gap
                        gpos += gap
                    if fc == 'S':
                        b = sr.get_bytes('SC')
                        seq[rpos:rpos + len(b)] = b
                        emit('S', len(b))
                        rpos += len(b)
                    elif fc == 'I':
                        b = sr.get_bytes('IN')
                        seq[rpos:rpos + len(b)] = b
                        emit('I', len(b))
                        rpos += len(b)
                    elif fc == 'b':
                        b = sr.get_bytes('BB')
                        seq[rpos:rpos + len(b)] = b
                        emit('X', len(b))
                        rpos += len(b)
                        gpos += len(b)
                    elif fc == 'D':
                        ln = sr.get_int('DL')
                        emit('D', ln)
                        gpos += ln
                    elif fc == 'H':
                        emit('H', sr.get_int('HC'))
                    elif fc == 'N':
                        ln = sr.get_int('RS')
                        emit('N', ln)
                        gpos += ln
                    else:
                        raise ValueError(f'unsupported feature code {fc}')
                tail = rl - rpos
                if tail > 0:
                    seq[rpos:rpos + tail] = ref_span[gpos:gpos + tail]
                    emit('=', tail)
                mq = sr.get_int('MQ')
                records.append(dict(
                    name=name.decode('ascii'), flag=bf, chrom_id=s_ref,
                    pos=ap - 1, mapq=mq,
                    cigar=''.join(f'{ln}{op}' for ln, op in cig),
                    seq=bytes(seq).decode('ascii')))
    return header_text, records
