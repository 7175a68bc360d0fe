"""Tabix (.tbi) index writer and reader for BGZF VCF output.

The reference indexes its VCF with the external tabix binary
(rules/vcf.snakefile:97); without htslib in the image this module implements
the .tbi format directly (binning + linear index per the SAM/tabix spec), and a
reader used both for self-validation and in-process region queries.
"""

import gzip
import struct
import zlib

import numpy as np

from .bgzf import BgzfWriter

_FMT_VCF = 2
_MAGIC = b'TBI\x01'


def reg2bin(beg, end):
    """UCSC binning: smallest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg, end):
    """All bins overlapping [beg, end) (for queries)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def write_tabix(records, out_path):
    """Write a .tbi index.

    :param records: iterable of (ref_name, beg, end, voffset_start, voffset_end)
        in file order (coordinate-sorted within each reference).
    :param out_path: path of the .tbi file (plain BGZF-compressed).
    """
    ref_names = []
    per_ref = {}
    for name, beg, end, vs, ve in records:
        if name not in per_ref:
            ref_names.append(name)
            per_ref[name] = []
        per_ref[name].append((int(beg), int(end), int(vs), int(ve)))

    out = BgzfWriter(out_path)
    body = bytearray()
    body += _MAGIC
    body += struct.pack('<i', len(ref_names))
    body += struct.pack('<6i', _FMT_VCF, 1, 2, 0, ord('#'), 0)
    names_blob = b''.join(n.encode() + b'\x00' for n in ref_names)
    body += struct.pack('<i', len(names_blob))
    body += names_blob

    for name in ref_names:
        recs = per_ref[name]
        bins = {}
        n_wins = 0
        for beg, end, vs, ve in recs:
            b = reg2bin(beg, max(end, beg + 1))
            bins.setdefault(b, []).append((vs, ve))
            n_wins = max(n_wins, (max(end, beg + 1) - 1) >> 14)
        n_wins += 1
        ioff = np.zeros(n_wins, dtype=np.uint64)
        seen = np.zeros(n_wins, dtype=bool)
        for beg, end, vs, ve in recs:
            w0, w1 = beg >> 14, (max(end, beg + 1) - 1) >> 14
            for w in range(w0, w1 + 1):
                if not seen[w] or vs < ioff[w]:
                    ioff[w] = vs
                    seen[w] = True
        # Fill unseen windows with the next seen value (spec-compatible: use
        # the previous record's offset; zeros are also accepted by readers).
        last = 0
        for w in range(n_wins):
            if seen[w]:
                last = int(ioff[w])
            else:
                ioff[w] = last

        body += struct.pack('<i', len(bins))
        for b in sorted(bins):
            chunks = _merge_chunks(bins[b])
            body += struct.pack('<I', b)
            body += struct.pack('<i', len(chunks))
            for vs, ve in chunks:
                body += struct.pack('<QQ', vs, ve)
        body += struct.pack('<i', n_wins)
        for w in range(n_wins):
            body += struct.pack('<Q', int(ioff[w]))

    out.write(bytes(body))
    out.close()


def _merge_chunks(chunks):
    chunks = sorted(chunks)
    out = [list(chunks[0])]
    for vs, ve in chunks[1:]:
        if vs <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ve)
        else:
            out.append([vs, ve])
    return [(a, b) for a, b in out]


class TabixIndex:
    """Reader for .tbi files + region query over the indexed BGZF file."""

    def __init__(self, tbi_path):
        with gzip.open(tbi_path, 'rb') as fh:
            data = fh.read()
        if data[:4] != _MAGIC:
            raise ValueError('Not a tabix index')
        off = 4
        (n_ref,) = struct.unpack_from('<i', data, off); off += 4
        (self.fmt, self.col_seq, self.col_beg, self.col_end,
         self.meta, self.skip) = struct.unpack_from('<6i', data, off); off += 24
        (l_nm,) = struct.unpack_from('<i', data, off); off += 4
        self.names = data[off:off + l_nm].split(b'\x00')[:-1]
        self.names = [n.decode() for n in self.names]
        off += l_nm

        self.bins = []
        self.linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from('<i', data, off); off += 4
            bmap = {}
            for _ in range(n_bin):
                (b,) = struct.unpack_from('<I', data, off); off += 4
                (n_chunk,) = struct.unpack_from('<i', data, off); off += 4
                chunks = []
                for _ in range(n_chunk):
                    vs, ve = struct.unpack_from('<QQ', data, off); off += 16
                    chunks.append((vs, ve))
                bmap[b] = chunks
            (n_intv,) = struct.unpack_from('<i', data, off); off += 4
            lin = struct.unpack_from(f'<{n_intv}Q', data, off); off += 8 * n_intv
            self.bins.append(bmap)
            self.linear.append(list(lin))

    def query(self, vcf_path, chrom, beg, end):
        """Yield VCF record lines overlapping [beg, end) (0-based half-open)."""
        if chrom not in self.names:
            return
        ri = self.names.index(chrom)
        cand_bins = reg2bins(beg, end)
        chunks = []
        min_ioff = 0
        lin = self.linear[ri]
        if lin and (beg >> 14) < len(lin):
            min_ioff = lin[beg >> 14]
        for b in cand_bins:
            for vs, ve in self.bins[ri].get(b, ()):
                if ve > min_ioff:
                    chunks.append((max(vs, min_ioff), ve))
        if not chunks:
            return
        chunks = _merge_chunks(chunks)

        with open(vcf_path, 'rb') as raw:
            for vs, ve in chunks:
                for line in _read_lines_between(raw, vs, ve):
                    parts = line.split('\t')
                    if parts[0] != chrom:
                        continue
                    pos1 = int(parts[1])
                    rec_beg = pos1 - 1
                    rec_end = rec_beg + max(len(parts[3]), 1)
                    # Symbolic ALTs (e.g. <INV>) span to INFO END when present,
                    # matching htslib's interval semantics.
                    if len(parts) > 7 and 'END=' in parts[7]:
                        for field in parts[7].split(';'):
                            if field.startswith('END='):
                                try:
                                    rec_end = max(rec_end, int(field[4:]))
                                except ValueError:
                                    pass
                                break
                    if rec_beg < end and rec_end > beg:
                        yield line


def _read_lines_between(raw, v_start, v_end):
    """Decode BGZF blocks covering [v_start, v_end) and yield complete lines."""
    c_start = v_start >> 16
    u_start = v_start & 0xFFFF
    c_end = v_end >> 16
    raw.seek(c_start)
    buf = b''
    coffset = c_start
    while coffset <= c_end:
        header = raw.read(18)
        if len(header) < 18:
            break
        (bsize,) = struct.unpack_from('<H', header, 16)
        block = raw.read(bsize + 1 - 18)
        payload = zlib.decompress(block[:-8], -15)
        if coffset == c_start:
            payload = payload[u_start:]
        buf += payload
        coffset += bsize + 1
    for line in buf.split(b'\n'):
        if line:
            yield line.decode()
