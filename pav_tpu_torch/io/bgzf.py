"""Minimal BGZF (blocked gzip) writer/reader.

BGZF is the htslib container required for indexed VCF/BED output (reference
emits VCFs with Bio.bgzf + tabix: pavlib/vcf.py:324, rules/vcf.snakefile:97).
Self-contained stdlib-only implementation: each block is an independent gzip
member with the BC extra field carrying the compressed block size.
"""

import struct
import zlib

_BLOCK_MAX = 65280  # Max uncompressed payload per block (htslib convention)

# 28-byte EOF marker block (empty payload), per SAM/BGZF spec.
BGZF_EOF = bytes.fromhex(
    '1f8b08040000000000ff0600424302001b0003000000000000000000'
)


def _compress_block(data, level=2):
    # Level 2: ~3x faster than the zlib default with ~10-15% larger blocks —
    # BGZF spends its time in deflate, and these are regenerable artifacts.
    crc = zlib.crc32(data) & 0xFFFFFFFF
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    bsize = len(payload) + 25 + 1  # header(12) + XLEN extra(6) + payload + crc(4) + isize(4) = 26+len-1 stored
    header = struct.pack(
        '<BBBBIBBHBBHH',
        0x1f, 0x8b, 8, 4,    # magic, CM=deflate, FLG=FEXTRA
        0, 0, 0xff,          # MTIME, XFL, OS
        6,                   # XLEN
        66, 67, 2,           # 'B', 'C', SLEN=2
        bsize - 1,           # BSIZE (total block size minus 1)
    )
    return header + payload + struct.pack('<II', crc, len(data))


class BgzfWriter:
    """Text-mode BGZF writer with virtual-offset tracking (for tabix)."""

    def __init__(self, path):
        self._fh = open(path, 'wb')
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written (start of current block)

    def tell_virtual(self):
        """BGZF virtual offset of the next byte written:
        (compressed block start << 16) | within-block offset."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, text):
        self._buf += text.encode('utf-8') if isinstance(text, str) else text
        while len(self._buf) >= _BLOCK_MAX:
            block = _compress_block(bytes(self._buf[:_BLOCK_MAX]))
            self._fh.write(block)
            self._coffset += len(block)
            del self._buf[:_BLOCK_MAX]

    def close(self):
        if self._fh is None:
            return
        if self._buf:
            self._fh.write(_compress_block(bytes(self._buf)))
            self._buf = bytearray()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_bgzf(path, mode='wt'):
    if 'w' in mode:
        return BgzfWriter(path)
    raise NotImplementedError('Reading uses gzip (BGZF is gzip-compatible)')
