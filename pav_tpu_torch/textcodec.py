"""The port's host text codec: FASTA in, TSV and VCF out, off the
interpreter lock.

``hostsrc/textcodec.cpp`` does the text: it parses FASTA into base codes,
formats a table's typed columns as ``DataFrame.to_csv(sep='\\t',
index=False)`` writes them, and formats VCF records with their tabix index.
It is built with ``g++`` on first use into ``build/torch_text/`` (the file
named by a hash of the source and flags, written to a temporary file and
renamed into place) and called through ``ctypes``, which releases the lock
for every call. Python moves the blocks: it reads a file a block at a time
and feeds it in, and deflates what comes out with ``zlib`` (which releases
the lock too): a gzip stream for a table (level 2), ``io.bgzf``'s blocks
for the VCF and its index. So a thread writing tables holds the lock only
to hand the codec its columns.

Where ``g++`` is missing or the build fails, where a file holds bytes
outside ASCII, where a reader would raise, or where a column has a type the
codec does not format, the Python path runs instead (``io.fasta``,
``to_csv``, ``io.bgzf`` and ``io.tabix``), which writes the same bytes
(deflated apart from the gzip header) and raises the same errors.

Each read is an ``io.fasta`` span and each table or VCF written an
``emit.table`` span, counting ``bytes`` (of the file on disk), ``records``
or ``rows`` and ``on`` (``native`` or ``python``); an ``emit.table`` also
names its table (``name``).
"""

import ctypes
import gzip
import hashlib
import os
import subprocess
import threading
import zlib

import numpy as np
import pandas as pd

from . import seqcodec, spans
from .io import fasta
from .io.bgzf import _BLOCK_MAX, BGZF_EOF, _compress_block

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, 'hostsrc', 'textcodec.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_text')
FLAGS = ['-O2', '-std=c++17', '-shared', '-fPIC']
BLOCK = 1 << 22  # bytes a read, and a formatted block
GZIP_LEVEL = 2   # the artifacts' level, as io.bgzf's blocks

_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int32
_LP = ctypes.POINTER(ctypes.c_int64)
SIGNATURES = {
    'pav_fa_new': ([], _P),
    'pav_fa_free': ([_P], None),
    'pav_fa_feed': ([_P, _P, _L], ctypes.c_int),
    'pav_fa_finish': ([_P], ctypes.c_int),
    'pav_fa_count': ([_P], _L),
    'pav_fa_name': ([_P, _L, _LP], _P),
    'pav_fa_len': ([_P, _L], _L),
    'pav_fa_take': ([_P, _L, _P], None),
    # ncols, nrows, kinds, data, offsets, valid, bit0, data_len, vcf, base
    'pav_tab_new': ([_I, _L, _P, _P, _P, _P, _P, _P, _I, _L], _P),
    'pav_tab_free': ([_P], None),
    'pav_tab_header': ([_P, _P, _L, _I], None),
    'pav_tab_next': ([_P, _L, ctypes.POINTER(_P), _LP], _L),
    'pav_tab_tabix': ([_P, _P, _L, _L, ctypes.POINTER(_P), _LP], _I),
}
# Column kinds of textcodec.cpp.
INT64, FLOAT64, BOOL, JOINED, ARROW, UINT64 = range(6)

_LOCK = threading.Lock()
_STATE = {}  # 'lib': the loaded library or None, once tried


def _so_path():
    h = hashlib.sha256(' '.join(FLAGS).encode())
    with open(_SRC, 'rb') as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f'libpavtext-{h.hexdigest()[:16]}.so')


def _build(so_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so_path}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        subprocess.run(['g++', *FLAGS, _SRC, '-o', tmp], check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def lib():
    """The codec library, built on the first call; None where it cannot be
    built (the Python path then runs)."""
    with _LOCK:
        if 'lib' not in _STATE:
            handle = None
            try:
                so_path = _so_path()
                if not os.path.exists(so_path):
                    _build(so_path)
                handle = ctypes.CDLL(so_path)
                for name, (argtypes, restype) in SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            except (OSError, subprocess.CalledProcessError):
                handle = None
            _STATE['lib'] = handle
        return _STATE['lib']


# ------------------------------------------------------------------ FASTA

def _read_fasta_native(codec, path):
    """{name: codes} of the FASTA at ``path`` (gzip read by its magic bytes,
    as io.fasta does), or None where the codec stopped (io.fasta's reader
    then reads it)."""
    h = codec.pav_fa_new()
    try:
        buf = np.empty(BLOCK, dtype=np.uint8)
        with open(path, 'rb') as raw:
            gz = raw.read(2) == b'\x1f\x8b'
            raw.seek(0)
            src = gzip.GzipFile(fileobj=raw) if gz else raw
            err = 0
            while not err:
                n = src.readinto(buf)
                if not n:
                    err = codec.pav_fa_finish(h)
                    break
                err = codec.pav_fa_feed(h, buf.ctypes.data, n)
        if err:
            return None
        seqs = {}
        length = ctypes.c_int64()
        for i in range(codec.pav_fa_count(h)):
            name = ctypes.string_at(codec.pav_fa_name(h, i, ctypes.byref(length)),
                                    length.value).decode('ascii')
            codes = np.empty(codec.pav_fa_len(h, i), dtype=np.uint8)
            codec.pav_fa_take(h, i, codes.ctypes.data)
            seqs[name] = codes
        return seqs
    finally:
        codec.pav_fa_free(h)


def read_fasta(path):
    """{name: uint8 codes} of a plain or gzipped FASTA file: the result and
    errors of ``io.fasta.read_fasta``."""
    with spans.span('io.fasta') as sp:
        codec = lib()
        seqs = _read_fasta_native(codec, path) if codec is not None else None
        on = 'native'
        if seqs is None:
            seqs, on = fasta.read_fasta(path), 'python'
        sp.counts.update(bytes=os.path.getsize(path), records=len(seqs), on=on)
    return seqs


def read_seq_file(path):
    """``io.fasta.read_seq_file`` with FASTA read by the codec (FASTQ and
    GFA by io.fasta, as an ``io.fasta`` span on the Python path)."""
    base = str(path)
    if base.endswith('.gz'):
        base = base[:-3]
    if base.lower().endswith(('.fa', '.fasta', '.fna')):
        return read_fasta(path)
    with spans.span('io.fasta') as sp:
        seqs = fasta.read_seq_file(path)
        sp.counts.update(bytes=os.path.getsize(path), records=len(seqs), on='python')
    return seqs


def load_haplotype_seqs(path_spec, asm_name, hap):
    """``assembly_table.load_haplotype_seqs`` through ``read_seq_file``."""
    from .assembly_table import expand_input

    store = fasta.SeqStore()
    for path in expand_input(path_spec, asm_name, hap):
        if not os.path.isfile(path):
            raise FileNotFoundError(f'Input not found for {asm_name}/{hap}: {path}')
        if os.path.getsize(path) == 0:
            continue  # empty file = missing haplotype input
        for name, codes in read_seq_file(path).items():
            store.add(name, codes)
    return store


def md5_of_codes(codes):
    """MD5 hex digest of ``seqcodec.decode(codes)``, decoded a block at a
    time through seqcodec's table: no string of the sequence."""
    h = hashlib.md5()
    for i in range(0, len(codes), BLOCK):
        h.update(seqcodec._DECODE_LUT[np.minimum(codes[i:i + BLOCK], seqcodec.AMBIG)])
    return h.hexdigest()


# ------------------------------------------------------------------ tables

class _Col:
    """One column as the codec reads it; holds the arrays it points into."""

    __slots__ = ('kind', 'data', 'offsets', 'valid', 'bit0', 'size', 'keep')

    def __init__(self, kind, data, offsets=0, valid=0, bit0=0, size=0, keep=()):
        self.kind, self.offsets, self.valid, self.bit0, self.size = (
            kind, offsets, valid, bit0, size)
        self.keep = [data, *keep]
        self.data = data if isinstance(data, int) else data.ctypes.data


def _joined(strings):
    """A JOINED column of str values, or None where one holds a NUL or
    cannot be encoded (the Python path then writes, or raises)."""
    try:
        blob = '\0'.join(strings).encode('utf-8')
    except (UnicodeEncodeError, TypeError):
        return None
    if len(strings) and blob.count(b'\0') != len(strings) - 1:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
    return _Col(JOINED, buf, size=len(blob), keep=[blob])


def _arrow(values, vcf):
    """An ARROW column of pyarrow-backed strings (pandas' ``str``): None
    where the VCF would meet a missing value, or the type is not Arrow's
    ``large_string``."""
    import pyarrow as pa

    arr = values.__arrow_array__()
    if hasattr(arr, 'combine_chunks'):
        arr = arr.combine_chunks()
    if not pa.types.is_large_string(arr.type) or (vcf and arr.null_count):
        return None
    valid, offsets, data = arr.buffers()
    keep = [arr, valid, offsets, data]
    return _Col(ARROW, data.address if data is not None else 0, offsets=offsets.address,
                valid=valid.address if valid is not None else 0, bit0=arr.offset,
                keep=keep)


def _column(series, vcf):
    """The codec's form of a column (None where only pandas can write it):
    for a table as ``to_csv`` writes it (NA empty), for the VCF as
    ``astype(str)`` gives it."""
    dtype = series.dtype
    if isinstance(dtype, np.dtype) and dtype.kind in 'iub':
        values = series.to_numpy()
        if dtype.kind == 'b':
            return _Col(BOOL, np.ascontiguousarray(values.view(np.uint8)))
        if dtype == np.uint64:
            return _Col(UINT64, np.ascontiguousarray(values))
        return _Col(INT64, np.ascontiguousarray(values, dtype=np.int64))
    if isinstance(dtype, np.dtype) and dtype.kind == 'f' and not vcf:
        values = series.to_numpy()
        if dtype == np.float64:
            return _Col(FLOAT64, np.ascontiguousarray(values))
        # Other widths (the density tables' float32): numpy's own text, as
        # to_csv takes it; its layout rule for them varies by version.
        text = values.astype(str).astype(object)
        text[np.isnan(values)] = ''
        return _joined(text)
    values = series.array
    if isinstance(dtype, pd.StringDtype) and dtype.storage == 'pyarrow':
        return _arrow(values, vcf)
    if not (isinstance(dtype, pd.StringDtype) or dtype == object):
        return _column(series.astype(str), vcf) if vcf else None
    values = series.to_numpy(dtype=object)
    kind = pd.api.types.infer_dtype(values, skipna=False)
    if kind == 'integer':  # Python or numpy ints, none missing
        try:
            return _Col(INT64, np.asarray(values, dtype=np.int64))
        except OverflowError:
            pass
    if vcf:
        if kind == 'string':
            return _joined(values)
        if isinstance(dtype, pd.StringDtype):
            return None  # missing values: the Python writer decides
        return _column(series.astype(str), vcf)
    na = pd.isna(values)
    if pd.api.types.infer_dtype(values, skipna=True) == 'string':
        if na.any():
            values = values.copy()
            values[na] = ''
        return _joined(values)
    return _joined(['' if m else str(v) for v, m in zip(values, na)])


def _table(codec, df, vcf, base=0):
    """(the codec's handle of ``df``'s table, its columns, which the caller
    keeps alive until it frees the handle), or (None, None) where a column
    has no codec form."""
    cols = [_column(df.iloc[:, j], vcf) for j in range(df.shape[1])]
    if not cols or any(c is None for c in cols):
        return None, None
    n = len(cols)

    def arr(values, ctype):
        return (ctype * n)(*values)
    h = codec.pav_tab_new(
        n, df.shape[0], arr([c.kind for c in cols], ctypes.c_int32),
        arr([c.data for c in cols], ctypes.c_void_p),
        arr([c.offsets for c in cols], ctypes.c_void_p),
        arr([c.valid for c in cols], ctypes.c_void_p),
        arr([c.bit0 for c in cols], ctypes.c_int64),
        arr([c.size for c in cols], ctypes.c_int64), int(vcf), base)
    return h, cols


def _blocks(codec, h, nrows):
    """The table's text, a block at a time (each valid until the next)."""
    text, length = ctypes.c_void_p(), ctypes.c_int64()
    while True:
        done = codec.pav_tab_next(h, BLOCK, ctypes.byref(text), ctypes.byref(length))
        if length.value:
            yield (ctypes.c_char * length.value).from_address(text.value)
        if done == nrows:
            return


def _write_table_native(codec, df, path):
    names = _joined(list(df.columns))
    h, cols = _table(codec, df, vcf=False) if names is not None else (None, None)
    if h is None:
        return False
    try:
        codec.pav_tab_header(h, names.data, names.size, len(cols))
        comp = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, 31)
        with open(path, 'wb') as fh:
            for block in _blocks(codec, h, df.shape[0]):
                fh.write(comp.compress(block))
            fh.write(comp.flush())
        return True
    finally:
        codec.pav_tab_free(h)


def write_table(df, path, name):
    """``df.to_csv(path, sep='\\t', index=False)`` gzipped at level 2, as
    span ``emit.table`` named ``name``."""
    with spans.span('emit.table') as sp:
        sp.counts['name'] = name
        codec = lib()
        on = 'native'
        if codec is None or not _write_table_native(codec, df, path):
            df.to_csv(path, sep='\t', index=False,
                      compression={'method': 'gzip', 'compresslevel': GZIP_LEVEL})
            on = 'python'
        sp.counts.update(rows=df.shape[0], bytes=os.path.getsize(path), on=on)


# ------------------------------------------------------------------ VCF

class _Bgzf:
    """io.bgzf's BgzfWriter over a file handle, keeping each block's
    compressed start (``cstart``: one entry a block and one past the last)."""

    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()
        self.cstart = [0]

    def _blocks(self, blocks):
        for data in blocks:
            block = _compress_block(data)
            self.fh.write(block)
            self.cstart.append(self.cstart[-1] + len(block))

    def write(self, data):
        view = memoryview(data).cast('B')
        blocks = []
        if self.buf:
            take = _BLOCK_MAX - len(self.buf)
            self.buf += view[:take]
            view = view[take:]
            if len(self.buf) < _BLOCK_MAX:
                return
            blocks.append(bytes(self.buf))
            self.buf = bytearray()
        while len(view) >= _BLOCK_MAX:
            blocks.append(view[:_BLOCK_MAX])
            view = view[_BLOCK_MAX:]
        self.buf += view
        self._blocks(blocks)

    def close(self):
        if self.buf:
            self._blocks([bytes(self.buf)])
            self.buf = bytearray()
        self.fh.write(BGZF_EOF)


def write_vcf(header, df, path, tbi_path):
    """Write ``header`` (text) and the records of ``df`` (the VCF's columns,
    each written as ``astype(str)`` gives it, one line a row) to ``path`` as
    BGZF, and the tabix index to ``tbi_path``: the bytes of ``vcf.py``'s
    Python writer. Returns False, having written nothing it keeps, where
    the codec cannot write them (that writer then runs)."""
    codec = lib()
    if codec is None:
        return False
    head = header.encode('utf-8')
    h, _cols = _table(codec, df, vcf=True, base=len(head))
    if h is None:
        return False
    try:
        with open(path, 'wb') as fh:
            out = _Bgzf(fh)
            out.write(head)
            for block in _blocks(codec, h, df.shape[0]):
                out.write(block)
            total = (len(out.cstart) - 1) * _BLOCK_MAX + len(out.buf)
            out.close()
        cstart = np.asarray(out.cstart, dtype=np.int64)
        text, length = ctypes.c_void_p(), ctypes.c_int64()
        if not codec.pav_tab_tabix(h, cstart.ctypes.data, _BLOCK_MAX, total,
                                   ctypes.byref(text), ctypes.byref(length)):
            return False
        with open(tbi_path, 'wb') as fh:
            tbi = _Bgzf(fh)
            tbi.write((ctypes.c_char * length.value).from_address(text.value)
                      if length.value else b'')
            tbi.close()
        return True
    finally:
        codec.pav_tab_free(h)

