"""The aligner's host path in C++ over columns, off the interpreter lock.

``hostsrc/aligner.cpp`` plans a contig from its chains (both selection
passes, every chain's boundary walk and refinement, the end extensions)
and assembles a haplotype's records from the plans and the DP results. It
is built with ``g++`` on first use into ``build/torch_aligner/`` through
``_build.library`` and called through ``ctypes.CDLL``, which releases the
lock for every call, so the planning threads of both haplotypes run at
once. Where it cannot be built, ``lib()`` is None and ``core`` runs its
Python planner, which gives the same table.

A plan is columns (``Plan``): a row a chain (``CHAIN_COLS``), the chains'
parts (a run of one op, or a segment: op ``SEG``, the length then the
segment's number) and a row a segment (``SEG_COLS``: its kind and the
query and reference windows the DP reads).
"""

import ctypes
import os
import subprocess
import threading
import warnings

import numpy as np

from ... import _build

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_PKG_DIR, 'hostsrc', 'aligner.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_aligner')
FLAGS = ['-O2', '-std=c++17', '-shared', '-fPIC']

_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int32
SIGNATURES = {
    # fwd, rc, qlen, ref_ptrs, ref_len, n_chains, off, qpos, rpos, chrom, rev,
    # score, k, params
    'pav_plan_contig': ([_P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P, _P, _L, _P], _P),
    'pav_plan_count': ([_P, _I], _L),
    'pav_plan_take': ([_P, _I, _P], None),
    'pav_plan_free': ([_P], None),
    # n_chains, chains, part_len, part_op, segs, res_lens, res_ops, scoring, params
    'pav_emit_records': ([_L, _P, _P, _P, _P, _P, _P, _P, _P], _P),
    'pav_records_count': ([_P, _I], _L),
    'pav_records_take': ([_P, _I, _P], None),
    'pav_records_free': ([_P], None),
}

# Segment kinds and the part op of a segment (aligner.cpp).
DP, BREAK, EXT_L, EXT_R = range(4)
SEG = -1
CHAIN_COLS = ('chrom', 'rev', 'q_start', 'r_start', 'q_end', 'r_end', 'mapq',
              'part0', 'n_parts')
SEG_COLS = ('kind', 'qsrc', 'qoff', 'qlen', 'qrev', 'rsrc', 'roff', 'rlen', 'rrev')

_LOCK = threading.Lock()
_STATE = {}  # 'lib': the loaded library or None, once tried
# The first lib() call's outcome: path and cached, or error (the compiler's
# output, or why the library could not be written or loaded).
BUILD_INFO = {}


def _compile(out):
    subprocess.run(['g++', *FLAGS, _SRC, '-o', out], check=True, capture_output=True,
                   text=True)


def lib():
    """The planner library, built on the first call; None where it cannot be
    built (the Python planner then runs, and a warning carries the reason,
    kept in ``BUILD_INFO['error']``)."""
    with _LOCK:
        if 'lib' not in _STATE:
            BUILD_INFO.clear()
            try:
                handle, path, log = _build.library(BUILD_DIR, 'libpavalign', [_SRC], FLAGS,
                                                   _compile, SIGNATURES)
                BUILD_INFO.update(path=path, cached=log is None)
            except (OSError, subprocess.CalledProcessError) as ex:
                handle = None
                BUILD_INFO['error'] = (f'{ex}\n{ex.stderr}'
                                       if isinstance(ex, subprocess.CalledProcessError)
                                       else str(ex))
                warnings.warn('the aligner\'s planner library did not build; the Python '
                              'planner runs: ' + BUILD_INFO['error'])
            _STATE['lib'] = handle
        return _STATE['lib']


def _ptr(a):
    return a.ctypes.data if a is not None else None


class Plan:
    """One contig's plan, or a haplotype's plans joined (``join``):
    ``chains`` [n, 9] (``CHAIN_COLS``), ``part_len``, ``part_op``,
    ``segs`` [n, 9] (``SEG_COLS``), and, joined, ``contig`` (each chain's
    contig) and ``seg_contig`` (each segment's)."""

    __slots__ = ('chains', 'part_len', 'part_op', 'segs', 'contig', 'seg_contig')

    def __init__(self, chains, part_len, part_op, segs, contig=None, seg_contig=None):
        self.chains, self.part_len, self.part_op, self.segs = chains, part_len, part_op, segs
        self.contig, self.seg_contig = contig, seg_contig

    def col(self, name):
        """A chain column by ``CHAIN_COLS`` name, or a segment column by
        ``SEG_COLS`` name."""
        if name in SEG_COLS:
            return self.segs[:, SEG_COLS.index(name)]
        return self.chains[:, CHAIN_COLS.index(name)]

    @classmethod
    def join(cls, plans):
        """The plans of a haplotype's contigs as one: part and segment
        numbers rebased, each row's contig number beside it."""
        chains, part_len, part_op, segs, contig, seg_contig = [], [], [], [], [], []
        n_parts = n_segs = 0
        for ci, p in enumerate(plans):
            c = p.chains.copy()
            c[:, CHAIN_COLS.index('part0')] += n_parts
            chains.append(c)
            lens = p.part_len.copy()
            lens[p.part_op == SEG] += n_segs
            part_len.append(lens)
            part_op.append(p.part_op)
            segs.append(p.segs)
            contig.append(np.full(len(c), ci, dtype=np.int64))
            seg_contig.append(np.full(len(p.segs), ci, dtype=np.int64))
            n_parts += len(lens)
            n_segs += len(p.segs)

        def cat(arrs, shape, dtype):
            return np.concatenate(arrs) if arrs else np.zeros(shape, dtype=dtype)

        return cls(cat(chains, (0, len(CHAIN_COLS)), np.int64), cat(part_len, 0, np.int64),
                   cat(part_op, 0, np.int8), cat(segs, (0, len(SEG_COLS)), np.int64),
                   cat(contig, 0, np.int64), cat(seg_contig, 0, np.int64))


def plan_contig(handle, fwd, rc, refs, chain_set, k, params):
    """The plan of one contig (``Plan``) from its ``ChainSet``: ``fwd`` and
    ``rc`` its codes in both orientations (``rc`` None where no chain is
    reverse), ``refs`` the chromosomes' codes by number (uint8, contiguous),
    ``params`` core's thresholds (float64)."""
    cs = chain_set
    ref_ptrs = np.array([a.ctypes.data for a in refs], dtype=np.int64)
    ref_len = np.array([len(a) for a in refs], dtype=np.int64)
    off = np.ascontiguousarray(cs.off, dtype=np.int64)
    qpos = np.ascontiguousarray(cs.qpos, dtype=np.int64)
    rpos = np.ascontiguousarray(cs.rpos, dtype=np.int64)
    chrom = np.ascontiguousarray(cs.chrom, dtype=np.int32)
    rev = np.ascontiguousarray(cs.rev, dtype=np.uint8)
    score = np.ascontiguousarray(cs.score, dtype=np.float64)
    params = np.ascontiguousarray(params, dtype=np.float64)
    h = handle.pav_plan_contig(
        _ptr(fwd), _ptr(rc), len(fwd), ref_ptrs.ctypes.data, ref_len.ctypes.data,
        len(score), off.ctypes.data, qpos.ctypes.data, rpos.ctypes.data, chrom.ctypes.data,
        rev.ctypes.data, score.ctypes.data, int(k), params.ctypes.data)
    try:
        n_chains = handle.pav_plan_count(h, 0)
        n_parts = handle.pav_plan_count(h, 1)
        n_segs = handle.pav_plan_count(h, 2)
        chains = np.empty((n_chains, len(CHAIN_COLS)), dtype=np.int64)
        part_len = np.empty(n_parts, dtype=np.int64)
        part_op = np.empty(n_parts, dtype=np.int8)
        segs = np.empty((n_segs, len(SEG_COLS)), dtype=np.int64)
        for which, out in enumerate((chains, part_len, part_op, segs)):
            handle.pav_plan_take(h, which, out.ctypes.data)
    finally:
        handle.pav_plan_free(h)
    return Plan(chains, part_len, part_op, segs)


def emit_records(handle, chains, part_len, part_op, segs, res_lens, res_ops, scoring,
                 params):
    """A haplotype's records: ([n, 5] int64 rows of (chain, r0, r1, qry_pos,
    qry_end), [n] CIGAR strings). ``chains`` [c, 6] rows of (q_start,
    r_start, qlen, is_rev, first part, parts); ``segs`` [s, 5] rows of
    (kind, qlen, rlen, first result run, runs); ``res_lens`` / ``res_ops``
    the DP results' runs; ``scoring`` (match, mismatch, o1, o2, e1, e2)."""
    arrs = [np.ascontiguousarray(chains, dtype=np.int64),
            np.ascontiguousarray(part_len, dtype=np.int64),
            np.ascontiguousarray(part_op, dtype=np.int8),
            np.ascontiguousarray(segs, dtype=np.int64),
            np.ascontiguousarray(res_lens, dtype=np.int32),
            np.ascontiguousarray(res_ops, dtype=np.int8),
            np.ascontiguousarray(scoring, dtype=np.int64),
            np.ascontiguousarray(params, dtype=np.float64)]
    h = handle.pav_emit_records(len(arrs[0]), *(a.ctypes.data for a in arrs))
    try:
        rows = np.empty((handle.pav_records_count(h, 0), 5), dtype=np.int64)
        text = np.empty(handle.pav_records_count(h, 1), dtype=np.uint8)
        handle.pav_records_take(h, 0, rows.ctypes.data)
        handle.pav_records_take(h, 1, text.ctypes.data)
    finally:
        handle.pav_records_free(h)
    cigars = text.tobytes().decode('ascii').split('\n')[:-1] if len(text) else []
    return rows, cigars
