"""Build and load the port's shared libraries (ctypes), and the CUDA
kernels of ``csrc/`` (nvcc).

One routine builds and loads every library the port compiles: the CUDA
kernels here, the text codec of ``hostsrc/`` (``textcodec``) and the host
runtime of ``native/`` (``native``, through ``build`` alone); each caller
supplies its own compile step. ``library`` names the file by a hash of the
sources and flags, so an edited source or flag builds anew and an unchanged
one loads the cached file with no compiler looked up, and declares a
``SIGNATURES`` table on it; ``build`` compiles to a temporary file named by
process and thread and renames it into place, so two processes or threads
building at once never load a half-written library. A library is written
only under the checkout's ``build/``: where that cannot be written, the
build fails and the caller raises or runs its Python path.

All ``csrc/*.cu`` files compile with nvcc into one shared library with a
plain C interface, at first use, into ``build/torch_kernels/`` beside the
package: one nvcc per source, all started together, then one link. Every C
entry takes its pointers and the CUDA stream as ``void*``, launches on that
stream, and returns ``cudaGetLastError()``; ``check`` turns a nonzero code
into an exception. Nothing here runs for CPU tensors: the CPU path never
calls nvcc.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_kernels')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry points: name -> (argtypes, restype); every pointer and the stream
# pass as void*, every launcher returns cudaGetLastError().
SIGNATURES = {
    # q, r, m, n, tb, B, max_m, max_n, width,
    # match, mismatch, o1, o2, e1, e2, stream
    'pav_dp_full': ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P], _I),
    # q, r, m, n, doffs, tb, B, max_m, max_n, ww,
    # match, mismatch, o1, o2, e1, e2, stream
    'pav_dp_wave': ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P], _I),
    # q, r, m, n, score, tb, offs, scratch, B, max_m, max_n, width,
    # match, mismatch, o1, o2, e1, e2, stream
    'pav_dp_band': ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P], _I),
    # width -> ints of global scratch per item (0: state in shared memory)
    'pav_dp_band_scratch_ints': ([_I], _I),
    # tb, offs, q, r, m, n, out, B, rows, w_dim, max_m, max_n, L, wave, stream
    'pav_traceback': ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P], _I),
    # bytes (-1 reads) -> the previous largest item the walker stages whole
    'pav_traceback_whole_max': ([_I], _I),
    # qpos, rpos, group, f, parent, B, n, lookback, k,
    # max_dist, max_gap_diff, gap_scale, stream
    'pav_chain_scan': ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P], _I),
    # out (float[32]), iters, stream: the chain scan's dependency-chain probe
    'pav_chain_step_probe': ([_P, _I, _P], _I),
    # elements a tile of the seeding passes (csrc/seed.cu)
    'pav_seed_tile': ([], _I),
    # codes, n, k, w, tile_count, tile_off, pos, key, strand, emit, stream
    'pav_seed_sketch': ([_P, _L, _I, _I, _P, _P, _P, _P, _P, _I, _P], _I),
    # counts, offsets, n, stream
    'pav_seed_scan': ([_P, _P, _L, _P], _I),
    # keys, n, tile_count, tile_off, uniq_keys, uniq_starts, emit, stream
    'pav_seed_runs': ([_P, _L, _P, _P, _P, _P, _I, _P], _I),
    # qkey, nq, uniq_keys, uniq_starts, n_uniq, max_occ, count, start,
    # tile_count, stream
    'pav_seed_probe': ([_P, _L, _P, _P, _L, _L, _P, _P, _P, _P], _I),
    # qpos, qstrand, count, start, nq, tile_off, qlen, k, idx_chrom, idx_pos,
    # idx_strand, out_q, out_key, stream
    'pav_seed_fill': ([_P, _P, _P, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P, _P], _I),
    'pav_cuda_error_string': ([_I], ctypes.c_char_p),
}

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO = {}     # path, seconds, cached, log: filled by the first lib() call


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, '*.cu'))
                  + glob.glob(os.path.join(_SRC_DIR, '*.cuh')))


def _nvcc():
    found = shutil.which('nvcc')
    if not found:
        home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
        found = os.path.join(home, 'bin', 'nvcc')
    if not os.path.isfile(found):
        raise RuntimeError('nvcc not found (on PATH, $CUDA_HOME/bin or '
                           '/usr/local/cuda/bin): the CUDA kernels cannot be built')
    return found


def build(path, compile_step):
    """Build the library at ``path``: ``compile_step(out)`` writes it to
    ``out``, a temporary file beside ``path`` named by process and thread,
    which is renamed onto ``path`` when the step returns and removed when it
    raises. Returns what the step returns."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        result = compile_step(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return result


def library(build_dir, name, sources, flags, compile_step, signatures):
    """(handle, path, log) of the library ``name`` of ``sources`` built with
    ``flags`` under ``build_dir``, its file named by a hash of both: loaded
    from that file where it exists (``log`` None), else built through
    ``compile_step`` (``log`` what it returned) and loaded. Each entry of
    ``signatures`` (name -> (argtypes, restype)) is declared on the handle;
    a name the library lacks raises here."""
    h = hashlib.sha256(' '.join(flags).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as fh:
            h.update(fh.read())
    path = os.path.join(build_dir, f'{name}-{h.hexdigest()[:16]}.so')
    log = None if os.path.exists(path) else build(path, compile_step)
    handle = ctypes.CDLL(path)
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(handle, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle, path, log


def _compile(out):
    """Compile every ``.cu`` to an object with its own nvcc process (all at
    once), link them into ``out``; returns the compilers' output."""
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
    jobs = []
    for src in (p for p in _sources() if p.endswith('.cu')):
        obj = f'{out}.{os.path.basename(src)}.o'
        jobs.append((obj, subprocess.Popen(
            [nvcc, *compile_flags, '-c', '-o', obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ''
    failed = []
    for obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(obj)
    try:
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        link = subprocess.run([nvcc, '-shared', '-o', out, *(obj for obj, _ in jobs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({link.returncode}):\n{log}')
    finally:
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def lib():
    """The loaded kernel library, building it on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.time()
            handle, path, log = library(BUILD_DIR, 'libpav_torch_kernels', _sources(),
                                        NVCC_FLAGS, _compile, SIGNATURES)
            BUILD_INFO.update(path=path, seconds=time.time() - t0,
                              cached=log is None, log=log or '')
            _LIB = handle
        return _LIB


def check(code, name):
    """Raise when a C entry returned a CUDA error code."""
    if code != 0:
        msg = _LIB.pav_cuda_error_string(code).decode()
        raise RuntimeError(f'{name}: CUDA error {code} ({msg}) at launch')
