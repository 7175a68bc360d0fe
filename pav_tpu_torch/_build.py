"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

All ``csrc/*.cu`` files compile with nvcc into one shared library with a plain
C interface, at first use, into ``build/torch_kernels/`` beside the package:
one nvcc per source, all started together, then one link. The file name
carries a hash of the sources and flags, so an edited source builds anew and
an unchanged one loads the cached library. Every C entry
takes its pointers and the CUDA stream as ``void*``, launches on that
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
_F = ctypes.c_float
# C entry points: name -> (argtypes, restype); every pointer and the stream
# pass as void*, every launcher returns cudaGetLastError().
SIGNATURES = {
    # q, r, m, n, tb, scratch, B, max_m, max_n, width,
    # match, mismatch, o1, o2, e1, e2, stream
    'pav_dp_full': ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P], _I),
    # width -> ints of global scratch per item (0: state in shared memory)
    'pav_dp_full_scratch_ints': ([_I], _I),
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


def _source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(nvcc, so_path):
    """Compile every ``.cu`` to an object with its own nvcc process (all at
    once), link them into ``so_path``; returns the compilers' output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f'{so_path}.{os.getpid()}'
    compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
    jobs = []
    for src in (p for p in _sources() if p.endswith('.cu')):
        obj = f'{stem}.{os.path.basename(src)}.o'
        jobs.append((obj, subprocess.Popen(
            [nvcc, *compile_flags, '-c', '-o', obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ''
    failed = []
    for obj, proc in jobs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            failed.append(obj)
    try:
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        link = subprocess.run([nvcc, '-shared', '-o', f'{stem}.tmp',
                               *(obj for obj, _ in jobs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({link.returncode}):\n{log}')
        os.replace(f'{stem}.tmp', so_path)
    finally:
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def lib():
    """The loaded kernel library, building it on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so_path = os.path.join(BUILD_DIR, f'libpav_torch_kernels-{_source_hash()}.so')
        t0 = time.time()
        cached = os.path.exists(so_path)
        log = ''
        if not cached:
            log = _compile(_nvcc(), so_path)
        handle = ctypes.CDLL(so_path)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        BUILD_INFO.update(path=so_path, seconds=time.time() - t0,
                          cached=cached, log=log)
        _LIB = handle
        return _LIB


def check(code, name):
    """Raise when a C entry returned a CUDA error code."""
    if code != 0:
        msg = _LIB.pav_cuda_error_string(code).decode()
        raise RuntimeError(f'{name}: CUDA error {code} ({msg}) at launch')
