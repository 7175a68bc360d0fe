"""The port's one build-and-load routine (``pav_tpu_torch._build``).

Each case compiles a tiny C++ source with g++ into ``tmp_path`` through
``_build.library`` (or through a caller of it: the kernel library, the text
codec and the native runtime) and holds: a cached file is loaded without
compiling; a new source or flag names a new file; processes and threads
building one library at once each get a working handle and leave one file;
a failed compile leaves nothing; a ``SIGNATURES`` table applies at load;
the text codec turns a failed build into ``None``; and no library is
written outside the checkout's build directory.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from pav_tpu_torch import _build, native, textcodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ['-O1', '-shared', '-fPIC']
SOURCE = ('extern "C" int twice(int x) { return 2 * x; }\n'
          'extern "C" double half(double x) { return x / 2; }\n')
SIGNATURES = {'twice': ([ctypes.c_int], ctypes.c_int),
              'half': ([ctypes.c_double], ctypes.c_double)}


@pytest.fixture
def gxx():
    if shutil.which('g++') is None:
        pytest.skip('no g++ on this host')


def _source(tmp_path, text=SOURCE, name='tiny.cpp'):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


class _Compiler:
    """A compile step for ``_build.library`` that counts its calls."""

    def __init__(self, src, flags=FLAGS):
        self.src, self.flags, self.calls = src, flags, 0

    def __call__(self, out):
        self.calls += 1
        subprocess.run(['g++', *self.flags, self.src, '-o', out], check=True,
                       capture_output=True)
        return 'built'


def _files(build_dir):
    return sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []


def test_second_load_is_served_from_cache(gxx, tmp_path):
    src = _source(tmp_path)
    build_dir = str(tmp_path / 'build')
    compile_step = _Compiler(src)
    handle, path, log = _build.library(build_dir, 'libtiny', [src], FLAGS, compile_step,
                                       SIGNATURES)
    assert log == 'built' and handle.twice(21) == 42
    again, path2, log2 = _build.library(build_dir, 'libtiny', [src], FLAGS, compile_step,
                                        SIGNATURES)
    assert compile_step.calls == 1
    assert path2 == path and log2 is None and again.twice(4) == 8
    assert _files(build_dir) == [os.path.basename(path)]


@pytest.mark.parametrize('change', ['source', 'flag'])
def test_a_new_source_or_flag_names_a_new_file(gxx, tmp_path, change):
    src = _source(tmp_path)
    build_dir = str(tmp_path / 'build')
    _, first, _ = _build.library(build_dir, 'libtiny', [src], FLAGS, _Compiler(src),
                                 SIGNATURES)
    flags = FLAGS
    if change == 'source':
        _source(tmp_path, SOURCE.replace('2 * x', 'x + x'))
    else:
        flags = ['-O2', '-shared', '-fPIC']
    compile_step = _Compiler(src, flags)
    handle, second, log = _build.library(build_dir, 'libtiny', [src], flags, compile_step,
                                         SIGNATURES)
    assert second != first and compile_step.calls == 1 and log == 'built'
    assert handle.twice(5) == 10
    assert _files(build_dir) == sorted(os.path.basename(p) for p in (first, second))


# Eight threads in each of two processes load one unbuilt library at once:
# each process waits for the file ``go`` before it starts its threads.
_RACE = textwrap.dedent('''
    import ctypes, json, os, subprocess, sys, threading, time
    sys.path.insert(0, sys.argv[1])
    from pav_tpu_torch import _build
    src, build_dir, go, ready = sys.argv[2:6]
    flags = ['-O1', '-shared', '-fPIC']
    sigs = {'twice': ([ctypes.c_int], ctypes.c_int)}
    results = []

    def work(i):
        handle, path, _ = _build.library(
            build_dir, 'librace', [src], flags,
            lambda out: subprocess.run(['g++', *flags, src, '-o', out], check=True),
            sigs)
        results.append((handle.twice(i), os.path.basename(path)))
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    open(ready, 'w').close()
    deadline = time.time() + 60
    while not os.path.exists(go) and time.time() < deadline:
        time.sleep(0.005)
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    print(json.dumps(sorted(results)))
''')


def test_processes_and_threads_building_at_once_share_one_file(gxx, tmp_path):
    src = _source(tmp_path)
    build_dir = tmp_path / 'build'
    go = tmp_path / 'go'
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RACE, REPO, src, str(build_dir), str(go),
         str(tmp_path / f'ready{k}')], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k in range(2)]
    try:
        deadline = time.time() + 120
        while not all((tmp_path / f'ready{k}').exists() or proc.poll() is not None
                      for k, proc in enumerate(procs)):
            assert time.time() < deadline, 'a builder process did not start'
            time.sleep(0.01)
        go.touch()
        outs = [proc.communicate(timeout=180) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        results.append(json.loads(out))
        assert [r[0] for r in results[-1]] == [2 * i for i in range(8)]
    (name,) = _files(build_dir)
    assert name.startswith('librace-') and name.endswith('.so')
    assert {r[1] for rows in results for r in rows} == {name}


def _half_written(out):
    with open(out, 'wb') as fh:
        fh.write(b'\x7fELF')
    raise RuntimeError('the linker died')


@pytest.mark.parametrize('failure', ['syntax', 'half_written'])
def test_a_failed_compile_raises_and_leaves_nothing(gxx, tmp_path, failure):
    """A compile step that fails, before or after it wrote some of its
    output, raises; no library and no temporary file is left."""
    src = _source(tmp_path, 'extern "C" int twice(int x) { return 2 * x }\n')
    build_dir = str(tmp_path / 'build')
    compile_step = _Compiler(src) if failure == 'syntax' else _half_written
    error = subprocess.CalledProcessError if failure == 'syntax' else RuntimeError
    with pytest.raises(error):
        _build.library(build_dir, 'libtiny', [src], FLAGS, compile_step, SIGNATURES)
    assert _files(build_dir) == []


def test_signatures_apply_at_load(gxx, tmp_path):
    """A missing symbol fails at load, not at the first call; the declared
    argtypes and restype are those of the handle's functions."""
    src = _source(tmp_path)
    build_dir = str(tmp_path / 'build')
    with pytest.raises(AttributeError, match='thrice'):
        _build.library(build_dir, 'libtiny', [src], FLAGS, _Compiler(src),
                       {**SIGNATURES, 'thrice': ([ctypes.c_int], ctypes.c_int)})
    handle, _, log = _build.library(build_dir, 'libtiny', [src], FLAGS, _Compiler(src),
                                    SIGNATURES)
    assert log is None
    assert handle.half.argtypes == [ctypes.c_double] and handle.half.restype is ctypes.c_double
    assert handle.half(5) == 2.5
    with pytest.raises(ctypes.ArgumentError):
        handle.twice('x')


def test_textcodec_lib_is_none_when_its_compile_fails(gxx, tmp_path, monkeypatch):
    monkeypatch.setattr(textcodec, '_SRC', _source(tmp_path, 'not C++\n', 'broken.cpp'))
    monkeypatch.setattr(textcodec, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(textcodec, '_STATE', {})
    assert textcodec.lib() is None
    assert _files(tmp_path / 'build') == []


@pytest.mark.parametrize('which', ['kernels', 'textcodec', 'native'])
def test_an_unwritable_build_dir_builds_nowhere_else(gxx, tmp_path, monkeypatch, which):
    """The policy for a tree that cannot be written: no library falls back
    to a per-user cache. The kernel library raises, the text codec returns
    None and the native runtime None (its callers' fallbacks then run), no
    compiler starts and nothing is written under HOME."""
    blocked = tmp_path / 'tree'
    blocked.write_text('a file where the build directory would be')
    home = tmp_path / 'home'
    home.mkdir()
    monkeypatch.setenv('HOME', str(home))

    def no_compile(*a, **k):
        raise AssertionError('a compiler started')
    monkeypatch.setattr(subprocess, 'run', no_compile)
    monkeypatch.setattr(subprocess, 'Popen', no_compile)
    if which == 'kernels':
        monkeypatch.setattr(_build, '_LIB', None)
        monkeypatch.setattr(_build, 'BUILD_DIR', str(blocked / 'torch_kernels'))
        with pytest.raises(OSError):
            _build.lib()
    elif which == 'textcodec':
        monkeypatch.setattr(textcodec, 'BUILD_DIR', str(blocked / 'torch_text'))
        monkeypatch.setattr(textcodec, '_STATE', {})
        assert textcodec.lib() is None
    else:
        monkeypatch.setattr(native, '_LIB', None)
        monkeypatch.setattr(native, '_TRIED', False)
        monkeypatch.setattr(native, '_BUILD_DIR', str(blocked / 'torch_native'))
        monkeypatch.setattr(native, '_SO_PATH', str(blocked / 'torch_native' / 'lib.so'))
        assert native.get_lib() is None
        assert native._SO_PATH == str(blocked / 'torch_native' / 'lib.so')
    assert list(home.rglob('*')) == []
