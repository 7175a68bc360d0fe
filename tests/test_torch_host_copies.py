"""The port's host modules are copies of pav_tpu's, line for line.

The port imports nothing of pav_tpu; it carries its own copy of every host
module it runs, at the same relative path. Each copy must equal its source
once import lines are normalised (``pav_tpu_torch`` read as ``pav_tpu``),
so a partial or edited copy fails here. ``vcf.py`` is the port's own (it
writes through the port's text codec, ``textcodec``). Three copies differ
on purpose:

* ``native.py`` builds into its own ``build/torch_native/`` through the
  port's one build routine, ``_build.build`` (its module docstring,
  ``_BUILD_DIR`` and ``_build``); every other line is the source's.
* ``runtime.py`` keeps only ``retain_heap`` and the ``mark_progress``
  heartbeat it calls, each equal to the source's definition.
* ``constants.py``'s docstring cites the upstream PAV file by its path in
  the PAV tree, without the local checkout directory of the source's.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    'seqcodec', 'kmer', 'regions', 'util', 'config',
    'assembly_table', 'tracks', 'plot',
    'io/__init__', 'io/fasta', 'io/sam', 'io/cram', 'io/bgzf', 'io/tabix',
    'io/bigbed',
    'align/cigar', 'align/table', 'align/trim', 'align/lift',
    'call/cigar_calls', 'call/homology', 'call/variant_id', 'call/inv_flag',
    'call/integrate', 'call/merge', 'call/redundancy', 'call/batching',
    'asmstat', 'eval',
]
# native.py: the top-level definitions that build the library (and the
# module docstring) are the port's own.
NATIVE_OWN = {'_BUILD_DIR', '_build'}
RUNTIME_KEPT = ['_PROGRESS', 'mark_progress', 'retain_heap']

_IMPORT = re.compile(r'^\s*(from|import)\s')


def _lines(pkg, mod):
    with open(os.path.join(REPO, pkg, mod + '.py')) as fh:
        return fh.read().splitlines()


def _normalised(lines):
    return [line.replace('pav_tpu_torch', 'pav_tpu') if _IMPORT.match(line) else line
            for line in lines]


def _top_level(lines):
    """{name: (first, last) 1-based lines} of the module docstring (as
    '__doc__') and each top-level def, class and assignment."""
    tree = ast.parse('\n'.join(lines))
    spans = {}
    for node in tree.body:
        first = min([node.lineno] + [d.lineno for d in getattr(node, 'decorator_list', [])])
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            spans[node.name] = (first, node.end_lineno)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            spans[node.targets[0].id] = (first, node.end_lineno)
        elif (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
              and node is tree.body[0]):
            spans['__doc__'] = (first, node.end_lineno)
    return spans


def _without(lines, spans, names):
    drop = set()
    for name in names:
        first, last = spans[name]
        drop.update(range(first, last + 1))
    return [line for no, line in enumerate(lines, start=1) if no not in drop]


@pytest.mark.parametrize('mod', COPIES)
def test_copy_equals_source(mod):
    want = _lines('pav_tpu', mod)
    got = _lines('pav_tpu_torch', mod)
    assert _normalised(got) == _normalised(want)


def test_constants_differs_only_in_its_docstring():
    want = _lines('pav_tpu', 'constants')
    got = _lines('pav_tpu_torch', 'constants')
    want_spans, got_spans = _top_level(want), _top_level(got)
    assert _without(got, got_spans, ['__doc__']) == _without(want, want_spans, ['__doc__'])
    doc = got[got_spans['__doc__'][0] - 1:got_spans['__doc__'][1]]
    assert any('(`pavlib/constants.py:6-9`)' in line for line in doc)


def test_native_differs_only_in_its_build():
    want = _lines('pav_tpu', 'native')
    got = _lines('pav_tpu_torch', 'native')
    own = NATIVE_OWN | {'__doc__'}
    want_spans, got_spans = _top_level(want), _top_level(got)
    assert set(want_spans) == set(got_spans)
    assert _without(got, got_spans, own) == _without(want, want_spans, own)
    build = '\n'.join(got[slice(got_spans['_build'][0] - 1, got_spans['_build'][1])])
    assert 'from ._build import build' in build and 'build(_SO_PATH,' in build
    assert 'os.replace(' not in build and '.tmp' not in build
    assert "'torch_native'" in '\n'.join(got)
    assert 'JAX implementations' not in '\n'.join(got)


def test_runtime_keeps_retain_heap_only():
    want = _lines('pav_tpu', 'runtime')
    got = _lines('pav_tpu_torch', 'runtime')
    want_spans, got_spans = _top_level(want), _top_level(got)
    assert sorted(set(got_spans) - {'__doc__'}) == sorted(RUNTIME_KEPT)
    for name in RUNTIME_KEPT:
        (a, b), (c, d) = got_spans[name], want_spans[name]
        assert got[a - 1:b] == want[c - 1:d], name


def test_every_pav_tpu_module_the_port_names_has_its_copy():
    """Each module whose name the port shares with pav_tpu is a copy listed
    above, one of the two exceptions, or a module the port re-homed."""
    rehomed = {'__init__', '__main__', 'pipeline', 'vcf', 'align/__init__', 'call/__init__',
               'call/density', 'call/inv', 'call/largesv'}
    shared = set()
    root = os.path.join(REPO, 'pav_tpu_torch')
    for dirpath, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)[:-3]
            if name.endswith('.py') and os.path.isfile(
                    os.path.join(REPO, 'pav_tpu', rel + '.py')):
                shared.add(rel)
    rehomed |= {m for m in shared if m.startswith(('ops/', 'parallel/', 'align/aligner/'))}
    assert shared - rehomed == set(COPIES) | {'constants', 'native', 'runtime'}
