"""The port's host text codec (``pav_tpu_torch.textcodec``) against the
Python path it replaces, byte for byte.

FASTA: ``read_fasta`` against ``io.fasta.read_fasta`` (the same records, or
the same exception), plain and gzipped, fed whole and a few bytes a block.
Tables: ``write_table`` against ``DataFrame.to_csv`` (decompressed bytes),
over the dtypes the stage tables hold and the floats where Python's repr
changes layout. VCF: ``write_vcf`` against ``vcf.py``'s Python writer (the
``.vcf.gz`` and ``.tbi`` bytes). A CLI sample on the CPU writes every file
the same with the codec and without it. The codec's calls leave the
interpreter lock to other threads. Needs ``g++`` (the library is built on
first use); without it only the Python path exists. Imports neither JAX
nor ``pav_tpu``: ``python -m pytest --noconftest tests/test_torch_textcodec.py``
runs it on the card's host as well.
"""

import gzip
import os
import shutil
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

from pav_tpu_torch import spans, textcodec, vcf
from pav_tpu_torch import __main__ as cli
from pav_tpu_torch.io import fasta
from pav_tpu_torch.io.tabix import TabixIndex



@pytest.fixture(scope='module', autouse=True)
def codec():
    if shutil.which('g++') is None:
        pytest.skip('no g++: the codec cannot be built')
    lib = textcodec.lib()
    assert lib is not None
    return lib


@pytest.fixture
def no_codec(monkeypatch):
    """The Python path alone, as where the library cannot be built."""
    monkeypatch.setitem(textcodec._STATE, 'lib', None)


# ------------------------------------------------------------------ FASTA

FASTA = {
    'plain': b'>chr1\nACGTACGTAC\nGTACGTAC\n>chr2\nTTTTGGGGCC\nCCAA\n',
    'crlf': b'>chr1 desc\r\nACGTACGT\r\nACG\r\n>chr2\r\nGGCC\r\n',
    'lone_cr': b'>a\rACGT\rAC\r>b\rTT\r',
    'lowercase': b'>chr1\nacgtnACGTn\nacgt\n',
    'n_and_iupac': b'>chr1\nNNNNACGTRYKMSWBDHVN\nnnryACGT-.*\n',
    'blank_lines': b'\n\n>chr1\n\nACGT\n   \n\t\nACGT\n\n>chr2\n\n\nGG\n\n',
    'line_widths': (b'>w1\n' + b'A\nC\nG\nT\n' + b'>w7\nACGTACG\nTTTTTTT\nGA\n'
                    + b'>w80\n' + b'ACGT' * 20 + b'\n' + b'CA' * 40 + b'\nT\n'
                    + b'>w1000\n' + b'GATC' * 250 + b'\n' + b'GATC' * 100 + b'\n'),
    'one_line': b'>r1\n' + b'ACGT' * 5000 + b'\n>r2\n' + b'TTGCA' * 3001 + b'\n>r3\nA',
    'header_words': b'  >chr1 Homo sapiens\tchromosome 1  \nACGT\n>\t chr2\x0bx\nGG\n',
    'inline_space': b'>chr1\n  ACG T\tA\x0cC  \t\nAC  \n\x1c\x1dGG\x1e\x1f \n',
    'empty_records': b'>e1\n>e2\n\n>e3\nACGT\n>e4',
    'odd_bytes': b'>x\nAC\x00GT>A\x7fC\n',
    'non_ascii': '>chr1 été\nACGT\n>chr2\nGG\n'.encode('utf-8'),
    'empty_file': b'',
}
FASTA_ERRORS = {
    'before_header': b'ACGT\n>chr1\nACGT\n',
    'duplicate': b'>a\nACGT\n>b\nGG\n>a\nTT\n',
    'duplicate_adjacent': b'>a x\nACGT\n>a y\n',
    'no_name': b'>chr1\nACGT\n>  \nGG\n',
}


def _on(fn, *args):
    """fn's result, and the ``on`` count of the span it recorded."""
    rec = spans.Recorder()
    with rec.active():
        out = fn(*args)
    (span,) = rec.records
    return out, span.counts['on']


def _write(tmp_path, data, gz):
    path = tmp_path / ('in.fa.gz' if gz else 'in.fa')
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


@pytest.mark.parametrize('block', [None, 5])
@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
@pytest.mark.parametrize('case', sorted(FASTA))
def test_fasta_equals_the_python_reader(tmp_path, monkeypatch, case, gz, block):
    if block:
        monkeypatch.setattr(textcodec, 'BLOCK', block)
    path = _write(tmp_path, FASTA[case], gz)
    want = fasta.read_fasta(path)
    got, on = _on(textcodec.read_fasta, path)
    assert on == ('python' if case == 'non_ascii' else 'native')
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.uint8
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
@pytest.mark.parametrize('case', sorted(FASTA_ERRORS))
def test_fasta_raises_as_the_python_reader(tmp_path, case, gz):
    path = _write(tmp_path, FASTA_ERRORS[case], gz)
    with pytest.raises(Exception) as want:
        fasta.read_fasta(path)
    with pytest.raises(type(want.value)) as got:
        textcodec.read_fasta(path)
    assert str(got.value) == str(want.value)


def test_fasta_falls_back_without_the_library(tmp_path, no_codec):
    path = _write(tmp_path, FASTA['line_widths'], True)
    got, on = _on(textcodec.read_fasta, path)
    assert on == 'python'
    want = fasta.read_fasta(path)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_fasta_errors_are_the_named_ones(tmp_path):
    with pytest.raises(ValueError, match='before first header'):
        textcodec.read_fasta(_write(tmp_path, FASTA_ERRORS['before_header'], False))
    with pytest.raises(ValueError, match='Duplicate FASTA record name: a'):
        textcodec.read_fasta(_write(tmp_path, FASTA_ERRORS['duplicate'], False))


def test_read_seq_file_dispatches_as_io_fasta(tmp_path):
    fq = tmp_path / 'r.fq'
    fq.write_text('@q1\nACGT\n+\nIIII\n')
    got = textcodec.read_seq_file(str(fq))
    np.testing.assert_array_equal(got['q1'], fasta.read_seq_file(str(fq))['q1'])
    with pytest.raises(ValueError, match='Unrecognized'):
        textcodec.read_seq_file(str(tmp_path / 'x.txt'))


@pytest.mark.parametrize('block', [1, 7, 1000, textcodec.BLOCK])
def test_md5_of_codes_equals_the_decoded_string(monkeypatch, block):
    import hashlib

    from pav_tpu_torch import seqcodec
    monkeypatch.setattr(textcodec, 'BLOCK', block)
    codes = np.random.default_rng(3).integers(0, 9, 1000).astype(np.uint8)
    want = hashlib.md5(seqcodec.decode(codes).encode()).hexdigest()
    assert textcodec.md5_of_codes(codes) == want
    assert textcodec.md5_of_codes(codes[:0]) == hashlib.md5(b'').hexdigest()


# ------------------------------------------------------------------ tables

def _to_csv_bytes(df):
    return df.to_csv(sep='\t', index=False).encode('utf-8')


def _codec_bytes(df, path, on='native'):
    assert _on(textcodec.write_table, df, str(path), 'test')[1] == on
    with gzip.open(path, 'rb') as fh:
        return fh.read()


SWITCH_FLOATS = [1e-5, 1e-4, 0.00012345, 1e15, 9999999999999998.0, 1e16, 1.5e16, 1e22,
                 -0.0, 0.0, np.nan, np.inf, -np.inf, 0.1 + 0.2, 123.0, 5e-324,
                 1.7976931348623157e308, -2.5e-7, 1 / 3]


def _stage_like_table(n=400):
    rng = np.random.default_rng(11)
    floats = rng.standard_normal(n) * 10.0 ** rng.integers(-25, 25, n)
    floats[:len(SWITCH_FLOATS)] = SWITCH_FLOATS
    floats[::7] = np.nan
    words = ['', 'PASS', 'a\tb', 'say "x"', 'line\nbreak', 'cr\rx', 'h1,h2', 'café', None]
    strs = [words[i % len(words)] for i in range(n)]
    mixed = [[1, 'x', None, 2.5, np.nan, True, np.float32(0.1), np.int64(7), pd.NA][i % 9]
             for i in range(n)]
    with np.errstate(over='ignore'):  # beyond float32's or float16's range: inf
        floats32 = floats.astype(np.float32)
        floats16 = floats32.astype(np.float16)
    return pd.DataFrame({
        '#CHROM': pd.array([f'chr{i % 3}' for i in range(n)], dtype='str'),
        'POS': rng.integers(0, 2 ** 40, n),
        'NEG': rng.integers(-2 ** 62, 2 ** 62, n),
        'SMALL': rng.integers(0, 200, n).astype(np.uint8),
        'I32': rng.integers(-1000, 1000, n).astype(np.int32),
        'U64': rng.integers(0, 2 ** 62, n).astype(np.uint64) * 3,
        'COV': floats,
        'F32': floats32,
        'F16': floats16,
        'REV': rng.integers(0, 2, n).astype(bool),
        'ARROW': pd.array(strs, dtype='str'),
        'OBJ': np.array(strs, dtype=object),
        'MIXED': np.array(mixed, dtype=object),
        'OBJ_BOOL': np.array([[True, False, None][i % 3] for i in range(n)], dtype=object),
        'OBJ_INT': np.array([int(v) for v in rng.integers(-10 ** 12, 10 ** 12, n)], dtype=object),
        'OBJ_BIG': np.array([2 ** 64 + i for i in range(n)], dtype=object),
        'SPR': pd.array(strs, dtype='string[pyarrow]'),
        'SPY': pd.array(strs, dtype='string[python]'),
    })


TABLE = _stage_like_table()


@pytest.mark.parametrize('col', ['all'] + list(TABLE.columns))
def test_table_equals_to_csv(tmp_path, col):
    df = TABLE if col == 'all' else TABLE[[col]]
    assert _codec_bytes(df, tmp_path / 't.tsv.gz') == _to_csv_bytes(df)


def test_doubles_equal_to_csv_over_bit_patterns(tmp_path):
    """Doubles drawn over every sign, exponent and mantissa (subnormals,
    both sides of 1e-4 and 1e16, NaN and inf among them) and decimals."""
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2 ** 63, 200000, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, 200000, dtype=np.uint64)
    edges = [np.nextafter(v, d) for v in (1e-4, 1e16) for d in (0.0, np.inf)]
    values = np.concatenate([bits.view(np.float64), edges,
                             rng.integers(1, 10 ** 6, 50000) / 10.0 ** rng.integers(0, 12, 50000)])
    df = pd.DataFrame({'F': values})
    assert _codec_bytes(df, tmp_path / 't.tsv.gz') == _to_csv_bytes(df)


@pytest.mark.parametrize('shape', ['header_only', 'no_columns', 'one_empty_field',
                                   'sliced', 'arrow_slice', 'single_row', 'empty_name'])
def test_table_edges_equal_to_csv(tmp_path, shape):
    df = {
        'header_only': TABLE.iloc[:0],
        'no_columns': pd.DataFrame(),
        'one_empty_field': pd.DataFrame({'A': ['', None, 'x', np.nan]}),
        'sliced': TABLE.iloc[3:300:7],
        'arrow_slice': pd.DataFrame({'S': TABLE['ARROW'].array[5:50]}),
        'single_row': TABLE.iloc[[9]],
        'empty_name': pd.DataFrame({'': [1, 2]}),
    }[shape]
    on = 'python' if shape == 'no_columns' else 'native'
    assert _codec_bytes(df, tmp_path / 't.tsv.gz', on) == _to_csv_bytes(df)


def test_table_crosses_blocks(tmp_path, monkeypatch):
    monkeypatch.setattr(textcodec, 'BLOCK', 64)
    assert _codec_bytes(TABLE, tmp_path / 't.tsv.gz') == _to_csv_bytes(TABLE)


def test_table_falls_back_without_the_library(tmp_path, no_codec):
    assert _codec_bytes(TABLE, tmp_path / 't.tsv.gz', 'python') == _to_csv_bytes(TABLE)


def test_table_of_a_type_the_codec_does_not_format(tmp_path):
    df = pd.DataFrame({'CAT': pd.Categorical(['a', 'b', 'a']),
                       'I64': pd.array([1, None, 3], dtype='Int64')})
    assert _codec_bytes(df, tmp_path / 't.tsv.gz', 'python') == _to_csv_bytes(df)


def test_table_emission_leaves_the_lock(codec):
    """While the codec formats a large table (one call), a Python thread
    that only counts keeps its pace. The switch interval is longer than
    the call, so a call that held the lock would let it count nothing."""
    import ctypes

    n = 300000
    rng = np.random.default_rng(5)
    df = pd.DataFrame({'A': rng.integers(0, 10 ** 9, n), 'B': rng.standard_normal(n),
                       'C': pd.array(['x' * (i % 40) for i in range(n)], dtype='str')})
    h, cols = textcodec._table(codec, df, vcf=False)
    count = [0]
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            count[0] += 1

    old = sys.getswitchinterval()
    thread = threading.Thread(target=spin)
    text, length = ctypes.c_void_p(), ctypes.c_int64()
    try:
        thread.start()
        c0 = count[0]
        time.sleep(0.1)
        alone = (count[0] - c0) / 0.1
        sys.setswitchinterval(1.0)
        c0, t0 = count[0], time.perf_counter()
        done = codec.pav_tab_next(h, 1 << 40, ctypes.byref(text), ctypes.byref(length))
        c1, t1 = count[0], time.perf_counter()
    finally:
        sys.setswitchinterval(old)
        stop.set()
        thread.join(timeout=30)
        codec.pav_tab_free(h)
    assert not thread.is_alive()
    assert done == n and length.value > 10 * n
    assert c1 - c0 > 0.25 * alone * (t1 - t0), (c1 - c0, alone, t1 - t0)


# ------------------------------------------------------------------ VCF

def _vcf_frame(n, seed=2):
    rng = np.random.default_rng(seed)
    chrom = np.sort(rng.choice(['chr1', 'chr10', 'chrX'], n))
    lens = rng.choice([1, 1, 1, 2, 5, 300], n)
    lens[::997] = 70000  # REF spanning more than one linear-index window
    refs = [''.join('ACGT'[j % 4] for j in range(k)) for k in lens]
    df = pd.DataFrame({
        '#CHROM': pd.array(chrom, dtype='str'), 'POS': rng.integers(1, 3 * 10 ** 7, n),
        'ID': np.array([f'v{i}' for i in range(n)], dtype=object),
        'REF': pd.array(refs, dtype='str'), 'ALT': 'A', 'QUAL': '.', 'FILTER': 'PASS',
        'INFO': pd.array([f'ID=v{i};SVTYPE=SNV;HAP=h1,h2' for i in range(n)], dtype='str'),
        'FORMAT': 'GT', 'S1': np.array(['1|.'] * n, dtype=object)})
    return df.sort_values(['#CHROM', 'POS'])


@pytest.mark.parametrize('n', [0, 1, 5000])
def test_vcf_and_index_equal_the_python_writer(tmp_path, n):
    df = _vcf_frame(n)
    header = '##fileformat=VCFv4.2\n' + '\t'.join(df.columns) + '\n'
    got, want = str(tmp_path / 'a.vcf.gz'), str(tmp_path / 'b.vcf.gz')
    assert textcodec.write_vcf(header, df, got, got + '.tbi')
    vcf._write_vcf_python(header, df, want, want + '.tbi')
    for ext in ('', '.tbi'):
        with open(got + ext, 'rb') as a, open(want + ext, 'rb') as b:
            assert a.read() == b.read(), ext
    if n:
        row = df.iloc[n // 2]
        hits = list(TabixIndex(got + '.tbi').query(got, row['#CHROM'], row['POS'] - 1,
                                                   row['POS']))
        assert any(line.split('\t')[2] == row['ID'] for line in hits)


def test_vcf_of_object_columns_equals_the_python_writer(tmp_path):
    """Columns of Python objects are written as ``astype(str)`` gives them
    (ints in POS and among strings, floats); a missing value is left to
    the Python writer."""
    df = _vcf_frame(300)
    df['POS'] = np.array([int(p) for p in df['POS']], dtype=object)
    df['QUAL'] = np.array([['.', 7, 2.5][i % 3] for i in range(300)], dtype=object)
    df['FILTER'] = np.linspace(0, 1e-4, 300)
    df['S1'] = df['S1'].astype('str')
    header = '#' + '\t'.join(df.columns) + '\n'
    got, want = str(tmp_path / 'a.vcf.gz'), str(tmp_path / 'b.vcf.gz')
    assert textcodec.write_vcf(header, df, got, got + '.tbi')
    vcf._write_vcf_python(header, df, want, want + '.tbi')
    for ext in ('', '.tbi'):
        with open(got + ext, 'rb') as a, open(want + ext, 'rb') as b:
            assert a.read() == b.read(), ext
    df.iloc[5, df.columns.get_loc('QUAL')] = None
    assert not textcodec.write_vcf(header, df, got, got + '.tbi')


def test_vcf_record_at_position_zero_goes_to_the_python_writer(tmp_path):
    df = _vcf_frame(50)
    df.iloc[0, df.columns.get_loc('POS')] = 0
    header = '#' + '\t'.join(df.columns) + '\n'
    path = str(tmp_path / 'a.vcf.gz')
    assert not textcodec.write_vcf(header, df, path, path + '.tbi')


# ------------------------------------------------------------ a CLI sample

def _two_hap_sample(d):
    """``tests/helpers.write_two_hap_sample`` (h2 cut in two) through the
    port's own generator: ref.fa, h1.fa, h2.fa, asm.tsv; the CLI's args."""
    from pav_tpu_torch import seqcodec, synth

    rng = np.random.default_rng(7)
    ref = synth.random_seq(200000, rng)
    m1 = synth.Mutator(ref)
    m1.snv(5000, rng=rng)
    m1.dele(50000, 300)
    m1.snv(120000, rng=rng)
    m2 = synth.Mutator(ref)
    m2.snv(30000, rng=rng)
    m2.ins(90000, synth.random_seq(25, rng))
    h1, h2 = m1.finish(), m2.finish()
    fasta.write_fasta({'chr1': seqcodec.decode(ref)}, str(d / 'ref.fa'))
    fasta.write_fasta({'tig1': seqcodec.decode(h1)}, str(d / 'h1.fa'))
    fasta.write_fasta({'tig2a': seqcodec.decode(h2[:100000]),
                       'tig2b': seqcodec.decode(h2[100000:])}, str(d / 'h2.fa'))
    (d / 'asm.tsv').write_text(f'NAME\tHAP_h1\tHAP_h2\nS1\t{d / "h1.fa"}\t{d / "h2.fa"}\n')
    return ['--ref', str(d / 'ref.fa'), '--assemblies', str(d / 'asm.tsv'), '--device', 'cpu']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The 200 kb sample through the CLI on the CPU, with the codec and
    without it; {path relative to the run dir: bytes} of each."""
    d = tmp_path_factory.mktemp('codec')
    base = _two_hap_sample(d)
    out = {}
    for side in ('native', 'python'):
        with pytest.MonkeyPatch.context() as mp:
            if side == 'python':
                mp.setitem(textcodec._STATE, 'lib', None)
            assert cli.main(base + ['--run-dir', str(d / side)]) == 0
        files = {}
        for root, _, names in os.walk(d / side):
            for name in names:
                if name in ('timings.tsv', 'spans.tsv'):
                    continue
                path = os.path.join(root, name)
                with open(path, 'rb') as fh:
                    files[os.path.relpath(path, d / side)] = fh.read()
        out[side] = files
    return out


def test_sample_writes_the_same_files_either_way(runs):
    assert set(runs['native']) == set(runs['python'])
    tables = [p for p in runs['native'] if p.endswith('.tsv.gz')]
    assert len(tables) >= 30
    for rel in tables:
        assert (gzip.decompress(runs['native'][rel])
                == gzip.decompress(runs['python'][rel])), rel


@pytest.mark.parametrize('ext', ['.vcf.gz', '.vcf.gz.tbi'])
def test_sample_vcf_bytes_equal_either_way(runs, ext):
    assert runs['native']['S1' + ext] == runs['python']['S1' + ext]
