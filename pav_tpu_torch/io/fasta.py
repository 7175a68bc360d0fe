"""FASTA/FASTQ/GFA ingest and FASTA emit, self-contained (no pysam/BioPython).

Sequences are parsed straight into uint8 code arrays (pav_tpu.seqcodec) and held
in a SeqStore — the in-memory substitute for the reference's indexed-FASTA access
pattern (pavlib/seq.py:328-360). Readers accept plain or gzip text transparently
(reference: svpoplib PlainOrGzReader semantics, SURVEY.md §2.9).
"""

import gzip
import io
import os

import numpy as np

from .. import seqcodec


def _open_text(path):
    """Open a text file, transparently decompressing gzip (by magic bytes)."""
    f = open(path, 'rb')
    magic = f.read(2)
    f.seek(0)
    if magic == b'\x1f\x8b':
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return io.TextIOWrapper(f)


def read_fasta(path_or_handle):
    """Parse FASTA into an ordered dict {name: uint8 code array}."""
    close = False
    if isinstance(path_or_handle, (str, os.PathLike)):
        fh = _open_text(path_or_handle)
        close = True
    else:
        fh = path_or_handle

    seqs = {}
    name = None
    chunks = []
    try:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith('>'):
                if name is not None:
                    seqs[name] = seqcodec.encode(''.join(chunks))
                name = line[1:].split()[0]
                if name in seqs:
                    raise ValueError(f'Duplicate FASTA record name: {name}')
                chunks = []
            else:
                if name is None:
                    raise ValueError('FASTA content before first header')
                chunks.append(line)
        if name is not None:
            seqs[name] = seqcodec.encode(''.join(chunks))
    finally:
        if close:
            fh.close()
    return seqs


def read_fastq(path):
    """Parse FASTQ into {name: code array} (quality discarded; assembly input only)."""
    seqs = {}
    with _open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            header = header.strip()
            if not header:
                continue
            if not header.startswith('@'):
                raise ValueError(f'Bad FASTQ header: {header[:50]}')
            name = header[1:].split()[0]
            seq = fh.readline().strip()
            plus = fh.readline()
            qual = fh.readline()
            if not plus.startswith('+') or not qual:
                raise ValueError(f'Truncated FASTQ record: {name}')
            if name in seqs:
                raise ValueError(f'Duplicate FASTQ record name: {name}')
            seqs[name] = seqcodec.encode(seq)
    return seqs


def read_gfa(path):
    """Parse GFA S-lines into {name: code array} (reference ingests GFA segments:
    pavlib/pipeline.py:375-401)."""
    seqs = {}
    with _open_text(path) as fh:
        for line in fh:
            if not line.startswith('S\t'):
                continue
            tok = line.rstrip('\n').split('\t')
            if len(tok) < 3:
                raise ValueError(f'Bad GFA S-line: {line[:80]}')
            name, seq = tok[1], tok[2]
            if seq == '*':
                continue
            if name in seqs:
                raise ValueError(f'Duplicate GFA segment name: {name}')
            seqs[name] = seqcodec.encode(seq)
    return seqs


def read_seq_file(path):
    """Dispatch on extension: FASTA (.fa/.fasta/.fna), FASTQ (.fq/.fastq), GFA (.gfa),
    each optionally .gz (reference input grammar: pavlib/pipeline.py:215-329)."""
    base = str(path)
    if base.endswith('.gz'):
        base = base[:-3]
    low = base.lower()
    if low.endswith(('.fa', '.fasta', '.fna')):
        return read_fasta(path)
    if low.endswith(('.fq', '.fastq')):
        return read_fastq(path)
    if low.endswith('.gfa'):
        return read_gfa(path)
    raise ValueError(f'Unrecognized sequence file type: {path}')


def write_fasta(seqs, path, width=70):
    """Write {name: code array or str} to a FASTA file (gzip if path ends with .gz)."""
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'wt') as fh:
        for name, seq in seqs.items():
            if not isinstance(seq, str):
                seq = seqcodec.decode(seq)
            fh.write(f'>{name}\n')
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width])
                fh.write('\n')


def write_fai(seqs, path):
    """Write a synthetic .fai-style index (name, length) for interop/debugging."""
    with open(path, 'wt') as fh:
        offset = 0
        for name, seq in seqs.items():
            n = len(seq)
            fh.write(f'{name}\t{n}\t{offset}\t{n}\t{n + 1}\n')
            offset += n + len(name) + 3


class SeqStore:
    """In-memory sequence store: {name: uint8 code array} plus length index.

    Replaces indexed-FASTA random access (pysam.FastaFile in the reference) with
    O(1) in-memory slicing; the upstream artifact layer decides what is resident.
    """

    def __init__(self, seqs=None):
        self.seqs = dict(seqs) if seqs else {}

    @classmethod
    def from_file(cls, path):
        return cls(read_seq_file(path))

    def __contains__(self, name):
        return name in self.seqs

    def __iter__(self):
        return iter(self.seqs)

    def names(self):
        return list(self.seqs.keys())

    def get(self, name):
        return self.seqs[name]

    def add(self, name, codes):
        if name in self.seqs:
            raise ValueError(f'Duplicate sequence name: {name}')
        self.seqs[name] = np.asarray(codes, dtype=np.uint8)

    def length(self, name):
        return len(self.seqs[name])

    def fai(self):
        """{name: length} mapping (stands in for FAI Series)."""
        return {name: len(seq) for name, seq in self.seqs.items()}

    def fetch_codes(self, name, pos=None, end=None, rev_compl=False):
        seq = self.seqs[name]
        if pos is not None or end is not None:
            seq = seq[(pos or 0):end]
        if rev_compl:
            return seqcodec.revcomp(seq)
        return seq

    def fetch_region(self, region, rev_compl=None):
        """Fetch a Region's sequence; rev_compl=None follows region.is_rev
        (reference: pavlib/seq.py:328-360)."""
        if rev_compl is None:
            rev_compl = region.is_rev
        return self.fetch_codes(region.chrom, region.pos, region.end, rev_compl=rev_compl)

    def total_bp(self):
        return sum(len(s) for s in self.seqs.values())

    def n_gap_table(self):
        """BED-like table of ambiguous-base (N) runs per sequence
        (reference: rules/data.snakefile:40-71)."""
        rows = []
        for name, seq in self.seqs.items():
            ambig = (seq >= 4).astype(np.int8)
            if not ambig.any():
                continue
            d = np.diff(np.concatenate([[0], ambig, [0]]))
            starts = np.nonzero(d == 1)[0]
            ends = np.nonzero(d == -1)[0]
            for s, e in zip(starts, ends):
                rows.append((name, int(s), int(e)))
        import pandas as pd
        return pd.DataFrame(rows, columns=['#CHROM', 'POS', 'END'])
