"""Assembly input table parsing.

Mirrors the reference grammar (pavlib/pipeline.py:511-650): a NAME column, any
number of haplotype columns (HAP_<name> or HAP<number> -> "h<number>"), optional
per-haplotype FILTER_* columns, and an optional CONFIG column of per-assembly
overrides. Empty cells mean missing haplotypes (reference empty-file convention:
pavlib/pipeline.py:336-365).
"""

import collections
import os
import re

import numpy as np
import pandas as pd

from .config import parse_config_override_string

_NAME_RE = re.compile(r'^[a-zA-Z0-9_-]+$')
_HAP_NAMED_RE = re.compile(r'^HAP_([a-zA-Z0-9-+.]+)$')
_HAP_NUM_RE = re.compile(r'^HAP([0-9]+)$')
_FILTER_RE = re.compile(r'^FILTER_([a-zA-Z0-9-+.]+)$')


def read_assembly_table(path, ignore_cols=()):
    """Read a TSV/CSV assembly table into a normalized DataFrame indexed by NAME,
    with columns HAP_<hap>, FILTER_<hap>, CONFIG."""
    if path is None or not os.path.isfile(str(path).strip()):
        raise FileNotFoundError(f'Assembly table file missing: {path}')

    path = str(path).strip()
    low = path.lower()
    if low.endswith(('.tsv', '.tsv.gz', '.tsv.txt', '.tsv.txt.gz')):
        df = pd.read_csv(path, sep='\t', header=0, dtype=str)
    elif low.endswith(('.csv', '.csv.gz', '.csv.txt', '.csv.txt.gz')):
        df = pd.read_csv(path, header=0, dtype=str)
    elif low.endswith('.xlsx'):
        df = pd.read_excel(path, header=0, dtype=str)
    else:
        raise ValueError(f'Unrecognized table file type: {path}')

    if 'NAME' not in df.columns:
        raise ValueError('Missing assembly table column: NAME')
    if df['NAME'].isnull().any():
        raise ValueError('Assembly table contains empty NAME values')

    bad = [name for name in df['NAME'] if _NAME_RE.search(name) is None]
    if bad:
        raise ValueError(f'Assembly names with illegal characters: {bad[:3]}')

    dups = [n for n, c in collections.Counter(df['NAME']).items() if c > 1]
    if dups:
        raise ValueError(f'Duplicate assembly names: {dups}')

    df = df.set_index('NAME')
    if 'CONFIG' not in df.columns:
        df['CONFIG'] = np.nan

    ignore = set(ignore_cols) | {'CONFIG'}

    hap_list = []
    hap_col_map = {}
    filter_cols = []
    unknown = []

    for col in df.columns:
        if col in ignore:
            continue
        m_named = _HAP_NAMED_RE.search(col)
        m_num = _HAP_NUM_RE.search(col)
        m_filter = _FILTER_RE.search(col)
        if m_named:
            hap = m_named[1]
        elif m_num:
            hap = f'h{m_num[1]}'
        elif m_filter:
            filter_cols.append(col)
            continue
        else:
            unknown.append(col)
            continue
        if hap in hap_col_map:
            raise ValueError(f'Duplicate haplotype name "{hap}" in assembly table')
        hap_list.append(hap)
        hap_col_map[hap] = col

    if unknown:
        raise ValueError(f'Unknown columns in assembly table: {unknown[:5]}')

    df_hap = df[[hap_col_map[h] for h in hap_list]].copy()
    df_hap.columns = [f'HAP_{h}' for h in hap_list]

    # FILTER_X columns must correspond to a haplotype input column.
    filter_map = {
        'FILTER_' + (col[len('HAP_'):] if col.startswith('HAP_') else col): f'FILTER_{hap}'
        for hap, col in hap_col_map.items()
    }
    missing = [col for col in filter_cols if col not in filter_map]
    if missing:
        raise ValueError(f'Filter columns without matching haplotype columns: {missing}')
    df_filter = df[filter_cols].copy()
    df_filter.columns = [filter_map[c] for c in filter_cols]

    return pd.concat([df_hap, df_filter, df[['CONFIG']]], axis=1)


def get_hap_list(asm_table, asm_name):
    """Haplotypes with non-empty input for an assembly."""
    if asm_name not in asm_table.index:
        raise KeyError(f'Assembly not in table: {asm_name}')
    row = asm_table.loc[asm_name]
    haps = []
    for col in asm_table.columns:
        if col.startswith('HAP_') and not pd.isnull(row[col]) and str(row[col]).strip():
            haps.append(col[len('HAP_'):])
    return haps


def get_asm_config_override(asm_table, asm_name):
    """Parsed CONFIG-column overrides for an assembly (may be empty)."""
    if asm_name not in asm_table.index:
        return {}
    return parse_config_override_string(asm_table.loc[asm_name, 'CONFIG'])


def expand_input(path_spec, asm_name, hap, sample=None, parent=None, _depth=0):
    """Resolve one haplotype's input cell into a list of sequence files.

    Supports ';'-separated lists, wildcard expansion ({asm_name}, {sample},
    {hap}), and FOFN recursion (reference: pavlib/pipeline.py:180-329).
    """
    if _depth > 8:
        raise ValueError(f'FOFN recursion too deep resolving input for {asm_name}/{hap}')
    if path_spec is None or (isinstance(path_spec, float) and np.isnan(path_spec)):
        return []

    if sample is None:
        sample = asm_name.rsplit('_', 1)[0] if '_' in asm_name else asm_name

    files = []
    for item in str(path_spec).split(';'):
        item = item.strip()
        if not item:
            continue
        item = item.format(asm_name=asm_name, sample=sample, hap=hap)
        if parent is not None and not os.path.isabs(item):
            item = os.path.join(parent, item)
        if item.lower().endswith('.fofn'):
            with open(item) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        files.extend(expand_input(
                            line, asm_name, hap, sample=sample,
                            parent=os.path.dirname(item), _depth=_depth + 1))
        else:
            files.append(item)
    return files


def load_filter_regions(path_spec, asm_name, hap):
    """Load FILTER_<hap> BED file(s) — query-space regions whose variants get
    FILTER=QRY_FILTER (reference: rules/call.snakefile:552-562, FILTER columns
    pavlib/pipeline.py:160,602-638). #CHROM holds query/contig names.

    :return: DataFrame ['#CHROM', 'POS', 'END'] or None when no filter input.
    """
    frames = []
    for path in expand_input(path_spec, asm_name, hap):
        if not os.path.isfile(path):
            raise FileNotFoundError(f'Filter BED not found for {asm_name}/{hap}: {path}')
        if os.path.getsize(path) == 0:
            continue
        df = pd.read_csv(path, sep='\t', header=None, comment='#',
                         usecols=(0, 1, 2))
        df.columns = ['#CHROM', 'POS', 'END']
        df['#CHROM'] = df['#CHROM'].astype(str)
        frames.append(df)
    if not frames:
        return None
    return pd.concat(frames, ignore_index=True)


def get_filter_spec(asm_table, asm_name, hap):
    """The FILTER_<hap> cell for an assembly, or None."""
    col = f'FILTER_{hap}'
    if col not in asm_table.columns:
        return None
    val = asm_table.loc[asm_name, col]
    if val is None or (isinstance(val, float) and np.isnan(val)) or not str(val).strip():
        return None
    return str(val).strip()


def load_haplotype_seqs(path_spec, asm_name, hap, seq_store_cls=None):
    """Load all sequences for one haplotype into a SeqStore. Missing/empty inputs
    produce an empty store (missing-haplotype convention)."""
    from .io.fasta import SeqStore, read_seq_file

    store = SeqStore()
    for path in expand_input(path_spec, asm_name, hap):
        if not os.path.isfile(path):
            raise FileNotFoundError(f'Input not found for {asm_name}/{hap}: {path}')
        if os.path.getsize(path) == 0:
            continue  # empty file = missing haplotype input
        for name, codes in read_seq_file(path).items():
            store.add(name, codes)
    return store
