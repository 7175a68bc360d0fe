"""VCF emission: merged diploid call tables -> bgzipped VCF.

Parity with the reference writer (pavlib/vcf.py:15-341 driven by
rules/vcf.snakefile:26-99): symbolic ALT for inversions, anchor-base REF/ALT
construction for INS/DEL, 1-based SNV POS shift, the INFO field vocabulary,
FILTER validation against the known set, and contig headers from the reference
table. Output is BGZF (tabix-compatible blocks) via pav_tpu.io.bgzf.
"""

import datetime
import os

import numpy as np
import pandas as pd

from . import constants, seqcodec
from .io.bgzf import BgzfWriter

INFO_HEADERS = [
    ('ID', '1', 'String', 'Variant ID'),
    ('SVTYPE', '1', 'String', 'Variant type'),
    ('SVLEN', '.', 'Integer', 'Variant length'),
    ('HAP', '.', 'String', 'List of haplotype names variant was identified in'),
    ('HAP_VARIANTS', '.', 'String', 'Variant IDs merged in for each haplotype (INFO/HAP order)'),
    ('COV_MEAN', '.', 'String', 'Mean coverage under the variant per haplotype (INFO/HAP order)'),
    ('COV_PROP', '.', 'String', 'Proportion of reference bases with aligned query (INFO/HAP order)'),
    ('QRY_REGION', '.', 'String', 'Query region of the variant (1-based, INFO/HAP order)'),
    ('QRY_STRAND', '.', 'String', 'Query orientation at this site (INFO/HAP order)'),
    ('CALL_SOURCE', '.', 'String', 'How variant was called (INFO/HAP order)'),
    ('COMPOUND', '.', 'String', 'IDs of variants covering this COMPOUND-filtered event'),
    ('INNER_REF', '.', 'String', 'Inversion inner breakpoints, reference coordinates'),
    ('INNER_TIG', '.', 'String', 'Inversion inner breakpoints, contig coordinates'),
]


def write_merged_vcf(asm_name, input_dict, output_filename, ref_store,
                     ref_info_df, symbolic_alt=('sv_inv',), symbolic_seq=None):
    """Write the merged VCF for one assembly.

    :param input_dict: {(varsvtype, 'pass'|'fail'): DataFrame} of merged tables
        (SEQ column holds variant sequence where applicable).
    :param ref_store: Reference SeqStore (REF anchor bases).
    :param ref_info_df: DataFrame with NAME/LEN (and optional MD5) per contig.
    """
    symbolic_alt = ({symbolic_alt} if isinstance(symbolic_alt, str)
                    else set(symbolic_alt or ()))
    symbolic_seq = ({symbolic_seq} if isinstance(symbolic_seq, str)
                    else set(symbolic_seq or ()))

    if asm_name in {'#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER', 'INFO', 'FORMAT'}:
        raise ValueError(f'Assembly name conflicts with a VCF header column: {asm_name}')

    known_filters = set(constants.FILTER_REASON)
    df_list = []
    symbolic_alt_set = set()
    any_info_seq = False

    for (varsvtype, filter_tier), df in input_dict.items():
        if df is None or df.shape[0] == 0:
            continue
        df = df.copy()
        vartype, svtype = varsvtype.split('_')

        is_symbolic = varsvtype in symbolic_alt
        is_info_seq = is_symbolic and varsvtype in symbolic_seq
        if is_symbolic:
            symbolic_alt_set.add(svtype.upper())
            any_info_seq |= is_info_seq
        if svtype == 'inv' and not is_symbolic:
            raise ValueError('INV found without symbolic ALTs set')

        if 'FILTER' not in df.columns:
            df['FILTER'] = 'PASS'
        filt = df['FILTER'].fillna('').astype(str).str.strip().str.replace(',', ';')
        df['FILTER'] = filt.where(filt != '', 'PASS')
        # Vocabulary check over the (few) distinct values, not every row.
        unknown = set()
        for val in df['FILTER'].unique():
            unknown |= set(str(val).split(';')) - known_filters
        if unknown:
            raise ValueError(f'Unknown filter(s) in variant table: {sorted(unknown)[:3]}')

        if vartype != 'svindel':
            df['VARTYPE'] = vartype.upper()
        else:
            df['VARTYPE'] = np.where(df['SVLEN'].astype(int) >= 50, 'SV', 'INDEL')

        for col in ('HAP', 'HAP_VARIANTS', 'CALL_SOURCE', 'QRY_REGION', 'QRY_STRAND',
                    'COV_MEAN', 'COV_PROP', 'RGN_REF_INNER', 'RGN_QRY_INNER'):
            if col in df.columns:
                df[col] = df[col].astype(str).str.replace(';', ',')

        if svtype == 'del':
            df['SVLEN'] = -np.abs(df['SVLEN'].astype(int))

        # INFO assembly
        info = 'ID=' + df['ID'].astype(str) + ';SVTYPE=' + df['SVTYPE'].astype(str)
        if vartype != 'snv':
            info = info + ';SVLEN=' + df['SVLEN'].astype(str)
        info = (info
                + ';HAP=' + df['HAP'].astype(str)
                + ';HAP_VARIANTS=' + df['HAP_VARIANTS'].astype(str)
                + ';COV_MEAN=' + df['COV_MEAN'].astype(str)
                + ';COV_PROP=' + df['COV_PROP'].astype(str)
                + ';QRY_REGION=' + df['QRY_REGION'].astype(str)
                + ';QRY_STRAND=' + df['QRY_STRAND'].astype(str)
                + ';CALL_SOURCE=' + df['CALL_SOURCE'].astype(str))
        if svtype == 'inv':
            info = (info + ';INNER_REF=' + df['RGN_REF_INNER'].astype(str)
                    + ';INNER_TIG=' + df['RGN_QRY_INNER'].astype(str))
        if 'COMPOUND' in df.columns:
            comp = df['COMPOUND'].fillna('').astype(str)
            info = info + np.where(comp != '', ';COMPOUND=' + comp, '')
        df['INFO'] = info

        # REF anchor base (base before the event; reference: vcf.py:200-211),
        # gathered per chromosome with one fancy index.
        if 'REF' not in df.columns:
            base_lut = np.array(['A', 'C', 'G', 'T', 'N'], dtype='<U1')
            refs = np.empty(df.shape[0], dtype='<U1')
            chrom_arr = df['#CHROM'].to_numpy()
            pos_arr = df['POS'].to_numpy().astype(np.int64)
            for chrom in pd.unique(df['#CHROM']):
                sel = chrom_arr == chrom
                codes = ref_store.get(chrom)
                p = np.clip(pos_arr[sel] - 1, 0, len(codes) - 1)
                refs[sel] = base_lut[np.clip(codes[p], 0, 4)]
            df['REF'] = refs

        # ALT construction
        if vartype != 'snv':
            if is_symbolic:
                df['ALT'] = '<' + df['SVTYPE'].astype(str) + '>'
                if is_info_seq and 'SEQ' in df.columns:
                    df['INFO'] = df['INFO'] + ';SEQ=' + df['SEQ'].astype(str)
            else:
                if 'SEQ' not in df.columns:
                    raise ValueError(f'SEQ column required for non-symbolic {varsvtype}')
                seq = df['SEQ'].astype(str)
                pos0 = df['POS'].astype(int) > 0
                anchored = np.where(pos0, df['REF'] + seq, seq + df['REF'])
                df['REF'] = np.where(df['SVTYPE'] == 'DEL', anchored, df['REF'])
                df['ALT'] = np.where(df['SVTYPE'] == 'INS', anchored, df['REF'].str[:1])
                df['ALT'] = df['ALT'].str.upper()
                df['REF'] = df['REF'].str.upper()
                del df['SEQ']
        else:
            # SNVs: 0-based BED POS -> 1-based VCF POS (reference: vcf.py:245-249).
            df['POS'] = df['POS'].astype(int) + 1
            df['ALT'] = df['ALT'].astype(str).str.upper()

        if 'QUAL' not in df.columns:
            df['QUAL'] = '.'
        if 'GT' not in df.columns:
            df['GT'] = '1|.'

        df_list.append(df[['#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER',
                           'INFO', 'GT']])

    if df_list:
        df = pd.concat(df_list, axis=0)
        df = df.sort_values(['#CHROM', 'POS'])
    else:
        df = pd.DataFrame([], columns=['#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL',
                                       'FILTER', 'INFO', 'GT'])

    df['FORMAT'] = 'GT'
    df = df[['#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER', 'INFO', 'FORMAT', 'GT']]
    df.columns = ['#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER', 'INFO',
                  'FORMAT', asm_name]

    unknown_alt = symbolic_alt_set - {'INS', 'DEL', 'INV'}
    if unknown_alt:
        raise ValueError(f'Unknown symbolic ALTs: {sorted(unknown_alt)}')

    tbi_records = []
    with BgzfWriter(output_filename) as out:
        out.write('##fileformat=VCFv4.2\n')
        out.write(f'##fileDate={datetime.date.today().strftime("%Y%m%d")}\n')
        out.write(f'##source=pav_tpu {constants.get_version_string()}\n')
        for _, row in ref_info_df.iterrows():
            md5 = f',md5={row["MD5"]}' if 'MD5' in row.index and pd.notnull(row.get('MD5')) else ''
            out.write(f'##contig=<ID={row["NAME"]},length={row["LEN"]}{md5}>\n')
        for flt, reason in constants.FILTER_REASON.items():
            out.write(f'##FILTER=<ID={flt},Description="{reason}">\n')
        headers = list(INFO_HEADERS)
        if any_info_seq:
            headers.append(('SEQ', '.', 'String', 'SV or indel sequence'))
        for hid, num, typ, desc in headers:
            out.write(f'##INFO=<ID={hid},Number={num},Type={typ},Description="{desc}">\n')
        for alt_id, desc in (('INS', 'Sequence insertion'), ('DEL', 'Sequence deletion'),
                             ('INV', 'Inversion')):
            if alt_id in symbolic_alt_set:
                out.write(f'##ALT=<ID={alt_id},Description="{desc}">\n')
        out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        out.write('\t'.join(df.columns))
        out.write('\n')
        # Columnar line assembly (one vectorized concat), then a tight write
        # loop that only records per-record virtual offsets for the index.
        if df.shape[0]:
            cols = [df[c].astype(str).to_numpy(dtype=object) for c in df.columns]
            lines = cols[0]
            for c in cols[1:]:
                lines = lines + '\t' + c
            chroms = cols[0]
            begs = df['POS'].to_numpy().astype(np.int64) - 1
            ends = begs + np.maximum(
                df['REF'].astype(str).str.len().to_numpy(), 1)
            for i in range(len(lines)):
                vs = out.tell_virtual()
                out.write(lines[i])
                out.write('\n')
                tbi_records.append((chroms[i], int(begs[i]), int(ends[i]),
                                    vs, out.tell_virtual()))

    # Tabix index (reference runs the external tabix binary:
    # rules/vcf.snakefile:97). Remove any stale index first so a failed write
    # can't leave a .tbi inconsistent with the new VCF.
    tbi_path = output_filename + '.tbi'
    if os.path.exists(tbi_path):
        os.unlink(tbi_path)
    try:
        from .io.tabix import write_tabix
        write_tabix(tbi_records, tbi_path)
    except Exception as exc:
        import warnings
        warnings.warn(f'tabix index write failed for {output_filename}: {exc!r}')


def ref_info_table(ref_store, with_md5=True):
    """Per-chromosome NAME/LEN/MD5 table (reference: rules/data.snakefile:21-32)."""
    import hashlib
    rows = []
    for name in ref_store.names():
        codes = ref_store.get(name)
        md5 = None
        if with_md5:
            md5 = hashlib.md5(seqcodec.decode(codes).encode()).hexdigest()
        rows.append((name, len(codes), md5))
    return pd.DataFrame(rows, columns=['NAME', 'LEN', 'MD5'])
