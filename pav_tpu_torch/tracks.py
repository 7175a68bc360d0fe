"""Browser-track emission: variant and alignment BED9+ and BigBed tracks.

Parity with the reference's track rules (rules/tracks.snakefile:99-307): call
tables and alignment tiers become UCSC-loadable BED9+ files with per-haplotype
colors and query-order annotation. The reference converts these to BigBed with
the external bedToBigBed binary (rules/tracks.snakefile:115,192); here the bbi
container is written natively (pav_tpu.io.bigbed) — no external tool.
"""

import gzip

# Viridis-like per-haplotype colors (reference uses matplotlib viridis:
# rules/tracks.snakefile:251-259).
_HAP_COLORS = ['68,1,84', '33,145,140', '94,201,98', '253,231,37',
               '59,82,139', '33,229,249']

_SVTYPE_COLORS = {
    'INS': '0,0,255',
    'DEL': '255,0,0',
    'INV': '0,128,0',
    'SNV': '0,0,0',
}


def variant_track(df, out_path, name='pav_variants'):
    """Write a variant call table as BED9+ (ID, SVTYPE, SVLEN, FILTER kept)."""
    opener = gzip.open if str(out_path).endswith('.gz') else open
    with opener(out_path, 'wt') as fh:
        fh.write(f'track name={name} itemRgb=On\n')
        for _, row in df.iterrows():
            end = max(int(row['END']), int(row['POS']) + 1)
            color = _SVTYPE_COLORS.get(str(row.get('SVTYPE', '')), '0,0,0')
            fh.write('\t'.join(str(v) for v in (
                row['#CHROM'], int(row['POS']), end, row['ID'], 0, '+',
                int(row['POS']), end, color,
                row.get('SVTYPE', ''), row.get('SVLEN', ''),
                row.get('FILTER', 'PASS'),
            )) + '\n')


def alignment_track(df_align, out_path, name='pav_align'):
    """Write an alignment tier as BED9+ with per-haplotype colors and
    query-order index."""
    opener = gzip.open if str(out_path).endswith('.gz') else open
    hap_ids = {h: i for i, h in enumerate(sorted(set(df_align['HAP'])))}
    # Query order: rank of each record along its contig.
    order = df_align.sort_values(['QRY_ID', 'QRY_POS']).groupby('QRY_ID').cumcount()
    order = order.reindex(df_align.index)
    with opener(out_path, 'wt') as fh:
        fh.write(f'track name={name} itemRgb=On\n')
        for (_, row), qorder in zip(df_align.iterrows(), order):
            color = _HAP_COLORS[hap_ids[row['HAP']] % len(_HAP_COLORS)]
            strand = '-' if row['REV'] else '+'
            label = f"{row['QRY_ID']}:{int(row['QRY_POS'])}-{int(row['QRY_END'])}({qorder})"
            fh.write('\t'.join(str(v) for v in (
                row['#CHROM'], int(row['POS']), int(row['END']), label,
                int(row['MAPQ']) * 16 if int(row['MAPQ']) < 63 else 1000,
                strand, int(row['POS']), int(row['END']), color,
                row['HAP'], int(row['INDEX']),
            )) + '\n')


def _rgb_to_uint(color):
    r, g, b = (int(x) for x in color.split(','))
    return (r << 16) | (g << 8) | b


# autoSql schemas matching the reference's field tables
# (files/tracks/variant_track_fields.tsv, alignment_track_fields.tsv).
_VARIANT_AS = """table pavVariant
"PAV variant call"
(
string chrom;      "Chromosome"
uint   chromStart; "Start"
uint   chromEnd;   "End"
string name;       "Variant ID"
uint   score;      "Score 0-1000"
char[1] strand;    "+ or -"
uint   thickStart; "Thick start"
uint   thickEnd;   "Thick end"
uint   reserved;   "itemRgb"
string id;         "Variant ID"
string svtype;     "Variant type"
string svlen;      "Variant length"
string filter;     "Filter status"
)
"""

_ALIGN_AS = """table pavAlign
"PAV alignment record"
(
string chrom;      "Chromosome"
uint   chromStart; "Start"
uint   chromEnd;   "End"
string name;       "Query region (order)"
uint   score;      "MAPQ-scaled score"
char[1] strand;    "+ or -"
uint   thickStart; "Thick start"
uint   thickEnd;   "Thick end"
uint   reserved;   "itemRgb"
string hap;        "Haplotype"
string alignIndex; "Alignment record index"
)
"""


def variant_track_bigbed(df, chrom_sizes, out_path):
    """Variant call table -> native BigBed (BED9+4: ID/SVTYPE/SVLEN/FILTER).

    Replaces the reference's svpoplib.tracks.variant.make_bb_track +
    bedToBigBed step (rules/tracks.snakefile:107-169)."""
    import pandas as pd

    from .io.bigbed import write_bigbed

    rows = []
    for _, d in df.iterrows():
        pos = int(d['POS'])
        end = max(int(d['END']), pos + 1)
        color = _SVTYPE_COLORS.get(str(d.get('SVTYPE', '')), '0,0,0')
        rows.append({
            '#CHROM': str(d['#CHROM']), 'POS': pos, 'END': end,
            'name': str(d.get('ID', '')), 'score': 0, 'strand': '+',
            'thickStart': pos, 'thickEnd': end,
            'rgb': _rgb_to_uint(color),
            'ID': str(d.get('ID', '')), 'SVTYPE': str(d.get('SVTYPE', '')),
            'SVLEN': str(d.get('SVLEN', '')),
            'FILTER': str(d.get('FILTER', 'PASS')),
        })
    cols = ['#CHROM', 'POS', 'END', 'name', 'score', 'strand', 'thickStart',
            'thickEnd', 'rgb', 'ID', 'SVTYPE', 'SVLEN', 'FILTER']
    bed = pd.DataFrame(rows, columns=cols)
    write_bigbed(bed, chrom_sizes, out_path, extra_cols=cols[3:],
                 autosql=_VARIANT_AS)


def alignment_track_bigbed(df_align, chrom_sizes, out_path):
    """Alignment tier -> native BigBed (BED9+2: HAP, INDEX)."""
    import pandas as pd

    from .io.bigbed import write_bigbed

    hap_ids = {h: i for i, h in enumerate(sorted(set(df_align['HAP'])))}
    order = df_align.sort_values(['QRY_ID', 'QRY_POS']).groupby('QRY_ID').cumcount()
    order = order.reindex(df_align.index)
    rows = []
    for (_, row), qorder in zip(df_align.iterrows(), order):
        pos, end = int(row['POS']), int(row['END'])
        color = _HAP_COLORS[hap_ids[row['HAP']] % len(_HAP_COLORS)]
        mapq = int(row['MAPQ'])
        rows.append({
            '#CHROM': str(row['#CHROM']), 'POS': pos, 'END': end,
            'name': f"{row['QRY_ID']}:{int(row['QRY_POS'])}-{int(row['QRY_END'])}({qorder})",
            'score': mapq * 16 if mapq < 63 else 1000,
            'strand': '-' if row['REV'] else '+',
            'thickStart': pos, 'thickEnd': end,
            'rgb': _rgb_to_uint(color),
            'HAP': str(row['HAP']), 'INDEX': str(int(row['INDEX'])),
        })
    cols = ['#CHROM', 'POS', 'END', 'name', 'score', 'strand', 'thickStart',
            'thickEnd', 'rgb', 'HAP', 'INDEX']
    bed = pd.DataFrame(rows, columns=cols)
    write_bigbed(bed, chrom_sizes, out_path, extra_cols=cols[3:],
                 autosql=_ALIGN_AS)
