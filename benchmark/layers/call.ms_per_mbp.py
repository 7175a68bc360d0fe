"""Calls: the per-haplotype stages after align (``timings.tsv`` trim,
depth, cigar_call, largesv, inv_scan, integrate), summed over haplotypes
and samples, in ms a contig Mbp."""

STAGES = ('trim', 'depth', 'cigar_call', 'largesv', 'inv_scan', 'integrate')


def read(record):
    secs = sum(t for s in record['samples'] for label, stage, t in s['timings']
               if label.startswith(s['name'] + '/') and stage in STAGES)
    return 1e3 * secs / record['contig_mbp'] if record['contig_mbp'] and secs else None
