"""CLI / pipeline: the sample-level stages' host wall (``timings.tsv``
merge + vcf + artifacts, summed over samples) in ms a contig Mbp."""

STAGES = ('merge', 'vcf', 'artifacts')


def read(record):
    secs = sum(t for s in record['samples'] for label, stage, t in s['timings']
               if label == s['name'] and stage in STAGES)
    return 1e3 * secs / record['contig_mbp'] if record['contig_mbp'] else None
