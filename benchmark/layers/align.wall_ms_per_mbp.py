"""Aligner: the align stage's host wall (``timings.tsv`` align), the longer
haplotype of each sample (the two run at once), summed over samples, in ms
a contig Mbp."""


def read(record):
    secs = 0.0
    for s in record['samples']:
        walls = [t for label, stage, t in s['timings']
                 if label.startswith(s['name'] + '/') and stage == 'align']
        secs += max(walls, default=0.0)
    return 1e3 * secs / record['contig_mbp'] if record['contig_mbp'] and secs else None
