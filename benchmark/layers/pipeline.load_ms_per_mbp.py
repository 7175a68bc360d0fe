"""CLI and pipeline: reading the inputs, from the program's spans
(``<run_dir>/<sample>/spans.tsv``): the reference FASTA and its tables
(``run:reference``, once a CLI run, so once a sample here) and the
haplotype FASTA files (``<sample>:load``), summed over samples, in ms a
contig Mbp. None where a sample has no spans.tsv."""

import csv
import os


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def read(record):
    ns = 0
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        ns += sum(int(r['END_NS']) - int(r['START_NS']) for r in rows
                  if r['NAME'] in ('run:reference', s['name'] + ':load'))
    mbp = record['contig_mbp']
    return 1e-6 * ns / mbp if mbp and record['samples'] else None
