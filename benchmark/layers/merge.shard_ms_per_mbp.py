"""CLI and pipeline: the diploid merge's sharded branch, from the program's
spans (``<run_dir>/<sample>/spans.tsv``): the summed wall of its chromosome
batches (``merge.shard``, one a batch of a callset tier whose calls lie on
more than one batch) and of their concatenation and sort
(``merge.concat``), over all samples, in ms a contig Mbp. None where a
sample has no spans.tsv or no tier sharded."""

import csv
import os

NAMES = ('merge.shard', 'merge.concat')


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def read(record):
    ns = shards = 0
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        for r in rows:
            if r['NAME'] in NAMES and r['LABEL'] == s['name']:
                ns += int(r['END_NS']) - int(r['START_NS'])
                shards += r['NAME'] == 'merge.shard'
    mbp = record['contig_mbp']
    return 1e-6 * ns / mbp if mbp and shards else None
