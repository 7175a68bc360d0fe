"""CLI and pipeline: how far one callset tier sets the diploid merge's
wall, from the program's spans (``<run_dir>/<sample>/spans.tsv``), in %:
100 x the sum over samples of the longest ``merge.job`` (one task of the
merge pool, one callset tier) over the sum of the ``<sample>:merge`` stage
spans. 100 means the merge waits on its longest tier alone. None where a
sample has no spans.tsv or no merge job span."""

import csv
import os


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def read(record):
    longest = stage = 0
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        jobs = [int(r['END_NS']) - int(r['START_NS']) for r in rows
                if r['NAME'] == 'merge.job' and r['LABEL'] == s['name']]
        if not jobs:
            return None
        longest += max(jobs)
        stage += sum(int(r['END_NS']) - int(r['START_NS']) for r in rows
                     if r['NAME'] == s['name'] + ':merge')
    return 100.0 * longest / stage if stage else None
