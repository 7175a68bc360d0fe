"""Aligner: the share of the planning pools' task time spent queued, from
the program's spans (``<run_dir>/<sample>/spans.tsv``), in %: 100 x
sum(wait) / sum(wait + run) over the planning pool's tasks
(``align.plan_contig``, each with its wait) and the shared sketch pool's
rows (``pool:sketch``, waits and runs summed a use) under a haplotype's
align stage, both haplotypes, all samples. None where a sample has no
spans.tsv."""

import csv
import os


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def under_align(row, by_id):
    """Whether an ancestor of the row is a haplotype's align stage."""
    seen = set()
    while row['PARENT'] in by_id and row['PARENT'] not in seen:
        seen.add(row['PARENT'])
        row = by_id[row['PARENT']]
        if row['NAME'] == row['LABEL'] + ':align':
            return True
    return False


def read(record):
    wait = run = 0
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        by_id = {r['ID']: r for r in rows}
        for r in rows:
            if r['NAME'] == 'align.plan_contig' or (r['NAME'] == 'pool:sketch'
                                                    and under_align(r, by_id)):
                wait += int(r['WAIT_NS'])
                run += int(r['RUN_NS'])
    return 100.0 * wait / (wait + run) if wait + run else None
