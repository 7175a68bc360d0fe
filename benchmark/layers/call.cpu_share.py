"""Calls: the call stages' thread CPU time over their wall, from the
program's spans (``<run_dir>/<sample>/spans.tsv``), in %: 100 x sum(CPU_NS)
/ sum(END_NS - START_NS) over the spans ``<sample>/<hap>:<stage>`` of trim,
depth, cigar_call, largesv, inv_scan and integrate, both haplotypes, all
samples. CPU_NS is the stage's own thread's: what is below 100 is waiting
(the interpreter lock held by the other haplotype, locks, faults, the
stage's own pools). None where a sample has no spans.tsv."""

import csv
import os

STAGES = ('trim', 'depth', 'cigar_call', 'largesv', 'inv_scan', 'integrate')


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def read(record):
    cpu = wall = 0
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        for r in rows:
            if (r['LABEL'].startswith(s['name'] + '/')
                    and r['NAME'] in {f"{r['LABEL']}:{st}" for st in STAGES}):
                cpu += int(r['CPU_NS'])
                wall += int(r['END_NS']) - int(r['START_NS'])
    return 100.0 * cpu / wall if wall else None
