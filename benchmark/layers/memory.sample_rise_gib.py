"""Memory: how far one sample raises the process's peak resident set, from
the program's spans (``<run_dir>/<sample>/spans.tsv``), in GiB: the peak
(``hwm_kib``) at the close of the sample's last stage span (its stage spans'
largest) less the peak when its ``<sample>:load`` span opened
(``hwm0_kib``), the largest over the window's samples. What set-up and
earlier samples had raised the peak to is not counted again. None where a
sample has no spans.tsv or its spans carry no memory counts."""

import csv
import os


def spans(sample):
    path = os.path.join(sample['run_dir'], sample['name'], 'spans.tsv')
    if not os.path.isfile(path):
        return None
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def counts(row):
    return dict(kv.split('=', 1) for kv in row['COUNTS'].split(',')) if row['COUNTS'] else {}


def read(record):
    rise = None
    for s in record['samples']:
        rows = spans(s)
        if rows is None:
            return None
        load = [counts(r) for r in rows if r['NAME'] == s['name'] + ':load']
        peaks = [int(counts(r)['hwm_kib']) for r in rows
                 if (r['LABEL'] == s['name'] or r['LABEL'].startswith(s['name'] + '/'))
                 and 'hwm_kib' in counts(r)]
        if len(load) != 1 or 'hwm0_kib' not in load[0] or not peaks:
            return None
        kib = max(peaks) - int(load[0]['hwm0_kib'])
        rise = kib / 2**20 if rise is None else max(rise, kib / 2**20)
    return rise
