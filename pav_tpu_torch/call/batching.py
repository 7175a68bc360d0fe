"""Work batching: chromosome bin-packing for merge parallelism.

Parity with the reference's merge-batch table (rules/call.snakefile:856-905):
chromosomes are greedily packed into length-balanced bins; each bin is an
independent merge shard (file-parallel jobs in the reference; data-parallel
mesh shards / host workers here).
"""

import collections

import pandas as pd

MERGE_BATCH_COUNT = 20  # reference: rules/definitions.snakefile:4


def merge_batch_table(ref_fai, batch_count=MERGE_BATCH_COUNT):
    """Assign chromosomes to length-balanced batches (greedy, largest first).

    :param ref_fai: {chrom: length}.

    :return: DataFrame indexed by CHROM with LEN and BATCH columns.
    """
    items = sorted(ref_fai.items(), key=lambda kv: -kv[1])
    sizes = collections.Counter()
    rows = []
    for chrom, length in items:
        batch = min(range(batch_count), key=lambda b: (sizes[b] != 0, sizes[b]))
        rows.append((chrom, int(length), batch))
        sizes[batch] += int(length)
    return pd.DataFrame(rows, columns=['CHROM', 'LEN', 'BATCH']).set_index('CHROM')


def round_robin_batches(n_items, batch_count):
    """Round-robin batch ids (CIGAR/INV batch assignment convention:
    rules/align.snakefile:163, rules/call_inv.snakefile:459-466)."""
    return [i % batch_count for i in range(n_items)]
