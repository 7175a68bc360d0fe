"""Aligner: the planning pool's wall (``core.ALIGN_STATS_BY_HAP``
``plan_s``), summed over haplotypes and samples, in ms a contig Mbp."""


def read(record):
    secs = sum(v.get('plan_s', 0.0) for v in record['align_by_hap'].values())
    return 1e3 * secs / record['contig_mbp'] if record['contig_mbp'] and secs else None
