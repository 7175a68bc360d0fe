"""DP batch: host time spent waiting for the device's results
(``affine_dp.STATS['resolve_s']``), in ms a contig Mbp."""


def read(record):
    secs = record['dp_stats']['resolve_s']
    return 1e3 * secs / record['contig_mbp'] if record['contig_mbp'] and secs else None
