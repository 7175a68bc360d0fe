"""The measuring process's peak resident set (``ru_maxrss``) when the
window ends, in GiB: what a PAV job is sized by on a cluster."""


def read(record):
    return record['peak_rss_gib']
