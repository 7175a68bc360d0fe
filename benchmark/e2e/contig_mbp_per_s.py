"""Contig bases of every completed sample, both haplotypes, over the
window's wall (first sample's start to the last one's end), in Mbp/s:
samples per card-hour, what a cohort pays for."""


def read(record):
    return record['contig_mbp'] / record['window_s']
