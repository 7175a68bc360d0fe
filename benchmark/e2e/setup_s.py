"""Set-up: from the start of the run to the window (generation in child
processes, FASTA writes, imports and CUDA, the kernel libraries, the
warm-up sample), in s."""


def read(record):
    return record['setup_s']
