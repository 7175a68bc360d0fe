"""Set-up: the port's import (its CLI, aligner and DP modules), in seconds
of the host's clock (a part of setup_s)."""


def read(record):
    return record['setup_parts'].get('program import')
