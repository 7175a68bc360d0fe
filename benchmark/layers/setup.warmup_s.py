"""Set-up: the warm-up sample through the port's CLI at 1/200 scale (its
kernel libraries loaded, or built on a checkout's first run, and every
stage run once), in seconds of the host's clock (a part of setup_s)."""


def read(record):
    return record['setup_parts'].get('warm-up sample')
