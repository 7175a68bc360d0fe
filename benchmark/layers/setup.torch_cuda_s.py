"""Set-up: torch's import and the card's CUDA context, before anything of
the port, in seconds of the host's clock (a part of setup_s)."""


def read(record):
    return record['setup_parts'].get('torch and the card')
