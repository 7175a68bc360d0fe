"""Kernels: the walker's (traceback) share of its roofline, in %: the
least time the card needs for the work of ``kernels/traceback.py`` (the
larger of its operations over the int32 rate and its bytes over HBM's,
``peaks.json``; the int32 rate is derived, not published) over the
walker's device time in the trace."""


def read(record):
    k = record['kernels'].get('traceback')
    if not k or not k['device_s'] or not k['ops']:
        return None
    peaks = record['peaks']
    least = max(k['ops'] / peaks[k['peak']], k['bytes'] / peaks['hbm_bytes_s'])
    return 100.0 * least / k['device_s']
