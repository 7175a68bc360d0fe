"""The kernels' counts of operations and bytes against counts made by
hand, and the roofline readers on them."""

import os

import numpy as np

from cpu_harness import BENCH, load


def launches():
    return [{'kind': 'full', 'm': np.array([3, 2]), 'n': np.array([4, 1]),
             'path': np.array([5, 2])},
            {'kind': 'band', 'm': np.array([10]), 'n': np.array([10]),
             'path': np.array([12])}]


def test_dp_full_by_hand():
    k = load(os.path.join(BENCH, 'kernels', 'dp_full.py'), 'k_full')
    # real cells 3 x 5 + 2 x 2 = 19; bases 3 + 2 + 4 + 1 = 10, lengths 16
    assert k.work(launches()) == (40 * 19, 10 + 16 + 19)
    assert k.work([launches()[1]]) is None


def test_traceback_by_hand():
    k = load(os.path.join(BENCH, 'kernels', 'traceback.py'), 'k_walk')
    # steps 5 + 2 + 12 = 19 over 3 items: 3 x 19 + 8 x 3 read,
    # ceil(19 / 4) + 5 x 3 written
    assert k.work(launches()) == (40 * 19, 57 + 24 + 5 + 15)
    assert k.work([]) is None


def test_roofline_reader():
    r = load(os.path.join(BENCH, 'layers', 'dp_full_roofline.py'), 'r_full')
    peaks = {'int32_ops_s': 1e12, 'hbm_bytes_s': 1e11}
    rec = {'peaks': peaks, 'kernels': {'dp_full': {'ops': 2e9, 'bytes': 1e8, 'peak': 'int32_ops_s',
                                                   'device_s': 0.004}}}
    assert abs(r.read(rec) - 50.0) < 1e-9       # 2 ms of operations in 4 ms
    rec['kernels']['dp_full']['bytes'] = 8e8    # 8 ms of bytes bound it
    assert abs(r.read(rec) - 200.0) < 1e-9
    rec['kernels']['dp_full']['device_s'] = 0.0
    assert r.read(rec) is None
