"""DP batch: the cells the items need over the cells the launches scan
(``affine_dp.STATS['classes']`` cells_real over cells_pad, every class),
in %: useful work over work done."""


def read(record):
    classes = record['dp_stats']['classes'].values()
    pad = sum(c[3] for c in classes)
    real = sum(c[4] for c in classes)
    return 100.0 * real / pad if pad else None
