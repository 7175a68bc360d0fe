"""dp_full (``csrc/dp_full.cu``): the full-width two-piece affine DP, one
tape byte a cell. Counted on the items' real cells, m x (n + 1) each, so
that the work reads the same whatever kernel computes it: 40 int32
operations a cell (E1/E2 open, extend and max 6, E max 1, substitution
compare and select 2, diagonal add 1, Htilde max 1, Htilde + j*e 2, the
running prefix max 2, F 2, open-at-left compares 2, F and H max 2, eight
tape bits a compare and an or-shift each 16, three validity selects 3), as
``chip_smoke.py`` counts them; bytes: each item's query and reference bases
and its two int32 lengths read once, one tape byte a real cell written
once."""

NEEDLE = 'dp_full'
PEAK = 'int32_ops_s'
OPS_CELL = 40


def work(launches):
    """(operations, bytes) of the full-width launches, or None."""
    full = [L for L in launches if L['kind'] == 'full']
    if not full:
        return None
    cells = sum(int((L['m'].astype('int64') * (L['n'].astype('int64') + 1)).sum()) for L in full)
    inputs = sum(int(L['m'].sum()) + int(L['n'].sum()) + 8 * len(L['m']) for L in full)
    return OPS_CELL * cells, inputs + cells
