"""The walker (``csrc/traceback.cu``): each item's tape walked from (m, n)
to (0, 0) into 2-bit steps. Counted on the items' path steps: 40 int32
operations a step (the branches of the walker's step body), as
``chip_smoke.py`` counts them; bytes: one tape byte and two base codes read
a step, the two int32 lengths read and the packed path (a quarter byte a
step, 5 bytes of length and error) written once an item."""

NEEDLE = 'traceback'
PEAK = 'int32_ops_s'
OPS_STEP = 40


def work(launches):
    """(operations, bytes) of every launch's walk, or None."""
    if not launches:
        return None
    steps = sum(int(L['path'].sum()) for L in launches)
    items = sum(len(L['path']) for L in launches)
    return OPS_STEP * steps, 3 * steps + 8 * items + (steps + 3) // 4 + 5 * items
