"""The three DP kernels of the aligner and their plain PyTorch versions.

Each wrapper does exactly one of two things: a CPU tensor goes to the plain
version beside it; a CUDA tensor goes to its CUDA kernel (``csrc/``), or the
wrapper raises. It checks device, dtype, shape and contiguity first, and
counts its kernel launches in ``LAUNCHES``.

* ``align_full``  -> ``csrc/dp_full.cu``  (replaces ``pallas_dp._dp_kernel``)
* ``align_wave``  -> ``csrc/dp_wave.cu``  (replaces ``pallas_dp._wave_kernel``)
* ``align_band``  -> ``csrc/dp_band.cu``  (replaces the row-banded XLA
  program ``affine_dp._align_batch``)
* ``traceback``   -> ``csrc/traceback.cu`` (replaces the XLA walker in
  ``affine_dp._align_and_trace_impl``)

The row band is what the reference's CPU ladder and its entry points run.
Its plain version ``align_band_ref`` takes CPU tensors only, and
``traceback`` walks row-banded tapes on the CPU only: no CUDA class of the
aligner runs a row band.

The plain versions follow the reference's recurrences as batched tensor ops
with a Python loop over rows, diagonals or steps, and produce the same bytes
as the reference (tape layout ``pav_tpu/ops/affine_dp.py:14-22``).

Shared arguments: ``q`` int8 [B, max_m] and ``r`` int8 [B, max_n] base codes
(0-3, 4 = N or padding), ``m``/``n`` int32 [B] lengths, ``sc`` the scoring
tuple (match, mismatch, o1, o2, e1, e2).
"""

import threading

import torch

from .. import _build

NEG = -(1 << 29)
STEP_EQ, STEP_X, STEP_I, STEP_D, STEP_DONE = 0, 1, 2, 3, 255

LAUNCHES = {'full': 0, 'wave': 0, 'band': 0, 'traceback': 0}
_COUNT_LOCK = threading.Lock()


def launches_reset():
    with _COUNT_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count(name):
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} is not contiguous')


def _check_seqs(q, r, m, n):
    if not isinstance(q, torch.Tensor) or q.dim() != 2 or r.dim() != 2:
        raise ValueError('q and r must be 2-D tensors [B, len]')
    dev = q.device
    B = q.shape[0]
    _check('q', q, torch.int8, q.shape, dev)
    _check('r', r, torch.int8, (B, r.shape[1]), dev)
    _check('m', m, torch.int32, (B,), dev)
    _check('n', n, torch.int32, (B,), dev)
    if q.shape[1] < 1 or r.shape[1] < 1:
        raise ValueError('max_m and max_n must be >= 1')
    return dev


def _on_card(dev):
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if dev.type == 'cuda':
        return True
    if dev.type == 'cpu':
        return False
    raise ValueError(f'no DP kernel for device {dev}')


def _scoring(sc):
    sc = tuple(int(v) for v in sc)
    if len(sc) != 6:
        raise ValueError('scoring tuple is (match, mismatch, o1, o2, e1, e2)')
    return sc


# ------------------------------------------------------------ full width

def align_full(q, r, m, n, sc):
    """Full-width DP tape: (tb uint8 [B, max_m, max_n + 1], offs int32 zeros
    [B, max_m]), the outputs of ``pallas_dp.pallas_align_full``."""
    dev = _check_seqs(q, r, m, n)
    sc = _scoring(sc)
    B, max_m = q.shape
    max_n = r.shape[1]
    if not _on_card(dev):
        return align_full_ref(q, r, m, n, sc)
    width = max_n + 1
    lib = _build.lib()
    tb = torch.empty((B, max_m, width), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.pav_dp_full(
            q.data_ptr(), r.data_ptr(), m.data_ptr(), n.data_ptr(), tb.data_ptr(),
            B, max_m, max_n, width, *sc,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'pav_dp_full')
    _count('full')
    return tb, torch.zeros((B, max_m), dtype=torch.int32, device=dev)


def _bits(*flags):
    """Pack 8 bool tensors (bit 0 first) into one uint8 tensor."""
    stacked = torch.stack(flags, dim=-1).to(torch.int32)
    shifts = torch.arange(len(flags), dtype=torch.int32, device=stacked.device)
    return (stacked << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def _excl_prefix_max(a, negcol):
    """run[j] = max(NEG, a[0..j-1]); run[0] = NEG."""
    inc = torch.cummax(a, dim=1).values
    return torch.cat([negcol, inc[:, :-1]], dim=1).clamp_min(NEG)


def align_full_ref(q, r, m, n, sc):
    """Plain version of ``align_full``: the row recurrence of
    ``pallas_dp._dp_kernel`` (F as an exclusive prefix max over the row)."""
    match, mismatch, o1, o2, e1, e2 = sc
    B, max_m = q.shape
    max_n = r.shape[1]
    width = max_n + 1
    dev = q.device
    i32 = torch.int32
    j = torch.arange(width, dtype=i32, device=dev)[None, :]
    mi = m[:, None]
    ni = n[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    match_t = torch.tensor(match, dtype=i32, device=dev)
    mismatch_t = torch.tensor(mismatch, dtype=i32, device=dev)

    h = torch.where(j == 0, 0, -torch.minimum(o1 + j * e1, o2 + j * e2))
    h = torch.where(j <= ni, h, NEG).to(i32)
    e1s = torch.full((B, width), NEG, dtype=i32, device=dev)
    e2s = e1s.clone()
    rpad = torch.cat([torch.full((B, 1), 4, dtype=torch.int8, device=dev), r],
                     dim=1)[:, :width].to(i32)
    rb = torch.where((j >= 1) & (j <= ni), rpad, 4)
    # The substitution score of every row's query code against the row of
    # reference codes, code by code: sub_of[c][b] (code 4 never matches).
    sub_of = torch.stack([torch.where(rb == c, match_t, mismatch_t) for c in range(4)]
                         + [torch.full_like(rb, mismatch)])
    in_n = j <= ni
    col0 = (j == 0)
    je1, je2 = j * e1, j * e2
    bidx = torch.arange(B, device=dev)
    tb = torch.empty((B, max_m, width), dtype=torch.uint8, device=dev)

    for i in range(1, max_m + 1):
        valid = in_n & (i <= mi)
        e1o = h - (o1 + e1)
        e1x = e1s - e1
        e1n = torch.maximum(e1o, e1x)
        e2o = h - (o2 + e2)
        e2x = e2s - e2
        e2n = torch.maximum(e2o, e2x)
        eb = torch.maximum(e1n, e2n)

        sub = sub_of[q[:, i - 1].to(torch.int64).clamp(0, 4), bidx]
        hs = torch.cat([negcol, h[:, :-1]], dim=1)
        diag = torch.where(col0, NEG, hs + sub)
        ht = torch.maximum(diag, eb)

        a1 = ht + je1
        a2 = ht + je2
        run1 = _excl_prefix_max(a1, negcol)
        run2 = _excl_prefix_max(a2, negcol)
        f1 = run1 - (o1 + je1)
        f2 = run2 - (o2 + je2)
        op1 = col0 | (run1 == torch.cat([negcol, a1[:, :-1]], dim=1))
        op2 = col0 | (run2 == torch.cat([negcol, a2[:, :-1]], dim=1))
        fb = torch.maximum(f1, f2)
        hn = torch.maximum(ht, fb)

        tb[:, i - 1] = _bits(eb > diag, fb > ht, e2n > e1n, f2 > f1,
                             e1x > e1o, e2x > e2o, op1, op2)
        h = torch.where(valid, hn, NEG)
        e1s = torch.where(valid, e1n, NEG)
        e2s = torch.where(valid, e2n, NEG)
    return tb, torch.zeros((B, max_m), dtype=i32, device=dev)


# ------------------------------------------------------------- row band

def _band_width(width, max_n):
    if max_n < 1:
        raise ValueError('a row band needs max_n >= 1')
    width = int(width)
    if not 1 <= width <= max_n + 1:
        raise ValueError(f'width {width} outside 1..max_n+1={max_n + 1}')
    return width


def align_band(q, r, m, n, width, sc):
    """Row-banded DP of ``affine_dp._align_batch``: (score int32 [B, width],
    the masked H of row max_m; tb uint8 [B, max_m, width]; offs int32 [B,
    max_m]), the outputs of the reference's ``_align_batch``."""
    dev = _check_seqs(q, r, m, n)
    sc = _scoring(sc)
    B, max_m = q.shape
    max_n = r.shape[1]
    width = _band_width(width, max_n)
    if not _on_card(dev):
        return align_band_ref(q, r, m, n, width, sc, with_score=True)
    lib = _build.lib()
    score = torch.empty((B, width), dtype=torch.int32, device=dev)
    tb = torch.empty((B, max_m, width), dtype=torch.uint8, device=dev)
    offs = torch.empty((B, max_m), dtype=torch.int32, device=dev)
    ints = lib.pav_dp_band_scratch_ints(width)
    scratch = (torch.empty(B * ints, dtype=torch.int32, device=dev)
               if ints else None)
    with torch.cuda.device(dev):
        code = lib.pav_dp_band(
            q.data_ptr(), r.data_ptr(), m.data_ptr(), n.data_ptr(),
            score.data_ptr(), tb.data_ptr(), offs.data_ptr(),
            scratch.data_ptr() if ints else None,
            B, max_m, max_n, width, *sc,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'pav_dp_band')
    _count('band')
    return score, tb, offs


def align_band_ref(q, r, m, n, width, sc, with_score=False):
    """Plain version of ``align_band``: the row-banded DP tape of
    ``affine_dp._align_batch``, (tb uint8 [B, max_m, width], offs int32 [B,
    max_m]), or with ``with_score`` (score int32 [B, width], tb, offs),
    score being the masked H of row max_m. Row i's window starts at column
    ``offs[:, i-1] = clip(i*n//m - width//2, 0, max(n+1-width, 0))``; the
    substitution rows are int8 with a -128 sentinel at column 0; row 1 reads
    the analytic row 0; F is an exclusive prefix max over the window
    (opening wins ties). CPU tensors only: a CUDA tensor raises (its path
    is ``align_band``'s kernel)."""
    dev = _check_seqs(q, r, m, n)
    if _on_card(dev):
        raise ValueError('align_band_ref takes CPU tensors only: a row band on '
                         'the card is align_band')
    match, mismatch, o1, o2, e1, e2 = _scoring(sc)
    B, max_m = q.shape
    max_n = r.shape[1]
    width = _band_width(width, max_n)
    i32, i64 = torch.int32, torch.int64
    w = torch.arange(width, dtype=i32)[None, :]
    mi = m[:, None]
    ni = n[:, None]
    # Band placement for every row, in the reference's int32 arithmetic
    # (i*n wraps as it does there).
    rows = torch.arange(1, max_m + 1, dtype=i64)[None, :]
    prod = (rows * ni.to(i64) + (1 << 31)) % (1 << 32) - (1 << 31)
    center = torch.where(mi > 0, torch.div(prod, mi.clamp_min(1).to(i64),
                                           rounding_mode='floor'), 0)
    max_off = (ni + 1 - width).clamp_min(0).to(i64)
    offs = torch.minimum((center - width // 2).clamp_min(0), max_off).to(i32)
    steps = offs - torch.cat([torch.zeros((B, 1), dtype=i32), offs[:, :-1]], dim=1)

    def row0_at(j):
        v = torch.where(j == 0, 0, -torch.minimum(o1 + j * e1, o2 + j * e2))
        return torch.where((j >= 0) & (j <= ni), v, NEG).to(i32)

    def shift(a, k):
        """out[w] = a[w + k] per item, NEG outside the window."""
        idx = w + k
        inside = (idx >= 0) & (idx < width)
        return torch.where(inside, a.gather(1, idx.clamp(0, width - 1).to(i64)), NEG)

    def f_scan(ht, ext, open_):
        aug = ht + w * ext
        run = torch.cummax(aug, dim=1).values
        prev = torch.cat([negcol, run[:, :-1]], dim=1)
        opened = torch.cat([torch.ones((B, 1), dtype=torch.bool),
                            prev[:, 1:] == aug[:, :-1]], dim=1)
        return prev - open_ - w * ext, opened

    negcol = torch.full((B, 1), NEG, dtype=i32)
    sent = torch.tensor(-128, dtype=torch.int8)
    match8 = torch.tensor(match, dtype=i32).to(torch.int8)
    mismatch8 = torch.tensor(mismatch, dtype=i32).to(torch.int8)
    tb = torch.empty((B, max_m, width), dtype=torch.uint8)
    h = e1s = e2s = None
    for i in range(1, max_m + 1):
        off = offs[:, i - 1:i]
        jg = off + w
        valid = (jg <= ni) & (i <= mi)
        rb = r.gather(1, (jg - 1).clamp(0, max_n - 1).to(i64))
        qb = q[:, i - 1:i]
        sub = torch.where((qb == rb) & (qb < 4) & (rb < 4), match8, mismatch8)
        sub = torch.where(jg >= 1, sub, sent)
        if i == 1:
            h_up, h_dg = row0_at(jg), row0_at(jg - 1)
            e1_up = e2_up = torch.full((B, width), NEG, dtype=i32)
        else:
            s = steps[:, i - 1:i]
            h_up, h_dg = shift(h, s), shift(h, s - 1)
            e1_up, e2_up = shift(e1s, s), shift(e2s, s)
        e1o = h_up - (o1 + e1)
        e1x = e1_up - e1
        e1n = torch.maximum(e1o, e1x)
        e2o = h_up - (o2 + e2)
        e2x = e2_up - e2
        e2n = torch.maximum(e2o, e2x)
        eb = torch.maximum(e1n, e2n)
        diag = torch.where(sub == sent, NEG, h_dg + sub.to(i32))
        ht = torch.maximum(diag, eb)
        f1, op1 = f_scan(ht, e1, o1)
        f2, op2 = f_scan(ht, e2, o2)
        fb = torch.maximum(f1, f2)
        hn = torch.maximum(ht, fb)
        tb[:, i - 1] = _bits(eb > diag, fb > ht, e2n > e1n, f2 > f1,
                             e1x > e1o, e2x > e2o, op1, op2)
        h = torch.where(valid, hn, NEG).to(i32)
        e1s = torch.where(valid, e1n, NEG).to(i32)
        e2s = torch.where(valid, e2n, NEG).to(i32)
    return (h, tb, offs) if with_score else (tb, offs)


# ------------------------------------------------------------- wavefront

def align_wave(q, r, m, n, doffs, ww, sc):
    """Wavefront banded DP tape: tb uint8 [B, D, ww] with D = max_m + max_n,
    band placement ``doffs`` int32 [B, D] (``affine_dp._wave_geometry``); the
    tape of ``pallas_dp.pallas_align_wave``."""
    dev = _check_seqs(q, r, m, n)
    sc = _scoring(sc)
    B, max_m = q.shape
    max_n = r.shape[1]
    D = max_m + max_n
    _check('doffs', doffs, torch.int32, (B, D), dev)
    ww = int(ww)
    if ww < 1 or ww % 4:
        raise ValueError(f'ww must be a positive multiple of 4 (lanes per thread), not {ww}')
    if not _on_card(dev):
        return align_wave_ref(q, r, m, n, doffs, ww, sc)
    lib = _build.lib()
    tb = torch.empty((B, D, ww), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.pav_dp_wave(
            q.data_ptr(), r.data_ptr(), m.data_ptr(), n.data_ptr(),
            doffs.data_ptr(), tb.data_ptr(), B, max_m, max_n, ww, *sc,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'pav_dp_wave')
    _count('wave')
    return tb


def align_wave_ref(q, r, m, n, doffs, ww, sc):
    """Plain version of ``align_wave``: the diagonal recurrence of
    ``affine_dp._align_batch_wave`` (F direct, opening wins ties)."""
    match, mismatch, o1, o2, e1, e2 = sc
    B, max_m = q.shape
    max_n = r.shape[1]
    D = max_m + max_n
    dev = q.device
    i32 = torch.int32
    w = torch.arange(ww, dtype=i32, device=dev)[None, :]
    mi = m[:, None]
    ni = n[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    match_t = torch.tensor(match, dtype=i32, device=dev)
    mismatch_t = torch.tensor(mismatch, dtype=i32, device=dev)
    zeros = torch.zeros((B, 2), dtype=i32, device=dev)
    s1 = doffs - torch.cat([zeros[:, :1], doffs[:, :-1]], dim=1)
    s2 = doffs - torch.cat([zeros, doffs[:, :-2]], dim=1)

    def shift_sel(a, t):
        """out[w] = a[w + t] for t in {-1, 0, 1} per item (others read as
        -1, like the reference); out-of-band lanes read NEG."""
        off = torch.where(t == 1, 1, torch.where(t == 0, 0, -1))
        idx = (w + off + 1).to(torch.int64).expand(B, ww)
        return torch.cat([negcol, a, negcol], dim=1).gather(1, idx)

    h_p = torch.where(w == 0, 0, NEG).to(i32).expand(B, ww)
    ht_p = h_p
    negs = torch.full((B, ww), NEG, dtype=i32, device=dev)
    h_pp = e1_p = e2_p = f1_p = f2_p = negs
    tb = torch.empty((B, D, ww), dtype=torch.uint8, device=dev)

    for k in range(D):
        d = k + 1
        doff = doffs[:, k:k + 1]
        t1 = s1[:, k:k + 1]
        t2 = s2[:, k:k + 1]
        iv = doff + w
        jv = d - iv
        valid = (iv <= mi) & (jv >= 0) & (jv <= ni)

        h_up = shift_sel(h_p, t1 - 1)
        e1_up = shift_sel(e1_p, t1 - 1)
        e2_up = shift_sel(e2_p, t1 - 1)
        ht_lf = shift_sel(ht_p, t1)
        f1_lf = shift_sel(f1_p, t1)
        f2_lf = shift_sel(f2_p, t1)
        h_dg = shift_sel(h_pp, t2 - 1)

        e1o = h_up - (o1 + e1)
        e1x = e1_up - e1
        e1n = torch.maximum(e1o, e1x)
        e2o = h_up - (o2 + e2)
        e2x = e2_up - e2
        e2n = torch.maximum(e2o, e2x)
        eb = torch.maximum(e1n, e2n)

        f1o = ht_lf - (o1 + e1)
        f1x = f1_lf - e1
        f1n = torch.maximum(f1o, f1x)
        f2o = ht_lf - (o2 + e2)
        f2x = f2_lf - e2
        f2n = torch.maximum(f2o, f2x)
        fb = torch.maximum(f1n, f2n)

        qv = q.gather(1, (iv - 1).clamp(0, max_m - 1).to(torch.int64)).to(i32)
        rv = r.gather(1, (jv - 1).clamp(0, max_n - 1).to(torch.int64)).to(i32)
        sub = torch.where((qv == rv) & (qv < 4) & (rv < 4), match_t, mismatch_t)
        diag = torch.where((iv >= 1) & (jv >= 1), h_dg + sub, NEG)
        ht = torch.maximum(diag, eb)
        hn = torch.maximum(ht, fb)
        row0 = torch.where(jv == 0, 0, -torch.minimum(o1 + jv * e1, o2 + jv * e2))
        hn = torch.where(iv == 0, row0, hn)

        tb[:, k] = _bits(eb > diag, fb > ht, e2n > e1n, f2n > f1n,
                         e1x > e1o, e2x > e2o, f1o >= f1x, f2o >= f2x)
        h_pp = h_p
        h_p = torch.where(valid, hn, NEG)
        ht_p = torch.where(valid, ht, NEG)
        e1_p = torch.where(valid, e1n, NEG)
        e2_p = torch.where(valid, e2n, NEG)
        f1_p = torch.where(valid, f1n, NEG)
        f2_p = torch.where(valid, f2n, NEG)
    return tb


# ------------------------------------------------------------- traceback

def trace_len(max_m, max_n):
    """Walk length L: max_m + max_n rounded up to a multiple of 4."""
    return ((max_m + max_n + 3) // 4) * 4


def traceback(tb, offs, q, r, m, n, wave):
    """Walk each item's tape from (m, n) to (0, 0) into the fused uint8
    buffer [B, L/4 + 5]: 2-bit step codes in walk order, 4-byte LE path
    length, err byte (``affine_dp._align_and_trace_impl``'s output).

    :param tb: uint8 [B, rows, w_dim] tape; rows are DP rows (``wave``
        false: the tape of ``align_full``, w_dim = max_n + 1, or on the CPU
        the row band of ``align_band_ref``, w_dim < max_n + 1) or
        anti-diagonals (``wave`` true).
    :param offs: int32 [B, rows] band offset of each tape row (zeros for
        ``align_full``'s tape, which the kernel does not read).
    """
    dev = _check_seqs(q, r, m, n)
    B, max_m = q.shape
    max_n = r.shape[1]
    if not isinstance(tb, torch.Tensor) or tb.dim() != 3:
        raise ValueError('tb must be a 3-D tensor [B, rows, w_dim]')
    rows, w_dim = tb.shape[1], tb.shape[2]
    _check('tb', tb, torch.uint8, (B, rows, w_dim), dev)
    _check('offs', offs, torch.int32, (B, rows), dev)
    need = max_m + max_n if wave else max_m
    if rows < need or w_dim < 1:
        raise ValueError(f'tape has {rows} rows x {w_dim} lanes, needs {need} rows')
    if not wave and w_dim > max_n + 1:
        raise ValueError(f'a row tape has at most max_n + 1 = {max_n + 1} lanes, not {w_dim}')
    L = trace_len(max_m, max_n)
    if not _on_card(dev):
        return traceback_ref(tb, offs, q, r, m, n, wave)
    if not wave and w_dim != max_n + 1:
        raise ValueError(f'a row-banded tape ({w_dim} of max_n + 1 = {max_n + 1} lanes) '
                         'is walked on the CPU only: no CUDA class runs a row band')
    lib = _build.lib()
    out = torch.empty((B, L // 4 + 5), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.pav_traceback(
            tb.data_ptr(), offs.data_ptr(), q.data_ptr(), r.data_ptr(),
            m.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, rows, w_dim, max_m, max_n, L, 1 if wave else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'pav_traceback')
    _count('traceback')
    return out


def _step_table(dev):
    """The walker's step off the tape's edges as a table over (byte, state,
    piece), key ``byte | state << 8 | piece << 10``: value ``act | new_piece
    << 2 | new_state << 3`` (act 0 diagonal, 1 up, 2 left; states 0 H, 1
    E, 2 F), the branches of the reference walker's step body."""
    key = torch.arange(2048, dtype=torch.int64, device=dev)
    byte, st, piece = key & 255, (key >> 8) & 3, key >> 10
    act_h = torch.where((byte & 2) != 0, 2, torch.where((byte & 1) != 0, 1, 0))
    act = torch.where(st == 0, act_h, st)
    new_piece = torch.where(
        (st == 0) & (act == 1), (byte >> 2) & 1,
        torch.where((st == 0) & (act == 2), (byte >> 3) & 1, piece))
    e_ext = torch.where(new_piece == 0, (byte >> 4) & 1, (byte >> 5) & 1)
    f_open = torch.where(new_piece == 0, (byte >> 6) & 1, (byte >> 7) & 1)
    new_st = torch.where(act == 0, 0, torch.where(act == 1, e_ext, 2 - 2 * f_open))
    return act | (new_piece << 2) | (new_st << 3)


def traceback_ref(tb, offs, q, r, m, n, wave):
    """Plain version of ``traceback``: the reference walker's step body,
    batched over items, one loop iteration per step (the step's branches
    on the tape byte, state and piece read from ``_step_table``; on the
    tape's top row a walk goes left into state F, on its left column up
    into state E)."""
    B, max_m = q.shape
    max_n = r.shape[1]
    w_dim = tb.shape[2]
    L = trace_len(max_m, max_n)
    dev = q.device
    i32, i64 = torch.int32, torch.int64
    bidx = torch.arange(B, device=dev)
    table = _step_table(dev)
    step_of_act = torch.tensor([STEP_X, STEP_I, STEP_D], dtype=torch.uint8, device=dev)
    i = m.to(i64)
    j = n.to(i64)
    st = torch.zeros(B, dtype=i64, device=dev)
    piece = torch.zeros(B, dtype=i64, device=dev)
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    codes = torch.full((B, L), STEP_DONE, dtype=torch.uint8, device=dev)
    # Every step of a walk not yet done lowers i + j by at least one, so
    # after max(m + n) steps every walk is done and later steps only write
    # STEP_DONE: a wide class's tape (L up to 32772) is walked for its
    # longest item, not for its padded width.
    steps = min(L, int((m + n).max())) if B else 0

    for s in range(steps):
        top = i <= 0
        left = j <= 0
        done = top & left
        at_top = top & ~left
        at_left = left & ~top
        if wave:
            row = (i + j - 1).clamp_min(0)
            w = i - offs[bidx, row]
        else:
            row = (i - 1).clamp_min(0)
            w = j - offs[bidx, row]
        in_band = (w >= 0) & (w < w_dim)
        byte = tb[bidx, row, w.clamp(0, w_dim - 1)]
        v = table[byte.to(i64) | (st << 8) | (piece << 10)]
        act = torch.where(at_top, 2, torch.where(at_left, 1, v & 3))
        new_st = torch.where(at_top, 2, torch.where(at_left, 1, v >> 3))
        piece = (v >> 2) & 1

        qb = q[bidx, (i - 1).clamp_min(0)]
        rb = r[bidx, (j - 1).clamp_min(0)]
        code = torch.where((act == 0) & (qb == rb) & (qb < 4), STEP_EQ, step_of_act[act])
        codes[:, s] = torch.where(done, STEP_DONE, code)
        err = err | (~top & ~left & ~in_band)

        live = (~done).to(i64)
        i = i - live * (act != 2)
        j = j - live * (act != 1)
        st = torch.where(done, st, new_st)
    err = err | (i > 0) | (j > 0)

    path_len = (codes != STEP_DONE).sum(dim=1).to(i32)
    quads = torch.where(codes == STEP_DONE, 0, codes).to(i32).view(B, L // 4, 4)
    packed = (quads[:, :, 0] | (quads[:, :, 1] << 2) | (quads[:, :, 2] << 4)
              | (quads[:, :, 3] << 6)).to(torch.uint8)
    pl_bytes = torch.stack([((path_len >> (8 * k)) & 0xff) for k in range(4)],
                           dim=1).to(torch.uint8)
    return torch.cat([packed, pl_bytes, err.to(torch.uint8)[:, None]], dim=1)
