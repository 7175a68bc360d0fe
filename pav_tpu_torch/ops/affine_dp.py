"""Batched global alignment with two-piece affine gaps (port of
pav_tpu.ops.affine_dp).

All inter-anchor gap segments are bucketed by size into padded classes and
aligned in one launch per batch: a DP kernel writes one traceback byte per
cell (layout below), the traceback kernel walks each item's tape into a
compact 2-bit step tape, and one buffer per launch returns to the host.
Full-width classes run ``dp_kernels.align_full`` (rows). Banded classes run
``dp_kernels.align_wave`` (anti-diagonals), as the reference does on an
accelerator, or, on the CPU ladder, ``dp_kernels.align_band`` (row
windows), as the reference does on its CPU backend. The kernels are CUDA for
CUDA tensors and their plain versions for CPU tensors (``dp_kernels``).

Scoring follows the reference's minimap2 parameterization (match 1, mismatch
-5, gaps min(5+4g, 56+g)); scores are int32 throughout.

Traceback byte layout (bit set =>):
  0: Htilde chose E (diagonal otherwise)
  1: H chose F (overrides bit 0)
  2: E piece-2 strictly better than piece-1
  3: F piece-2 strictly better than piece-1
  4: E1 extended (came from E1 above, not opened from H above)
  5: E2 extended
  6: F1 opened at the immediate left cell (gap length 1 from there)
  7: F2 opened at the immediate left cell
"""

import threading

import numpy as np
import torch

from .. import spans
from ..align import cigar as cg

from ..device import resolve_device
from ..parallel.mesh import on_device, place_batch
from . import dp_kernels

# Per-run launch accounting (reset with stats_reset).
# Mesh accounting, as the reference keeps it: sharded_puts counts the input
# arrays split over a mesh, mesh_devices is the mesh size, shard_rows the
# per-device rows of the latest sharded launch, and shard_cells the padded
# DP cells (rows * max_m * width) accumulated per mesh device over every
# sharded launch: max/min of shard_cells is the measured work balance.
# classes: (max_m, max_n, width, B_pad) ->
#   [launches, resolve_s, items, cells_pad, cells_real, path_sum, path_max]
# cells_pad  = B_pad*max_m*width per launch (what the kernels scan)
# cells_real = sum_i m_i*min(n_i+1, width)  (what the problems need)
# path_sum, path_max = sum and maximum of the items' traceback path lengths
#   (the walker's steps; padding rows excluded)
# gather_flags: the windows of resident launches (a real item's q and r
#   window each) by gather flags 0-3 (_gather_resident: 1 reversed,
#   2 complemented, 3 both)
STATS = {'launches': 0, 'items': 0, 'resolve_s': 0.0,
         'sharded_puts': 0, 'mesh_devices': 0, 'shard_rows': (),
         'shard_cells': (), 'classes': {}, 'gather_flags': (0, 0, 0, 0)}
_STATS_LOCK = threading.Lock()


def stats_reset():
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = ({} if k == 'classes'
                        else () if k in ('shard_rows', 'shard_cells')
                        else (0, 0, 0, 0) if k == 'gather_flags'
                        else (0.0 if k.endswith('_s') else 0))


DEFAULT_SCORING = {
    'match': 1, 'mismatch': -5,
    'gap_open': (5, 56), 'gap_ext': (4, 1),
}


def scoring_from_reference(d=None):
    """Validated, normalised scoring dict from a pav_tpu scoring dict
    (missing keys take DEFAULT_SCORING). Substitution scores must fit the
    int8 range of the reference's substitution rows with -128 free as its
    sentinel: |match|, |mismatch| <= 127."""
    sc = dict(DEFAULT_SCORING, **(d or {}))
    match, mismatch = int(sc['match']), int(sc['mismatch'])
    gap_open = tuple(int(v) for v in sc['gap_open'])
    gap_ext = tuple(int(v) for v in sc['gap_ext'])
    if len(gap_open) != 2 or len(gap_ext) != 2:
        raise ValueError('gap_open and gap_ext are pairs (two-piece affine gaps)')
    if abs(match) > 127 or abs(mismatch) > 127:
        raise ValueError(f'substitution scores out of range (|match|, '
                         f'|mismatch| <= 127): match={match} mismatch={mismatch}')
    return {'match': match, 'mismatch': mismatch,
            'gap_open': gap_open, 'gap_ext': gap_ext}


def _scoring_tuple(sc):
    return (sc['match'], sc['mismatch'], sc['gap_open'][0], sc['gap_open'][1],
            sc['gap_ext'][0], sc['gap_ext'][1])


def _next_pow2(x):
    v = 1
    while v < x:
        v <<= 1
    return v


def gap_cost(g, scoring=DEFAULT_SCORING):
    """Two-piece affine gap cost (positive number)."""
    o1, o2 = scoring['gap_open']
    e1, e2 = scoring['gap_ext']
    return np.minimum(o1 + g * e1, o2 + g * e2)


def _wave_width(width):
    """i-space band width of the wavefront kernel for a row band of
    ``width``: launches are transposed so m <= n per item, so width/2 lanes
    cover the row band's paths (+ rounding slop), rounded up to 128 so that
    tapes match the reference's bit for bit."""
    return ((width // 2 + 8 + 127) // 128) * 128


def _wave_geometry(m, n, max_m, max_n, D, Ww):
    """Per-item wavefront band placement doffs int32 [B, D] for int32 [B]
    lengths m, n: diagonal d = k+1 holds i = doffs[:, k] + lane. The
    reference computes d*m in int32; the product wraps here the same way."""
    d = torch.arange(1, D + 1, dtype=torch.int64, device=m.device)[None, :]
    mi = m.to(torch.int64)[:, None]
    ni = n.to(torch.int64)[:, None]
    tot = torch.clamp(mi + ni, min=1)
    prod = (d * mi + (1 << 31)) % (1 << 32) - (1 << 31)
    c = torch.div(prod, tot, rounding_mode='floor')
    lo = torch.clamp(d - ni, min=0)
    hi = torch.clamp(mi + 1 - Ww, min=0)
    doffs = torch.maximum(lo, torch.minimum(c - Ww // 2, hi))
    return doffs.to(torch.int32).contiguous()


def align_and_trace(q, r, m, n, max_m, width, scoring, band='wave'):
    """DP + traceback for one padded batch: fused uint8 [B, L/4 + 5] (2-bit
    step codes, reversed path; 4-byte LE path length; band-exit err byte).

    :param q: int8 [B, max_m]; r: int8 [B, max_n]; m, n: int32 [B].
    :param width: band width; ``max_n + 1`` runs full width, anything
        narrower a band of the kind ``band`` names.
    :param band: ``'wave'``, the wavefront band of ``_wave_width(width)``
        lanes (the accelerator ladder), or ``'row'``, the row band of
        ``width`` columns (the CPU ladder; its tapes are walked on the CPU
        only).
    """
    max_n = r.shape[1]
    if q.shape[1] != max_m:
        raise ValueError(f'q has {q.shape[1]} columns, expected max_m={max_m}')
    sc = _scoring_tuple(scoring)
    if width == max_n + 1:
        tb, offs = dp_kernels.align_full(q, r, m, n, sc)
        wave = False
    elif 0 < width < max_n + 1 and band == 'row':
        _, tb, offs = dp_kernels.align_band(q, r, m, n, width, sc)
        wave = False
    elif 0 < width < max_n + 1:
        if band != 'wave':
            raise ValueError(f"band {band!r} is neither 'wave' nor 'row'")
        ww = _wave_width(width)
        offs = _wave_geometry(m, n, max_m, max_n, max_m + max_n, ww)
        tb = dp_kernels.align_wave(q, r, m, n, offs, ww, sc)
        wave = True
    else:
        raise ValueError(f'width {width} outside 1..max_n+1={max_n + 1}')
    return dp_kernels.traceback(tb, offs, q, r, m, n, wave)


def _gather_resident(resident, desc, max_m, max_n):
    """Gather padded q/r windows from the resident int8 buffer by
    (qoff, qlen, qflags, roff, rlen, rflags) rows of ``desc`` [B, 6] int32.
    flags bit0 reads the window reversed, bit1 complements ACGT (3 - code);
    positions past each window read 4. Returns (q, r, m, n)."""
    L = resident.shape[0]

    def gather(off, ln, flags, max_len):
        idx = torch.arange(max_len, dtype=torch.int64, device=resident.device)[None, :]
        off = off.to(torch.int64)[:, None]
        ln = ln.to(torch.int64)[:, None]
        flags = flags[:, None]
        pos = torch.where((flags & 1) == 1, off + ln - 1 - idx, off + idx)
        v = resident[pos.clamp(0, L - 1)]
        v = torch.where(((flags & 2) == 2) & (v < 4), 3 - v, v)
        return torch.where(idx < ln, v, 4).to(torch.int8).contiguous()

    q = gather(desc[:, 0], desc[:, 1], desc[:, 2], max_m)
    r = gather(desc[:, 3], desc[:, 4], desc[:, 5], max_n)
    return q, r, desc[:, 1].contiguous(), desc[:, 4].contiguous()


class BandedAligner:
    """Host-facing wrapper: pad/bucket segments, launch DP + traceback on
    ``device``, turn the step tapes into CIGARs.

    With a ``mesh`` (``parallel.mesh``), a launch whose padded batch divides
    by the mesh size splits into equal row shards, one per mesh device; each
    shard runs DP and traceback on its own device's current stream and
    copies its rows back on its own. Items are independent, so the rows are
    those of the unsharded launch. Other launches stay on ``device``, as in
    the reference.
    """

    def __init__(self, scoring=None, device=None, mesh=None):
        self.scoring = scoring_from_reference(scoring)
        self.device = resolve_device(device)
        self.mesh = [resolve_device(d) for d in mesh] if mesh else None

    @property
    def devices(self):
        """Distinct devices a launch may run on: ``device``, then the mesh's."""
        out = [self.device]
        for d in self.mesh or ():
            if d not in out:
                out.append(d)
        return out

    def _place(self, host, B_pad, max_m, width):
        """[(device, [tensor per host array])], one entry per launch: one per
        mesh device when the mesh divides ``B_pad`` (the reference's
        condition), else one on ``device``. Records the mesh statistics."""
        mesh = self.mesh
        placed = place_batch(host, mesh, self.device)
        if mesh is None or B_pad % len(mesh):
            return placed
        rows = B_pad // len(mesh)
        with _STATS_LOCK:
            STATS['sharded_puts'] += len(host)
            STATS['mesh_devices'] = len(mesh)
            STATS['shard_rows'] = (rows,) * len(mesh)
            cur = STATS['shard_cells']
            if len(cur) != len(mesh):
                cur = (0,) * len(mesh)
            STATS['shard_cells'] = tuple(c + rows * max_m * width for c in cur)
        return placed

    def align_batch(self, pairs, width, pad_to=None, band='wave'):
        """Align a list of (q_codes, r_codes) with one bucket shape.

        :return: list of (lens, ops) CIGAR arrays (I = query-consuming gap,
            D = ref-consuming gap, =/X matches).
        """
        return self.align_batch_async(pairs, width, pad_to=pad_to, band=band)()

    def align_batch_async(self, pairs, width, pad_to=None, pad_batch=None,
                          band='wave'):
        """Launch the batch and return a no-arg callable that waits for the
        step tapes and yields the CIGAR list (launch every bucket first,
        then resolve). ``band``: the kind of a banded class
        (``align_and_trace``)."""
        B = len(pairs)
        m = np.array([len(q) for q, _ in pairs], dtype=np.int32)
        n = np.array([len(r) for _, r in pairs], dtype=np.int32)
        max_m = int(m.max()) if B else 0
        max_n = int(n.max()) if B else 0
        if max_m == 0:
            result = [_pure_gap(len(r), 'D') for _, r in pairs]
            return lambda: result

        if pad_batch:
            B_pad = int(pad_batch)
        else:
            B_pad = 8
            while B_pad < B:
                B_pad *= 4
        if isinstance(pad_to, tuple):
            max_m, max_n = int(pad_to[0]), int(pad_to[1])
        elif pad_to is not None:
            max_m = max_n = int(pad_to)
        else:
            max_m = max(_next_pow2(max_m), 8)
            max_n = max(_next_pow2(max(max_n, 1)), 8)
        width = min(_next_pow2(int(width)) + 1, max_n + 1)

        m_p = np.concatenate([m, np.ones(B_pad - B, dtype=np.int32)])
        n_p = np.concatenate([n, np.ones(B_pad - B, dtype=np.int32)])
        qpad = np.full((B_pad, max_m), 4, dtype=np.int8)
        rpad = np.full((B_pad, max_n), 4, dtype=np.int8)
        for i, (qq, rr) in enumerate(pairs):
            qpad[i, :len(qq)] = qq
            rpad[i, :len(rr)] = rr

        fused = []
        host = [torch.from_numpy(a) for a in (qpad, rpad, m_p, n_p)]
        with spans.span('dp.launch', items=B, cells=B_pad * max_m * width):
            for dev, (q, r, mt, nt) in self._place(host, B_pad, max_m, width):
                with on_device(dev):
                    fused.append(align_and_trace(q, r, mt, nt, max_m, width,
                                                 self.scoring, band))
        with _STATS_LOCK:
            STATS['launches'] += 1
            STATS['items'] += B
        cells_real = int(np.sum(m.astype(np.int64) * np.minimum(n + 1, width)))
        return self._finish(fused, B, B_pad, max_m, max_n, width,
                            cells_real=cells_real)

    def align_batch_refs_async(self, items, width, pad_to, pad_batch=None,
                               resident=None, band='wave'):
        """Resident launch: like align_batch_async, but each item is a
        (qoff, qlen, qflags, roff, rlen, rflags) window into ``resident``,
        gathered on the device: a list of such tuples, or one [B, 6] integer
        array of them. flags bit0 reads the window reversed, bit1
        complements; together they express reverse-complement windows.

        :param resident: {torch.device: int8 tensor} from
            core._build_resident_from, one copy of the buffer on each of
            ``self.devices``; each launch gathers from its own device's copy.
        """
        B = len(items)
        max_m, max_n = int(pad_to[0]), int(pad_to[1])
        width = min(_next_pow2(int(width)) + 1, max_n + 1)
        B_pad = int(pad_batch) if pad_batch else max(8, _next_pow2(B))

        arr = np.zeros((B_pad, 6), dtype=np.int32)
        if B:
            arr[:B] = np.asarray(items, dtype=np.int32)
        arr[B:, 1] = 1   # padding items: 1-base windows
        arr[B:, 4] = 1

        fused = []
        with spans.span('dp.launch', items=B, cells=B_pad * max_m * width):
            for dev, (desc,) in self._place([torch.from_numpy(arr)], B_pad,
                                            max_m, width):
                with on_device(dev):
                    q, r, m, n = _gather_resident(resident[dev], desc, max_m, max_n)
                    fused.append(align_and_trace(q, r, m, n, max_m, width,
                                                 self.scoring, band))
        flags = np.bincount(arr[:B, [2, 5]].ravel(), minlength=4)
        with _STATS_LOCK:
            STATS['launches'] += 1
            STATS['items'] += B
            STATS['gather_flags'] = tuple(
                int(a + b) for a, b in zip(STATS['gather_flags'], flags))
        cells_real = int(np.sum(
            arr[:B, 1].astype(np.int64)
            * np.minimum(arr[:B, 4].astype(np.int64) + 1, width)))
        return self._finish(fused, B, B_pad, max_m, max_n, width,
                            cells_real=cells_real)

    def _finish(self, fused, B, B_pad, max_m, max_n, width, cells_real=0):
        """Start the copy of the launch's B real rows to the host (each
        shard of ``fused``, in row order, from its own device) and return
        the resolver that waits for it and decodes the CIGARs."""
        rows = fused[0].shape[0]
        events = []
        if fused[0].device.type == 'cuda':
            host = torch.empty((B, fused[0].shape[1]), dtype=torch.uint8,
                               pin_memory=True)
            for i, part in enumerate(fused):
                lo = i * rows
                hi = min(B, lo + rows)
                if hi <= lo:
                    break
                host[lo:hi].copy_(part[:hi - lo], non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(part.device))
                events.append(done)
        else:
            host = (fused[0] if len(fused) == 1 else torch.cat(fused))[:B]

        def resolve():
            with spans.span('dp.resolve', items=B, cells=B_pad * max_m * width) as wait:
                for done in events:
                    done.synchronize()
                buf = host.numpy()
            dt = wait.seconds
            pk = buf[:, :-5]
            pl = (buf[:, -5:-1].astype(np.int32)
                  << np.arange(4, dtype=np.int32) * 8).sum(axis=1)
            with _STATS_LOCK:
                STATS['resolve_s'] += dt
                cls = STATS['classes'].setdefault(
                    (max_m, max_n, width, B_pad), [0, 0.0, 0, 0, 0, 0, 0])
                cls[0] += 1
                cls[1] += dt
                cls[2] += B
                cls[3] += B_pad * max_m * width
                cls[4] += cells_real
                cls[5] += int(pl.sum(dtype=np.int64))
                cls[6] = max(cls[6], int(pl.max(initial=0)))
            er = buf[:, -1]
            if er.any() and width >= max_n + 1:
                raise RuntimeError('Traceback failed at full width (program bug)')
            # Band-too-narrow items resolve to None; the caller re-runs just
            # those at full width.
            return [None if er[i] else packed_steps_to_cigar(pk[i], int(pl[i]))
                    for i in range(B)]

        return resolve


_UNPACK_LUT = None


def packed_steps_to_cigar(packed_row, path_len):
    """2-bit packed device step tape (reversed path) -> (lens, ops)."""
    global _UNPACK_LUT

    if path_len == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int8)
    if _UNPACK_LUT is None:
        lut = np.empty((256, 4), dtype=np.uint8)
        for b in range(256):
            lut[b] = [(b >> (2 * i)) & 3 for i in range(4)]
        _UNPACK_LUT = lut

    codes = _UNPACK_LUT[packed_row].reshape(-1)[:path_len][::-1]
    op_map = np.array([cg.EQ, cg.X, cg.I, cg.D], dtype=np.int8)
    ops_full = op_map[codes]
    boundary = np.concatenate([[True], ops_full[1:] != ops_full[:-1]])
    starts = np.nonzero(boundary)[0]
    ends = np.concatenate([starts[1:], [len(ops_full)]])
    return (ends - starts).astype(np.int32), ops_full[boundary]


def _pure_gap(length, op_char):
    if length == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int8)
    op = cg.I if op_char == 'I' else cg.D
    return np.array([length], dtype=np.int32), np.array([op], dtype=np.int8)
