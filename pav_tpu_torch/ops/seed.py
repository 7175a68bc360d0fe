"""Minimizer seeding on a torch device: the sketch, the table's runs and a
contig's anchor rows, with their plain PyTorch versions.

Each wrapper sends a CPU tensor to the plain version beside it and a CUDA
tensor to its kernel in ``csrc/seed.cu``, or raises; it checks device,
dtype and shape first and counts its kernel launches in ``LAUNCHES``.

* ``sketch``  -> ``pav_seed_sketch``: the minimizers of a sequence, equal to
  ``index.minimizers`` (native/minimizer.cpp) bit for bit;
* ``runs``    -> ``pav_seed_runs``: the runs of a sorted key array (the
  ``np.unique`` of ``MinimizerIndex``);
* ``anchors`` -> ``pav_seed_probe`` and ``pav_seed_fill``: a contig's hits in
  the table as anchor rows, with native/lookup.cpp's repeat filter and
  strand transform.

Hashes travel as keys: the uint64 hash with its top bit flipped, read as
int64 (``to_hash`` reads them back), so that a signed sort or comparison orders
keys as unsigned hashes. ``sort_rows`` orders anchor rows by (group, rpos,
qpos) with two stable ``torch.sort`` passes on any device.
"""

import threading

import numpy as np
import torch

from .. import _build

LAUNCHES = {'sketch': 0, 'runs': 0, 'probe': 0, 'fill': 0}
_COUNT_LOCK = threading.Lock()

MAX_K = 31      # 2k bits of a k-mer in one 64-bit word (csrc/seed.cu kMaxK)
MAX_W = 64      # csrc/seed.cu kMaxW
_SIGN = -(1 << 63)
_INVALID_KEY = (1 << 63) - 1          # the hash ~0 as a key: never a minimizer
_POS_MASK = (1 << 31) - 1
_M1 = 0xFF51AFD7ED558CCD - (1 << 64)  # mix64's multipliers as int64
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)


def launches_reset():
    with _COUNT_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count(name, n=1):
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def to_hash(keys):
    """int64 keys (numpy) -> uint64 hashes."""
    return np.asarray(keys, dtype=np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def _check(name, t, dtype, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous 1-D {dtype} tensor, '
                         f'got {t.dtype} {tuple(t.shape)}')
    if device is not None and t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')


def _lib_for(dev):
    if dev.type != 'cuda':
        raise ValueError(f'no seeding kernel for device {dev}')
    return _build.lib()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _scanned(lib, tile_count):
    """(tile offsets int64 [T + 1], total) of per-tile counts."""
    dev = tile_count.device
    off = torch.empty(tile_count.numel() + 1, dtype=torch.int64, device=dev)
    _build.check(lib.pav_seed_scan(tile_count.data_ptr(), off.data_ptr(), tile_count.numel(),
                                   _stream(dev)), 'pav_seed_scan')
    return off, int(off[-1].item())


def _tiles(lib, n):
    tile = lib.pav_seed_tile()
    return (n + tile - 1) // tile


# ------------------------------------------------------------------ sketch

def _mix64_ref(x):
    """native/minimizer.cpp's mix64 on int64 tensors holding uint64 bits
    (products wrap; shifts are logical)."""
    for mult in (_M1, _M2, None):
        x = x ^ ((x >> 33) & ((1 << 31) - 1))
        if mult is not None:
            x = x * mult
    return x


def _sketch_ref(codes, k, w):
    """Plain ``sketch``: every k-mer start's key, the window minima and the
    largest minimum over the full windows covering each start."""
    dev = codes.device
    n_kmers = codes.numel() - k + 1
    if n_kmers < w:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int8, device=dev))
    c = codes.long()
    fwd = torch.zeros(n_kmers, dtype=torch.int64, device=dev)
    rc = torch.zeros(n_kmers, dtype=torch.int64, device=dev)
    ok = torch.ones(n_kmers, dtype=torch.bool, device=dev)
    for t in range(k):
        ct = c[t:t + n_kmers]
        ok &= ct < 4
        v = ct & 3
        fwd = (fwd << 2) | v
        rc |= (3 - v) << (2 * t)
    key = torch.where(ok, _mix64_ref(torch.minimum(fwd, rc)) ^ _SIGN, _INVALID_KEY)
    win_min = key.unfold(0, w, 1).min(dim=1).values
    pad = torch.full((w - 1,), -(1 << 63), dtype=torch.int64, device=dev)
    cover = torch.cat([pad, win_min, pad]).unfold(0, w, 1).max(dim=1).values
    pos = torch.nonzero((key == cover) & (key != _INVALID_KEY))[:, 0]
    return pos.int(), key[pos], (rc < fwd)[pos].to(torch.int8)


def sketch(codes, k, w):
    """Minimizers of one sequence of base codes (uint8 [n] tensor, n < 2^31):
    (pos int32, key int64, strand int8) in position order, equal to
    ``index.minimizers`` (its native sketcher)."""
    _check('codes', codes, torch.uint8)
    k, w = int(k), int(w)
    if not (1 <= k <= MAX_K and 1 <= w <= MAX_W):
        raise ValueError(f'k {k} and w {w} outside 1..{MAX_K} and 1..{MAX_W}')
    n = codes.numel()
    if n >= 1 << 31:
        raise ValueError(f'{n} bases: positions past int32')
    dev = codes.device
    if dev.type == 'cpu':
        return _sketch_ref(codes, k, w)
    lib = _lib_for(dev)
    n_kmers = n - k + 1
    if n_kmers < w:
        return _sketch_ref(codes[:0], k, w)
    stream = _stream(dev)
    with torch.cuda.device(dev):
        tile_count = torch.empty(_tiles(lib, n_kmers), dtype=torch.int64, device=dev)
        _build.check(lib.pav_seed_sketch(
            codes.data_ptr(), n, k, w, tile_count.data_ptr(), None, None, None, None, 0,
            stream), 'pav_seed_sketch')
        tile_off, total = _scanned(lib, tile_count)
        pos = torch.empty(total, dtype=torch.int32, device=dev)
        key = torch.empty(total, dtype=torch.int64, device=dev)
        strand = torch.empty(total, dtype=torch.int8, device=dev)
        if total:
            _build.check(lib.pav_seed_sketch(
                codes.data_ptr(), n, k, w, None, tile_off.data_ptr(), pos.data_ptr(),
                key.data_ptr(), strand.data_ptr(), 1, stream), 'pav_seed_sketch')
    _count('sketch', 2 if total else 1)
    return pos, key, strand


# -------------------------------------------------------------------- runs

def _runs_ref(keys):
    n = keys.numel()
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(first)[:, 0]
    return keys[starts], torch.cat([starts, starts.new_tensor([n])])


def runs(keys):
    """Runs of a sorted int64 key array: (uniq_keys int64 [U], uniq_starts
    int64 [U + 1]), each run's key and first index, then the array's
    length (a run's count is the difference of two starts)."""
    _check('keys', keys, torch.int64)
    dev = keys.device
    if dev.type == 'cpu':
        return _runs_ref(keys)
    lib = _lib_for(dev)
    n = keys.numel()
    stream = _stream(dev)
    with torch.cuda.device(dev):
        if n == 0:
            return keys.clone(), torch.zeros(1, dtype=torch.int64, device=dev)
        tile_count = torch.empty(_tiles(lib, n), dtype=torch.int64, device=dev)
        _build.check(lib.pav_seed_runs(
            keys.data_ptr(), n, tile_count.data_ptr(), None, None, None, 0, stream),
            'pav_seed_runs')
        tile_off, total = _scanned(lib, tile_count)
        uniq_keys = torch.empty(total, dtype=torch.int64, device=dev)
        uniq_starts = torch.full((total + 1,), n, dtype=torch.int64, device=dev)
        _build.check(lib.pav_seed_runs(
            keys.data_ptr(), n, None, tile_off.data_ptr(), uniq_keys.data_ptr(),
            uniq_starts.data_ptr(), 1, stream), 'pav_seed_runs')
    _count('runs', 2)
    return uniq_keys, uniq_starts


# ----------------------------------------------------------------- anchors

def _anchors_ref(qpos, qkey, qstrand, qlen, k, max_occ, table):
    uniq_keys, uniq_starts, idx_chrom, idx_pos, idx_strand = table
    dev = qkey.device
    if uniq_keys.numel() == 0 or qkey.numel() == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    slot = torch.searchsorted(uniq_keys, qkey).clamp(max=uniq_keys.numel() - 1)
    start = uniq_starts[slot]
    count = uniq_starts[slot + 1] - start
    count = torch.where((uniq_keys[slot] == qkey) & (count <= max_occ), count, 0)
    total = int(count.sum())
    qi = torch.repeat_interleave(torch.arange(qkey.numel(), device=dev), count)
    first = torch.cumsum(count, 0) - count
    flat = (torch.repeat_interleave(start, count)
            + torch.arange(total, device=dev) - torch.repeat_interleave(first, count))
    rev = idx_strand[flat] != qstrand[qi]
    q = qpos[qi].long()
    q = torch.where(rev, qlen - q - k, q).int()
    group = idx_chrom[flat].long() * 2 + rev.long()
    return q, (group << 31) | idx_pos[flat].long()


def anchors(qpos, qkey, qstrand, qlen, k, max_occ, table):
    """Anchor rows of a contig's minimizers (``sketch``'s outputs) against a
    table (uniq_keys, uniq_starts from ``runs``; idx_chrom int32, idx_pos
    int32, idx_strand int8 in key order), one row a hit of a key that occurs
    at most ``max_occ`` times, in query order, then table order:
    (q int32, key int64), q the query position (qlen - q - k where the
    strands differ), key = (chrom * 2 + rev) << 31 | rpos."""
    _check('qkey', qkey, torch.int64)
    dev = qkey.device
    _check('qpos', qpos, torch.int32, dev)
    _check('qstrand', qstrand, torch.int8, dev)
    for name, t, dtype in zip(('uniq_keys', 'uniq_starts', 'idx_chrom', 'idx_pos',
                               'idx_strand'), table,
                              (torch.int64, torch.int64, torch.int32, torch.int32,
                               torch.int8)):
        _check(name, t, dtype, dev)
    if not qpos.numel() == qkey.numel() == qstrand.numel():
        raise ValueError('qpos, qkey and qstrand differ in length')
    if dev.type == 'cpu':
        return _anchors_ref(qpos, qkey, qstrand, qlen, k, max_occ, table)
    uniq_keys, uniq_starts, idx_chrom, idx_pos, idx_strand = table
    lib = _lib_for(dev)
    nq = qkey.numel()
    if nq == 0 or uniq_keys.numel() == 0:
        return _anchors_ref(qpos[:0], qkey[:0], qstrand[:0], qlen, k, max_occ, table)
    stream = _stream(dev)
    with torch.cuda.device(dev):
        count = torch.empty(nq, dtype=torch.int32, device=dev)
        start = torch.empty(nq, dtype=torch.int64, device=dev)
        tile_count = torch.empty(_tiles(lib, nq), dtype=torch.int64, device=dev)
        _build.check(lib.pav_seed_probe(
            qkey.data_ptr(), nq, uniq_keys.data_ptr(), uniq_starts.data_ptr(),
            uniq_keys.numel(), int(max_occ), count.data_ptr(), start.data_ptr(),
            tile_count.data_ptr(), stream), 'pav_seed_probe')
        tile_off, total = _scanned(lib, tile_count)
        q = torch.empty(total, dtype=torch.int32, device=dev)
        key = torch.empty(total, dtype=torch.int64, device=dev)
        if total:
            _build.check(lib.pav_seed_fill(
                qpos.data_ptr(), qstrand.data_ptr(), count.data_ptr(), start.data_ptr(),
                nq, tile_off.data_ptr(), int(qlen), int(k), idx_chrom.data_ptr(),
                idx_pos.data_ptr(), idx_strand.data_ptr(), q.data_ptr(), key.data_ptr(),
                stream), 'pav_seed_fill')
    _count('probe')
    if total:
        _count('fill')
    return q, key


def sort_rows(q, key):
    """``anchors``' rows ordered by (group, rpos, qpos): int32 [4, A] of
    qpos, rpos, group and chrom (two stable sorts, qpos then key)."""
    q, order = torch.sort(q, stable=True)
    key, order2 = torch.sort(key[order], stable=True)
    group = (key >> 31).int()
    return torch.stack([q[order2], (key & _POS_MASK).int(), group, group >> 1])
