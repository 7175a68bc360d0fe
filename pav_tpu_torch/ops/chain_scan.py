"""Anchor chaining scores (port of pav_tpu.ops.chain_scan).

Minimap2-style chain DP: f[i] = max(k, max_j f[j] + match - gap_cost) over a
rolling lookback of anchors, never crossing groups (chrom x strand). The
recurrence is sequential and irregular: ``chain_scores`` runs the native
host kernel (native/chain.cpp via pav_tpu.native), as the reference's main
path does, and falls back to the scan on the caller's device when the
native library is missing: the anchors cut into exact independent pieces
(at a group change or an rpos gap > max_dist), packed in order into rows,
all rows one scan launch. ``chain_scores_batch`` runs a batch of
independent slabs as one scan, optionally split over a device mesh.

The scan (``_chain_scan_batch``) is ``csrc/chain_scan.cu`` for CUDA tensors
(replacing the XLA ``lax.scan`` of ``pav_tpu.ops.chain_scan._chain_scan``)
and ``_chain_scan_ref``, a loop over anchors of [B, lookback] tensor ops,
for CPU tensors. Both keep the reference's float32 arithmetic bit for bit:

* every score is float32, NEG is -1e18 rounded to float32;
* match = min(dq, dr, k); ilog = (bits(float32(dd + 1)) >> 23) - 127;
* gap_cost = gap_scale * dd + 0.5 * ilog with ONE rounding, a fused
  multiply-add: XLA on the CPU contracts it into an FMA and native/chain.cpp
  issues one (AVX-512 ``_mm512_fmadd_ps``), and the two differ from two
  roundings at some dd (for k = 19 at dd = 19, 31, 33, ...). The plain
  version takes the product and sum in float64, where both are exact for
  gap scales >= 2^-5 (the engine's are 0.01*k), and rounds once; the kernel
  calls ``__fmaf_rn``;
* cand = (f + match) - gap_cost; dq, dr <= max_dist and dd <= max_gap_diff
  compare in float32 (the limits are float scalars in the jitted scan);
* the argmax takes the first (oldest) maximum; a chain extends only when
  the best candidate beats k; padding anchors carry group -9.
"""

import threading

import numpy as np
import torch

from .. import native

from .. import _build
from ..parallel.mesh import on_device, place_batch

NEG = float(np.float32(-1e18))
PAD_GROUP = -9

LAUNCHES = {'chain_scan': 0}
# chain_scores' device fallback: calls, exact pieces, rows launched.
PIECES = {'calls': 0, 'pieces': 0, 'rows': 0}
_COUNT_LOCK = threading.Lock()
# Rows a fallback launch aims at (one warp each on the card): a row holds
# consecutive pieces up to max(longest piece, anchors / _ROWS_TARGET).
_ROWS_TARGET = 512


def launches_reset():
    with _COUNT_LOCK:
        LAUNCHES['chain_scan'] = 0
        for key in PIECES:
            PIECES[key] = 0


def _chain_scan_ref(qpos, rpos, group, lookback, k, max_dist, max_gap_diff,
                    gap_scale):
    """Plain version of ``_chain_scan_batch``: the reference's scan step,
    batched over slabs, one loop iteration per anchor. The lookback buffers
    are oldest-first, so ``argmax`` (first maximum) picks the oldest."""
    B, n = qpos.shape
    dev = qpos.device
    f32 = torch.float32
    i32 = torch.int32
    q_buf = torch.zeros((B, lookback), dtype=i32, device=dev)
    r_buf = torch.zeros((B, lookback), dtype=i32, device=dev)
    f_buf = torch.full((B, lookback), NEG, dtype=f32, device=dev)
    g_buf = torch.full((B, lookback), -1, dtype=i32, device=dev)
    i_buf = torch.full((B, lookback), -1, dtype=i32, device=dev)
    kf = torch.tensor(float(k), dtype=f32, device=dev)
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    mdist = torch.tensor(float(max_dist), dtype=f32, device=dev)
    mgap = torch.tensor(float(max_gap_diff), dtype=f32, device=dev)
    scale = torch.tensor(float(np.float32(gap_scale)), dtype=torch.float64,
                         device=dev)
    rows = torch.arange(B, device=dev)
    f_out = torch.empty((B, n), dtype=f32, device=dev)
    p_out = torch.empty((B, n), dtype=i32, device=dev)

    for i in range(n):
        q = qpos[:, i:i + 1]
        r = rpos[:, i:i + 1]
        g = group[:, i:i + 1]
        dq = q - q_buf
        dr = r - r_buf
        dd = (dr - dq).abs()
        match = torch.minimum(dq, dr).clamp_max(k).to(f32)
        fdd1 = (dd + 1).to(f32)
        ilog = (fdd1.view(i32) >> 23) - 127
        # One rounding of gap_scale*float32(dd) + 0.5*ilog (a fused
        # multiply-add): exact in float64 at the engine's gap scales.
        gap_cost = (scale * dd.to(f32).to(torch.float64)
                    + 0.5 * ilog.to(torch.float64)).to(f32)
        ok = ((g_buf == g) & (dq > 0) & (dr > 0)
              & (dq.to(f32) <= mdist) & (dr.to(f32) <= mdist)
              & (dd.to(f32) <= mgap))
        cand = torch.where(ok, (f_buf + match) - gap_cost, neg)
        best = torch.argmax(cand, dim=1)
        best_score = cand[rows, best]
        use = best_score > kf
        f = torch.where(use, best_score, kf)
        parent = torch.where(use, i_buf[rows, best], -1)
        f_out[:, i] = f
        p_out[:, i] = parent

        q_buf = torch.cat([q_buf[:, 1:], q], dim=1)
        r_buf = torch.cat([r_buf[:, 1:], r], dim=1)
        f_buf = torch.cat([f_buf[:, 1:], f[:, None]], dim=1)
        g_buf = torch.cat([g_buf[:, 1:], g], dim=1)
        i_buf = torch.cat([i_buf[:, 1:], torch.full_like(g, i)], dim=1)
    return f_out, p_out


def _chain_scan_batch(qpos, rpos, group, lookback, k, max_dist, max_gap_diff,
                      gap_scale):
    """Chain DP over a [B, n] slab batch of int32 positions and groups:
    (f float32 [B, n], parent int32 [B, n], slab-local, -1 = chain start).
    CPU tensors take ``_chain_scan_ref``; CUDA tensors ``csrc/chain_scan.cu``
    (one warp per slab), or raise."""
    for name, t in (('qpos', qpos), ('rpos', rpos), ('group', group)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name}: expected a tensor, got {type(t).__name__}')
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous int32 [B, n] tensor')
        if t.shape != qpos.shape or t.device != qpos.device:
            raise ValueError(f'{name} is {tuple(t.shape)} on {t.device}, expected '
                             f'{tuple(qpos.shape)} on {qpos.device}')
    lookback, k = int(lookback), int(k)
    if not 1 <= lookback <= 64:
        raise ValueError(f'lookback {lookback} outside 1..64 (the kernel keeps '
                         'two slots per lane of one warp)')
    dev = qpos.device
    if dev.type == 'cpu':
        return _chain_scan_ref(qpos, rpos, group, lookback, k, max_dist,
                               max_gap_diff, gap_scale)
    if dev.type != 'cuda':
        raise ValueError(f'no chain scan kernel for device {dev}')
    B, n = qpos.shape
    lib = _build.lib()
    f = torch.empty((B, n), dtype=torch.float32, device=dev)
    parent = torch.empty((B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.pav_chain_scan(
            qpos.data_ptr(), rpos.data_ptr(), group.data_ptr(),
            f.data_ptr(), parent.data_ptr(), B, n, lookback, k,
            float(max_dist), float(max_gap_diff), float(gap_scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, 'pav_chain_scan')
    with _COUNT_LOCK:
        LAUNCHES['chain_scan'] += 1
    return f, parent


def _chain_scan(qpos, rpos, group, lookback, k, max_dist, max_gap_diff,
                gap_scale):
    """One slab: int32 [n] tensors -> (f float32 [n], parent int32 [n])."""
    f, parent = _chain_scan_batch(qpos[None], rpos[None], group[None],
                                  lookback, k, max_dist, max_gap_diff,
                                  gap_scale)
    return f[0], parent[0]


def _padded_slabs(slabs):
    """int32 [B, n_pad] positions and groups (n_pad the next power of two of
    the longest slab; padding anchors group -9), and the slab lengths."""
    lens = [len(s[0]) for s in slabs]
    n_pad = 1
    while n_pad < max(lens):
        n_pad <<= 1
    B = len(slabs)
    qp = np.zeros((B, n_pad), dtype=np.int32)
    rp = np.zeros((B, n_pad), dtype=np.int32)
    gp = np.full((B, n_pad), PAD_GROUP, dtype=np.int32)
    for i, (q, r, g) in enumerate(slabs):
        qp[i, :lens[i]] = q
        rp[i, :lens[i]] = r
        gp[i, :lens[i]] = g
    return qp, rp, gp, lens


def chain_scores_batch(slabs, k, lookback=64, max_dist=50000,
                       max_gap_diff=10000, gap_scale=None, mesh=None,
                       device=None):
    """Chain DP over a list of (qpos, rpos, group) slabs in one scan.

    :param mesh: optional list of devices (``parallel.mesh``); when it
        divides the slab count, the batch splits into equal row shards, one
        scan per mesh device. Otherwise the scan runs on ``device``.
    :return: list of (scores float32, parents int64) per slab, parents local
        to the slab (-1 = chain start), identical to per-slab chain_scores.
    """
    if gap_scale is None:
        gap_scale = 0.01 * k
    if not slabs:
        return []
    qp, rp, gp, lens = _padded_slabs(slabs)
    placed = place_batch([torch.from_numpy(a) for a in (qp, rp, gp)], mesh, device)
    outs = []
    for dev, (q, r, g) in placed:       # launch every shard, then collect
        with on_device(dev):
            outs.append(_chain_scan_batch(q, r, g, lookback, k, max_dist,
                                          max_gap_diff, gap_scale))
    f_np = torch.cat([f.cpu() for f, _ in outs]).numpy()
    p_np = torch.cat([p.cpu() for _, p in outs]).numpy()
    return [(f_np[i, :lens[i]], p_np[i, :lens[i]].astype(np.int64))
            for i in range(len(slabs))]


def chain_scores(qpos, rpos, group, k, lookback=64, max_dist=50000,
                 max_gap_diff=10000, gap_scale=None, device=None):
    """Chain DP scores and parent pointers for sorted anchors.

    :param qpos: int64 query positions (strand-transformed, ascending within
        each (group, rpos) sort).
    :param rpos: int64 reference positions.
    :param group: int64 group ids (chrom x strand); chaining never crosses groups.
    :param k: anchor (k-mer) length.
    :param device: where the scan runs when the native kernel is missing
        (the aligner's device).

    :return: (scores float32, parents int64) numpy arrays; parent -1 = chain start.
    :raises RuntimeError: no native kernel and no device for the scan.
    """
    if gap_scale is None:
        gap_scale = 0.01 * k
    if len(qpos) == 0:
        return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)
    res = native.chain_dp(qpos, rpos, group, k, lookback,
                          max_dist, max_gap_diff, gap_scale)
    if res is not None:
        return res
    if device is None:
        raise RuntimeError('native chain kernel unavailable (g++ build of '
                           'native/*.cpp failed) and no device for the scan')
    starts, pieces = _piece_rows(rpos, group, max_dist)
    ends = starts[1:] + [len(qpos)]
    outs = chain_scores_batch([(qpos[a:b], rpos[a:b], group[a:b])
                               for a, b in zip(starts, ends)],
                              k, lookback, max_dist, max_gap_diff, gap_scale,
                              device=device)
    with _COUNT_LOCK:
        PIECES['calls'] += 1
        PIECES['pieces'] += pieces
        PIECES['rows'] += len(starts)
    scores = np.concatenate([f for f, _ in outs])
    parents = np.concatenate([np.where(p >= 0, p + a, -1)
                              for a, (_, p) in zip(starts, outs)])
    return scores, parents


def _piece_rows(rpos, group, max_dist):
    """Cut sorted anchors into exact independent pieces and pack them, in
    order, into rows: (row starts, piece count).

    No chain crosses a group change or an rpos gap > max_dist: rpos ascends
    within a group (anchors sort by group, rpos, qpos), so every pair across
    such a gap fails dr <= max_dist, and a scan that starts at a cut sees
    only invalid predecessors either way. A row takes consecutive pieces up
    to max(longest piece, anchors / _ROWS_TARGET), so the padded batch stays
    within a few times the anchors."""
    n = len(rpos)
    cut = np.nonzero((np.asarray(group[1:]) != np.asarray(group[:-1]))
                     | (np.diff(np.asarray(rpos, dtype=np.int64)) > max_dist))[0] + 1
    bounds = np.concatenate([[0], cut, [n]]).astype(np.int64)
    target = max(int(np.diff(bounds).max()), -(-n // _ROWS_TARGET))
    starts = [0]
    for b0, b1 in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if b1 - starts[-1] > target and b0 > starts[-1]:
            starts.append(b0)
    return starts, len(bounds) - 1
