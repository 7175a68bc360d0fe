"""Anchor collection and chain extraction.

Seeds come from the minimizer index; the chain DP itself runs in the native
kernel behind pav_tpu_torch.ops.chain_scan, or in its scan on the aligner's
device when the native library is missing. This module owns the cheap, irregular host work:
strand transforms, grouping, backtracking parents into chains, and primary-chain
selection (the reference ran minimap2 with --secondary=no:
rules/align.snakefile:188).

Copy of pav_tpu.align.aligner.chain with its chain DP import switched to the
torch port (the reference module imports a jax scan).
"""

import time as _time

import numpy as np

from ...ops.chain_scan import chain_scores
from .index import minimizers_parallel

# Thread-time accumulators for the planning sub-phases (diagnostics only;
# summed across contig threads, so totals can exceed wall time). Guarded by a
# lock: the += read-modify-write is not atomic and updates from concurrent
# planning/pool threads would otherwise be lost (under-counted phase times).
import threading as _threading

CHAIN_STATS = {'minimizers_s': 0.0, 'anchors_s': 0.0, 'sort_s': 0.0,
               'dp_s': 0.0, 'extract_s': 0.0}
_STATS_LOCK = _threading.Lock()


def _stat_add(key, secs):
    with _STATS_LOCK:
        CHAIN_STATS[key] += secs


def chain_stats_reset():
    with _STATS_LOCK:
        for key in CHAIN_STATS:
            CHAIN_STATS[key] = 0.0


class Chain:
    __slots__ = ('chrom_id', 'is_rev', 'qpos', 'rpos', 'score', 'n_anchors',
                 'best_secondary')

    def __init__(self, chrom_id, is_rev, qpos, rpos, score):
        self.best_secondary = 0.0
        # Anchor positions ascending; for reverse-strand chains qpos is in the
        # strand-transformed frame q' = qlen - q - k.
        self.chrom_id = int(chrom_id)
        self.is_rev = bool(is_rev)
        self.qpos = qpos
        self.rpos = rpos
        self.score = float(score)
        self.n_anchors = len(qpos)

    def q_span(self):
        return int(self.qpos[0]), int(self.qpos[-1])


def collect_anchors(qry_codes, index, max_occ=64):
    """Minimizer anchors of one contig against the reference index.

    :return: (qpos, rpos, chrom, rev) int arrays; qpos strand-transformed for
        reverse hits so chains ascend in both coordinates.
    """
    k, w = index.k, index.w
    _t = _time.time()
    qpos, qhash, qstrand = minimizers_parallel(qry_codes, k, w)
    _stat_add('minimizers_s', _time.time() - _t)
    qlen = len(qry_codes)

    hi = getattr(index, '_hash_index', None)
    # The fused native path emits int32 anchor rows; scaffolds or contigs
    # past 2^31 take the int64 numpy path below.
    if (hi is not None
            and qlen < (1 << 31)
            and getattr(index, 'max_pos', 1 << 62) < (1 << 31)):
        # Fused native path: probe + strand transform + row assembly in one C
        # pass (skips four hit-sized numpy passes). Queries are independent ->
        # chunk-parallel over the sketch pool (the probe releases the GIL).
        def probe(sl):
            return hi.anchors(qhash[sl], qpos[sl], qstrand[sl], qlen, k,
                              max_occ, index.chrom_ids, index.positions,
                              index.strands)

        nq = len(qhash)
        if nq > 262144:
            from .index import _pool
            step = (nq + 3) // 4
            slices = [slice(i, min(i + step, nq)) for i in range(0, nq, step)]
            parts = list(_pool().map(probe, slices))
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(4))
        return probe(slice(None))

    q_idx, t_chrom, t_pos, t_strand = index.lookup(qhash, max_occ=max_occ)

    if len(q_idx) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.int32), np.zeros(0, dtype=bool)

    a_qpos = qpos[q_idx]
    rev = (qstrand[q_idx] != t_strand)
    a_qpos = np.where(rev, qlen - a_qpos - k, a_qpos)
    return a_qpos, t_pos, t_chrom, rev


def _extract_chains(scores, parents, qpos, rpos, chrom, rev, base,
                    min_chain_score, min_anchors):
    """Greedy chain extraction from one slab's DP result.

    scores/parents are slab-local (anchor i of the slab = global base + i);
    qpos/rpos/chrom/rev are the full sorted arrays. Only anchors that can seed
    an acceptable chain are visited (most anchors score ~k).
    """
    from ... import native

    chains = []
    n = len(scores)
    res = native.chain_select_extract(scores, parents, min_chain_score,
                                      min_anchors)
    if res is not None:
        idx_all, starts, own_scores = res
        if base:
            idx_all = idx_all + base
        for t in range(len(own_scores)):
            sl = idx_all[starts[t]:starts[t + 1]]
            i = int(sl[-1])
            chains.append(Chain(chrom[i], bool(rev[i]), qpos[sl], rpos[sl],
                                own_scores[t]))
        return chains

    cand = np.nonzero(scores >= min_chain_score)[0]
    cand = cand[np.argsort(-scores[cand], kind='stable')]
    used = np.zeros(n, dtype=bool)
    ptr = 0
    while ptr < len(cand):
        i = int(cand[ptr])
        ptr += 1
        if used[i]:
            continue
        path = []
        j = i
        while j >= 0 and not used[j]:
            path.append(j)
            used[j] = True
            j = int(parents[j])
        if len(path) > 10000:
            # A long extraction marks most remaining candidates used; drop
            # them in one vectorized pass instead of skipping one by one.
            rest = cand[ptr:]
            cand = rest[~used[rest]]
            ptr = 0
        if len(path) < min_anchors:
            continue
        # A path cut at an already-used anchor only contributes its own
        # score (f is cumulative; without this, branch shadows of a long
        # chain would inherit its full score and poison selection/MAPQ).
        own_score = float(scores[i]) - (float(scores[j]) if j >= 0 else 0.0)
        if own_score < min_chain_score:
            continue
        path.reverse()
        idx = np.array(path) + base
        chains.append(Chain(chrom[idx[-1]], bool(rev[idx[-1]]),
                            qpos[idx], rpos[idx], own_score))
    return chains


def find_chains(qry_codes, index, max_occ=64, lookback=64, max_dist=50000,
                max_gap_diff=10000, min_chain_score=100, min_anchors=3,
                device=None):
    """Seed and chain one contig.

    :param device: torch device of the chain scan when the native chain
        kernel is missing (the aligner's device).

    :return: List of all Chains above min_chain_score, sorted by score
        descending. Primary selection is the caller's job (the aligner core
        runs a two-pass original-frame selection).
    """
    k = index.k
    _t = _time.time()
    qpos, rpos, chrom, rev = collect_anchors(qry_codes, index, max_occ)
    _stat_add('anchors_s', _time.time() - _t)
    n = len(qpos)
    if n == 0:
        return []

    from ... import native
    _t = _time.time()
    res = native.sort_anchors(qpos, rpos, chrom, rev.astype(np.uint8))
    if res is not None:
        qpos, rpos, group, chrom, rev = res
    else:
        group = chrom.astype(np.int64) * 2 + rev.astype(np.int64)
        if (group.max() < (1 << 7) and rpos.max() < (1 << 28)
                and qpos.max() < (1 << 28)):
            # Composite u64 key: one argsort instead of three lexsort passes.
            key = ((group.astype(np.uint64) << np.uint64(56))
                   | (rpos.astype(np.uint64) << np.uint64(28))
                   | qpos.astype(np.uint64))
            order = np.argsort(key, kind='stable')
        else:
            order = np.lexsort((qpos, rpos, group))
        qpos, rpos, group, rev = (qpos[order], rpos[order], group[order],
                                  rev[order])
        chrom = chrom[order]
    _stat_add('sort_s', _time.time() - _t)

    def chain_slab(lo, hi):
        """Chain DP + extraction over sorted anchors [lo, hi)."""
        _t1 = _time.time()
        scores, parents = chain_scores(
            qpos[lo:hi], rpos[lo:hi], group[lo:hi], k, lookback=lookback,
            max_dist=max_dist, max_gap_diff=max_gap_diff, device=device)
        _stat_add('dp_s', _time.time() - _t1)
        _t1 = _time.time()
        out = _extract_chains(scores, parents, qpos, rpos, chrom, rev, lo,
                              min_chain_score, min_anchors)
        _stat_add('extract_s', _time.time() - _t1)
        return out

    # Chaining cannot cross a group change or an rpos gap > max_dist (rpos is
    # ascending within a group, so every pair spanning the gap fails the
    # dr <= max_dist test, and the lookback window sees only invalid
    # predecessors across a boundary either way). Splitting there gives exact,
    # independent subproblems -> thread-parallel over the sketch pool.
    if n > 262144 and native.get_lib() is not None:
        cut = np.nonzero((group[1:] != group[:-1])
                         | (rpos[1:] - rpos[:-1] > max_dist))[0] + 1
        bounds = np.concatenate([[0], cut, [n]])
        n_jobs = 4
        target = n / n_jobs
        job_bounds = [0]
        acc = 0
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            acc += int(b1 - b0)
            if acc >= target:
                job_bounds.append(int(b1))
                acc = 0
        if job_bounds[-1] != n:
            job_bounds.append(n)
        from .index import _pool
        parts = list(_pool().map(lambda b: chain_slab(*b),
                                 zip(job_bounds[:-1], job_bounds[1:])))
        chains = [c for part in parts for c in part]
    else:
        chains = chain_slab(0, n)

    chains.sort(key=lambda c: -c.score)
    # Cap the candidate pool: selection touches top chains only; deep repeat
    # shadows never win and cost O(chains) in selection.
    return chains[:2000]
