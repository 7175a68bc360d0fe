"""Anchor collection and chain extraction.

Seeds come from the minimizer index (``index.sorted_anchors``: on the host,
or on the device of a ``DeviceMinimizerIndex``). The chain DP itself runs
in the native
kernel behind pav_tpu_torch.ops.chain_scan, or in its scan on the aligner's
device when the native library is missing. This module owns the cheap, irregular host work:
strand transforms, grouping, backtracking parents into chains, and primary-chain
selection (the reference ran minimap2 with --secondary=no:
rules/align.snakefile:188).

Port of pav_tpu.align.aligner.chain with its chain DP import switched to the
torch port (the reference module imports a jax scan) and its seeding
(``collect_anchors`` and the anchor sort) moved to the index.
"""

import numpy as np

from ... import spans
from ...ops.chain_scan import chain_scores
from .index import SKETCH_POOL, collect_anchors  # noqa: F401 (pav_tpu's chain has it)


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
    qpos, rpos, group, chrom, rev = index.sorted_anchors(qry_codes, max_occ)
    n = len(qpos)
    if n == 0:
        return []

    from ... import native

    def chain_slab(lo, hi):
        """Chain DP + extraction over sorted anchors [lo, hi)."""
        with spans.span('chain.dp', anchors=hi - lo):
            scores, parents = chain_scores(
                qpos[lo:hi], rpos[lo:hi], group[lo:hi], k, lookback=lookback,
                max_dist=max_dist, max_gap_diff=max_gap_diff, device=device)
        with spans.span('chain.extract'):
            return _extract_chains(scores, parents, qpos, rpos, chrom, rev, lo,
                                   min_chain_score, min_anchors)

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
        parts = list(SKETCH_POOL.map(lambda b: chain_slab(*b),
                                     zip(job_bounds[:-1], job_bounds[1:])))
        chains = [c for part in parts for c in part]
    else:
        chains = chain_slab(0, n)

    chains.sort(key=lambda c: -c.score)
    # Cap the candidate pool: selection touches top chains only; deep repeat
    # shadows never win and cost O(chains) in selection.
    return chains[:2000]
