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

# Chains a contig keeps, best first.
MAX_CHAINS = 2000


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


class ChainSet:
    """Chains as columns, sorted by score descending: chain i's anchors are
    ``qpos[off[i]:off[i+1]]`` and ``rpos[...]`` (ascending; a reverse
    chain's qpos in the strand-transformed frame), its chromosome, strand
    and score ``chrom[i]``, ``rev[i]``, ``score[i]`` (float64)."""

    __slots__ = ('off', 'qpos', 'rpos', 'chrom', 'rev', 'score')

    def __init__(self, off, qpos, rpos, chrom, rev, score):
        self.off, self.qpos, self.rpos = off, qpos, rpos
        self.chrom, self.rev, self.score = chrom, rev, score

    def __len__(self):
        return len(self.score)

    def chains(self):
        """The chains as ``Chain`` objects, in order."""
        off = self.off.tolist()
        return [Chain(c, r, self.qpos[a:b], self.rpos[a:b], s)
                for c, r, s, a, b in zip(self.chrom.tolist(), self.rev.tolist(),
                                         self.score.tolist(), off[:-1], off[1:])]


def _extract_chains(scores, parents, min_chain_score, min_anchors):
    """Greedy chain extraction from one slab's DP result: (idx, starts,
    own_scores), chain t's anchors slab-local ``idx[starts[t]:starts[t+1]]``
    (ascending), its own score float64. Only anchors that can seed an
    acceptable chain are visited (most anchors score ~k).
    """
    from ... import native

    n = len(scores)
    res = native.chain_select_extract(scores, parents, min_chain_score,
                                      min_anchors)
    if res is not None:
        idx_all, starts, own_scores = res
        return idx_all, starts, own_scores.astype(np.float64)

    paths, own = [], []
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
        paths.append(np.array(path, dtype=np.int64))
        own.append(own_score)
    starts = np.zeros(len(paths) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in paths], out=starts[1:])
    idx = np.concatenate(paths) if paths else np.zeros(0, dtype=np.int64)
    return idx, starts, np.array(own, dtype=np.float64)


def find_chains(qry_codes, index, max_occ=64, lookback=64, max_dist=50000,
                max_gap_diff=10000, min_chain_score=100, min_anchors=3,
                device=None, columns=False):
    """Seed and chain one contig.

    :param device: torch device of the chain scan when the native chain
        kernel is missing (the aligner's device).
    :param columns: return a ``ChainSet`` instead of ``Chain`` objects.

    :return: All chains above min_chain_score, sorted by score descending
        (at most ``MAX_CHAINS``). Primary selection is the caller's job (the
        aligner core runs a two-pass original-frame selection).
    """
    k = index.k
    qpos, rpos, group, chrom, rev = index.sorted_anchors(qry_codes, max_occ)
    n = len(qpos)

    from ... import native

    def chain_slab(lo, hi):
        """Chain DP + extraction over sorted anchors [lo, hi): (idx, starts,
        own scores), idx global."""
        with spans.span('chain.dp', anchors=hi - lo):
            scores, parents = chain_scores(
                qpos[lo:hi], rpos[lo:hi], group[lo:hi], k, lookback=lookback,
                max_dist=max_dist, max_gap_diff=max_gap_diff, device=device)
        with spans.span('chain.extract'):
            idx, starts, own = _extract_chains(scores, parents, min_chain_score,
                                               min_anchors)
            return idx + lo, starts, own

    # Chaining cannot cross a group change or an rpos gap > max_dist (rpos is
    # ascending within a group, so every pair spanning the gap fails the
    # dr <= max_dist test, and the lookback window sees only invalid
    # predecessors across a boundary either way). Splitting there gives exact,
    # independent subproblems -> thread-parallel over the sketch pool, the
    # calling thread running those no idle worker takes.
    if n == 0:
        parts = []
    elif n > 262144 and native.get_lib() is not None:
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
                                     zip(job_bounds[:-1], job_bounds[1:]),
                                     caller_runs=True))
    else:
        parts = [chain_slab(0, n)]

    # Slabs in order, then stably by score descending. Cap the candidate
    # pool: selection touches top chains only; deep repeat shadows never win
    # and cost O(chains) in selection.
    idx = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int64)
    lens = np.concatenate([np.diff(p[1]) for p in parts]) if parts else np.zeros(0, np.int64)
    score = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.float64)
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    order = np.argsort(-score, kind='stable')[:MAX_CHAINS]
    off = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(lens[order], out=off[1:])
    sel = idx[np.arange(off[-1], dtype=np.int64)
              + np.repeat(starts[order] - off[:-1], lens[order])]
    last = sel[off[1:] - 1]
    chains = ChainSet(off, qpos[sel], rpos[sel], np.asarray(chrom[last], dtype=np.int64),
                      np.asarray(rev[last], dtype=bool), score[order])
    return chains if columns else chains.chains()
