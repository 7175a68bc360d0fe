"""Anchor chaining scores (port of pav_tpu.ops.chain_scan.chain_scores).

Minimap2-style chain DP: f[i] = max(k, max_j f[j] + match - gap_cost) over a
rolling lookback of anchors, never crossing groups (chrom x strand). The
recurrence is sequential and irregular; it runs in the native host kernel
(native/chain.cpp via pav_tpu.native), as it does on the reference's main
path. The device scan of the reference (``_chain_scan``) is still to port.
"""

import numpy as np

from pav_tpu import native


def chain_scores(qpos, rpos, group, k, lookback=64, max_dist=50000,
                 max_gap_diff=10000, gap_scale=None):
    """Chain DP scores and parent pointers for sorted anchors.

    :param qpos: int64 query positions (strand-transformed, ascending within
        each (group, rpos) sort).
    :param rpos: int64 reference positions.
    :param group: int64 group ids (chrom x strand); chaining never crosses groups.
    :param k: anchor (k-mer) length.

    :return: (scores float32, parents int64) numpy arrays; parent -1 = chain start.
    :raises RuntimeError: the native library could not be built or loaded.
    """
    if gap_scale is None:
        gap_scale = 0.01 * k
    if len(qpos) == 0:
        return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)
    res = native.chain_dp(qpos, rpos, group, k, lookback,
                          max_dist, max_gap_diff, gap_scale)
    if res is None:
        raise RuntimeError('native chain kernel unavailable (g++ build of '
                           'native/*.cpp failed); the torch port has no '
                           'device chain scan yet')
    return res
