"""Breakpoint-homology and tandem-repeat left-shift kernels, batched.

Semantics match the reference's scalar walkers (pavlib/call.py:542-647):
perfect-homology run length immediately up/downstream of an SV, circularly
indexing through the SV sequence (tandem-repeat aware), stopping at ambiguous
bases and sequence edges. Here whole batches of variants are resolved at once
with numpy gathers over widening windows — the same data-parallel shape used by
the device path.
"""

import numpy as np

_INIT_WINDOW = 64
_MAX_WINDOW = 1 << 22  # 4 Mbp homology cap (far beyond biological signal)


def _homology_batch(pos, seq, sv_arena, sv_off, sv_len, direction):
    """Vectorized homology for a batch of variants against one sequence.

    :param pos: int64 array; for 'left', position of the first base upstream of
        the SV (search moves down); for 'right', first base downstream (moves up).
    :param seq: uint8 code array (the contig/reference in SV orientation).
    :param sv_arena: uint8 code arena holding all SV sequences concatenated.
    :param sv_off: int64 array of SV sequence offsets into the arena.
    :param sv_len: int64 array of SV sequence lengths (>0).

    :return: int64 array of homology lengths.
    """
    n = len(pos)
    if n == 0:
        return np.zeros(0, dtype=np.int64)

    pos = np.asarray(pos, dtype=np.int64)
    sv_off = np.asarray(sv_off, dtype=np.int64)
    sv_len = np.asarray(sv_len, dtype=np.int64)
    seq_len = len(seq)

    hom = np.zeros(n, dtype=np.int64)
    done = np.zeros(n, dtype=bool)

    win = _INIT_WINDOW
    base = np.zeros(n, dtype=np.int64)  # homology length already confirmed

    while not done.all() and win <= _MAX_WINDOW:
        active = np.nonzero(~done)[0]
        j = np.arange(win, dtype=np.int64)

        if direction == 'left':
            seq_idx = pos[active, None] - (base[active, None] + j[None, :])
            in_bounds = seq_idx >= 0
        else:
            seq_idx = pos[active, None] + (base[active, None] + j[None, :])
            in_bounds = seq_idx < seq_len

        seq_idx_c = np.clip(seq_idx, 0, seq_len - 1)
        seq_base = seq[seq_idx_c]

        if direction == 'left':
            sv_idx = (sv_len[active, None] - 1 - ((base[active, None] + j[None, :]) % sv_len[active, None]))
        else:
            sv_idx = (base[active, None] + j[None, :]) % sv_len[active, None]
        sv_base = sv_arena[sv_off[active, None] + sv_idx]

        match = in_bounds & (seq_base < 4) & (seq_base == sv_base)

        # Run length of leading matches in this window.
        any_mismatch = ~match.all(axis=1)
        first_mm = np.where(any_mismatch, np.argmin(match, axis=1), win)

        hom[active] = base[active] + first_mm
        done[active] |= any_mismatch
        base[active] += first_mm

        win *= 2

    return hom


def left_homology_batch(pos, seq, sv_arena, sv_off, sv_len):
    """Perfect homology upstream of each SV (reference: pavlib/call.py:542-592)."""
    return _homology_batch(pos, seq, sv_arena, sv_off, sv_len, 'left')


def right_homology_batch(pos, seq, sv_arena, sv_off, sv_len):
    """Perfect homology downstream of each SV (reference: pavlib/call.py:595-647)."""
    return _homology_batch(pos, seq, sv_arena, sv_off, sv_len, 'right')


def left_homology(pos, seq, sv):
    """Scalar convenience wrapper; seq and sv are code arrays."""
    sv = np.asarray(sv, dtype=np.uint8)
    if len(sv) == 0 or pos < 0:
        return 0
    return int(left_homology_batch(
        np.array([pos]), np.asarray(seq, dtype=np.uint8),
        sv, np.array([0]), np.array([len(sv)]))[0])


def right_homology(pos, seq, sv):
    sv = np.asarray(sv, dtype=np.uint8)
    if len(sv) == 0:
        return 0
    return int(right_homology_batch(
        np.array([pos]), np.asarray(seq, dtype=np.uint8),
        sv, np.array([0]), np.array([len(sv)]))[0])


def make_arena(sv_seqs):
    """Concatenate variable-length SV code arrays into (arena, offsets, lengths)."""
    lens = np.array([len(s) for s in sv_seqs], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]) if len(lens) else np.zeros(0, dtype=np.int64)
    arena = np.concatenate(sv_seqs) if sv_seqs else np.zeros(0, dtype=np.uint8)
    return arena.astype(np.uint8), offs.astype(np.int64), lens
