"""CIGAR codec and accounting over numpy op arrays.

CIGARs live as parallel (oplen int32, opcode int8) arrays, not strings; strings
exist only at the artifact boundary. Op codes follow SAM order so tables
interoperate with external tools (reference constants: pavlib/align/align.py:12-32).
The framework requires base-level ops (=/X); M is rejected like the reference
(pavlib/align/align.py:721-725).
"""

import re

import numpy as np

M, I, D, N, S, H, P, EQ, X = range(9)

OP_CHARS = np.frombuffer(b'MIDNSHP=X', dtype=np.uint8)
_CHAR_TO_OP = {chr(c): i for i, c in enumerate(b'MIDNSHP=X')}

# Per-op consumption tables
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)
CONSUMES_QRY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)
IS_CLIP = np.array([0, 0, 0, 0, 1, 1, 0, 0, 0], dtype=np.int64)

_CIGAR_RE = re.compile(r'(\d+)([MIDNSHP=X])')


def parse(cigar_str):
    """CIGAR string -> (lens int32 array, ops int8 array)."""
    toks = _CIGAR_RE.findall(cigar_str)
    if ''.join(f'{l}{o}' for l, o in toks) != cigar_str:
        raise ValueError(f'Malformed CIGAR string: {cigar_str[:80]}')
    lens = np.array([int(l) for l, _ in toks], dtype=np.int32)
    ops = np.array([_CHAR_TO_OP[o] for _, o in toks], dtype=np.int8)
    return lens, ops


def to_string(lens, ops):
    """(lens, ops) -> CIGAR string."""
    return ''.join(f'{int(l)}{chr(OP_CHARS[o])}' for l, o in zip(lens, ops))


def to_tuples(lens, ops):
    """(lens, ops) -> list of (oplen, opchar) tuples (reference tuple convention:
    pavlib/align/align.py:286-322)."""
    return [(int(l), chr(OP_CHARS[o])) for l, o in zip(lens, ops)]


def from_tuples(tuples):
    lens = np.array([l for l, _ in tuples], dtype=np.int32)
    ops = np.array([_CHAR_TO_OP[o] for _, o in tuples], dtype=np.int8)
    return lens, ops


def count(lens, ops, allow_m=False):
    """Base accounting for one record: (ref_bp, qry_bp, clip_h_l, clip_s_l,
    clip_h_r, clip_s_r), validating clip placement
    (reference: pavlib/align/align.py:534-663)."""
    lens = np.asarray(lens, dtype=np.int64)
    ops = np.asarray(ops)
    n = len(ops)
    if n == 0:
        raise ValueError('Empty CIGAR')
    if not allow_m and np.any(ops == M):
        raise ValueError('CIGAR op "M" is not allowed')
    bad = ~np.isin(ops, [M, I, D, S, H, EQ, X])
    if np.any(bad):
        raise ValueError(f'Bad CIGAR op code: {ops[bad][0]}')

    # Left clips: H then S allowed at the very start.
    i = 0
    clip_h_l = clip_s_l = 0
    if i < n and ops[i] == H:
        clip_h_l = int(lens[i]); i += 1
    if i < n and ops[i] == S:
        clip_s_l = int(lens[i]); i += 1

    # Right clips: S then H at the very end.
    j = n
    clip_h_r = clip_s_r = 0
    if j > i and ops[j - 1] == H:
        clip_h_r = int(lens[j - 1]); j -= 1
    if j > i and ops[j - 1] == S:
        clip_s_r = int(lens[j - 1]); j -= 1

    body_ops = ops[i:j]
    body_lens = lens[i:j]
    if np.any(IS_CLIP[body_ops] > 0):
        raise ValueError('Clipping operations inside CIGAR body')

    ref_bp = int(np.sum(body_lens * CONSUMES_REF[body_ops]))
    qry_bp = int(np.sum(body_lens * CONSUMES_QRY[body_ops]))
    return ref_bp, qry_bp, clip_h_l, clip_s_l, clip_h_r, clip_s_r


def clip_soft_to_hard(lens, ops):
    """Collapse leading/trailing clip runs into single hard clips
    (reference: pavlib/align/align.py:797-831)."""
    lens = list(np.asarray(lens)); ops = list(np.asarray(ops))
    front = 0
    while ops and ops[0] in (S, H):
        front += int(lens.pop(0)); ops.pop(0)
    back = 0
    while ops and ops[-1] in (S, H):
        back += int(lens.pop()); ops.pop()
    if not ops:
        if front + back == 0:
            raise ValueError('Cannot convert soft clipping to hard: no CIGAR records')
        return np.array([front + back], dtype=np.int32), np.array([H], dtype=np.int8)
    if front:
        lens.insert(0, front); ops.insert(0, H)
    if back:
        lens.append(back); ops.append(H)
    return np.array(lens, dtype=np.int32), np.array(ops, dtype=np.int8)


def match_bp(lens, ops, right_end):
    """Matched ('=') bases at one end of an alignment, skipping clips and stopping
    at the first non-match op (reference: pavlib/align/align.py:325-361)."""
    lens = np.asarray(lens); ops = np.asarray(ops)
    if right_end:
        lens, ops = lens[::-1], ops[::-1]
    total = 0
    for l, o in zip(lens, ops):
        if o in (S, H):
            continue
        if o == EQ:
            total += int(l)
        elif o == M:
            raise ValueError('Detected "M" opcodes in CIGAR: =/X required')
        else:
            break
    return total


def merge_adjacent(lens, ops):
    """Coalesce adjacent ops of the same code and drop zero-length ops."""
    lens = np.asarray(lens, dtype=np.int64)
    ops = np.asarray(ops, dtype=np.int8)
    keep = lens > 0
    lens, ops = lens[keep], ops[keep]
    if len(ops) == 0:
        return lens.astype(np.int32), ops
    boundary = np.concatenate([[True], ops[1:] != ops[:-1]])
    group = np.cumsum(boundary) - 1
    out_lens = np.zeros(group[-1] + 1, dtype=np.int64)
    np.add.at(out_lens, group, lens)
    out_ops = ops[boundary]
    return out_lens.astype(np.int32), out_ops
