"""Sequence codec: ASCII DNA <-> small-integer codes, vectorized with numpy.

The whole framework operates on uint8 *code arrays* (A=0, C=1, G=2, T=3, other=4)
rather than Python strings. Codes 0-3 pack directly into 2-bit k-mers and map onto
device int8 tensors; code 4 marks ambiguous bases (N etc.) and is excluded from
k-mers and homology matches, mirroring the reference's ambiguous-base handling
(reference: pavlib/call.py:578, kanapy k-mer streaming skips non-ACGT).
"""

import numpy as np

A, C, G, T, AMBIG = 0, 1, 2, 3, 4

# ASCII -> code lookup (case-insensitive). Everything non-ACGT becomes AMBIG.
_ENCODE_LUT = np.full(256, AMBIG, dtype=np.uint8)
for _base, _code in (('A', A), ('C', C), ('G', G), ('T', T)):
    _ENCODE_LUT[ord(_base)] = _code
    _ENCODE_LUT[ord(_base.lower())] = _code

_DECODE_LUT = np.frombuffer(b'ACGTN', dtype=np.uint8)

# Complement in code space; AMBIG complements to AMBIG.
COMP_LUT = np.array([T, G, C, A, AMBIG], dtype=np.uint8)


def encode(seq):
    """Encode a DNA string/bytes into a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode('ascii')
    buf = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[buf]


def decode(codes):
    """Decode a uint8 code array back into an upper-case DNA string."""
    codes = np.asarray(codes, dtype=np.uint8)
    return _DECODE_LUT[np.minimum(codes, AMBIG)].tobytes().decode('ascii')


def revcomp(codes):
    """Reverse-complement a code array."""
    return COMP_LUT[np.asarray(codes, dtype=np.uint8)][::-1].copy()


def revcomp_str(seq):
    return decode(revcomp(encode(seq)))


def is_acgt(codes):
    """Boolean mask of unambiguous bases."""
    return np.asarray(codes) < 4


def pack_2bit(codes):
    """Pack a code array (values 0-3 only; AMBIG is masked to 0) into a uint8 array,
    4 bases per byte, little-endian base order. Used for compact HBM-resident storage."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    codes = np.where(codes > 3, 0, codes).reshape(-1, 4)
    return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | (codes[:, 3] << 6)).astype(np.uint8)


def unpack_2bit(packed, n):
    """Inverse of pack_2bit (ambiguity information is lost)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = packed & 3
    out[:, 1] = (packed >> 2) & 3
    out[:, 2] = (packed >> 4) & 3
    out[:, 3] = (packed >> 6) & 3
    return out.reshape(-1)[:n]
