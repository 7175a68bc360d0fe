"""Genomic regions in 0-based half-open coordinates.

Functional parity with the reference Region class (pavlib/seq.py:20-302):
orientation tracking, min/max breakpoint bounds, alignment-index provenance,
limit-aware balanced expansion, and the 1-based string forms used in artifact
tables (QRY_REGION etc.).
"""

import re

import numpy as np


class Region:

    __slots__ = (
        'chrom', 'pos', 'end', 'is_rev',
        'pos_min', 'pos_max', 'end_min', 'end_max',
        'pos_aln_index', 'end_aln_index',
    )

    def __init__(self, chrom, pos, end, is_rev=None,
                 pos_min=None, pos_max=None, end_min=None, end_max=None,
                 pos_aln_index=None, end_aln_index=None):
        self.chrom = str(chrom)
        self.pos = int(pos)
        self.end = int(end)

        self.pos_min = self.pos if pos_min is None else int(pos_min)
        self.pos_max = self.pos if pos_max is None else int(pos_max)
        self.end_min = self.end if end_min is None else int(end_min)
        self.end_max = self.end if end_max is None else int(end_max)

        self.pos_aln_index = pos_aln_index
        self.end_aln_index = end_aln_index

        if self.pos > self.end:
            # Reversed coordinates imply reverse orientation (reference: pavlib/seq.py:54-70)
            self.pos, self.end = self.end, self.pos
            self.end_min = self.pos if pos_min is None else int(pos_min)
            self.end_max = self.pos if pos_max is None else int(pos_max)
            self.pos_min = self.end if end_min is None else int(end_min)
            self.pos_max = self.end if end_max is None else int(end_max)
            self.pos_aln_index, self.end_aln_index = self.end_aln_index, self.pos_aln_index
            if is_rev is None:
                is_rev = True

        self.is_rev = bool(is_rev) if is_rev is not None else False

    def __repr__(self):
        return self.to_base1_string()

    def to_base1_string(self):
        return '{}:{}-{}'.format(self.chrom, self.pos + 1, self.end)

    def __len__(self):
        return self.end - self.pos

    def region_id(self):
        return '{}-{}-RGN-{}'.format(self.chrom, self.pos, self.end - self.pos)

    def __eq__(self, other):
        return self.chrom == other.chrom and self.pos == other.pos and self.end == other.end

    def __lt__(self, other):
        return (self.chrom, self.pos, self.end) < (other.chrom, other.pos, other.end)

    def __hash__(self):
        return hash((self.chrom, self.pos, self.end))

    def copy(self):
        return Region(self.chrom, self.pos, self.end, self.is_rev,
                      self.pos_min, self.pos_max, self.end_min, self.end_max)

    def expand(self, expand_bp, min_pos=0, max_end=None, shift=True, balance=0.5):
        """Expand by expand_bp, split upstream/downstream by `balance`, honoring
        [min_pos, max_end] with optional shifting (reference: pavlib/seq.py:112-188).

        `max_end` may be an int, a dict/Mapping keyed by chrom, or a pandas Series.
        """
        if balance is None:
            balance = 0.5
        if not (0 <= balance <= 1):
            raise ValueError(f'balance must be in [0, 1]: {balance}')

        expand_pos = int(expand_bp * balance)
        expand_end = max(0, int(expand_bp) - expand_pos)

        new_pos = self.pos - expand_pos
        new_end = self.end + expand_end

        if min_pos is not None and new_pos < min_pos:
            if shift:
                new_end += min_pos - new_pos
            new_pos = min_pos

        if max_end is not None and not isinstance(max_end, (int, np.integer)):
            try:
                max_end = int(max_end[self.chrom])
            except (KeyError, TypeError):
                max_end = None

        if max_end is not None and new_end > max_end:
            if shift:
                new_pos -= new_end - max_end
                if min_pos is not None and new_pos < min_pos:
                    new_pos = min_pos
            new_end = max_end

        if new_end < new_pos:
            new_end = new_pos = (new_end + new_pos) // 2

        self.pos, self.end = int(new_pos), int(new_end)
        self.pos_min = self.pos_max = self.pos
        self.end_min = self.end_max = self.end


_REGION_RE = re.compile(r'^([^:]+):(\d+)-(\d+)$')


def region_from_string(rgn_str, is_rev=None, base0half=False):
    """Parse "chrom:pos-end" (1-based closed by default; BED if base0half)."""
    m = _REGION_RE.match(rgn_str.replace(',', ''))
    if m is None:
        raise ValueError(f'Region is not in expected format (chrom:pos-end): {rgn_str}')
    pos, end = int(m[2]), int(m[3])
    if not base0half:
        pos -= 1
    return Region(m[1], pos, end, is_rev=is_rev)


def region_from_id(region_id):
    """Parse "CHROM-POS-RGN-LEN" region IDs (reference: pavlib/seq.py:288-302)."""
    tok = region_id.split('-')
    if len(tok) != 4:
        raise ValueError(f'Unrecognized region ID: {region_id}')
    return Region(tok[0], int(tok[1]) - 1, int(tok[1]) - 1 + int(tok[3]))
