"""The plain reference that decides ``correct``: NumPy only, written for the
benchmark, importing nothing of the program.

Two kinds of answers are judged, each against what the reference works out
on its own:

* the VCF of every sample of the window, against the truth the generator
  planted (``gen.py``): every planted SNV, insertion and deletion of a
  haplotype has to come back base-exact (both sides left-normalised against
  the reference) on that haplotype's side of the phased GT; an inversion on
  its haplotype with a reciprocal overlap of at least 0.5. ``missed_share``
  is the share of planted events with no such call, ``false_share`` the
  share of PASS calls (a call on both sides counts twice) that match no
  planted event of their haplotype, duplicates included;
* the DP kernels' answers of the timed path (``affine_dp.align_and_trace``):
  each answer is a step tape, which has to be a path over exactly the
  item's query and reference, label its matches and mismatches right and,
  for a full-width item, score the optimum of the two-piece affine global
  alignment (``best_scores``). ``dp_bad_items`` counts the checked items
  that do not. The items' windows are the program's gather; each one long
  enough to place is held to the inputs (the reference FASTA and the
  sample's contig FASTA files, ``window_ok``): ``dp_bad_windows``.

The control (``control_calls``, ``control_dp``) is the reference put in the
program's place with one stated guarantee broken: coordinates at a
precision of 2 bp instead of 1 (every position, and every DP item's
extent, rounded down to even).
"""

import gzip

import numpy as np

STEP_EQ, STEP_X, STEP_I, STEP_D = 0, 1, 2, 3
INV_MIN_RO = 0.5
# A planted event this close to a contig's end (in reference bases) is an
# edge event: contig-end extension and overlap trimming decide its call.
EDGE_BP = 5000


def read_fasta(path):
    """{name: sequence as an upper-case str}."""
    seqs, name, buf = {}, None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith('>'):
                if name is not None:
                    seqs[name] = ''.join(buf).upper()
                name, buf = line[1:].split()[0], []
            else:
                buf.append(line.strip())
    if name is not None:
        seqs[name] = ''.join(buf).upper()
    return seqs


# ------------------------------------------------------------------ calls

def left_del(seq, pos, length):
    """Leftmost position of the deletion of seq[pos:pos + length]."""
    while pos > 0 and seq[pos - 1] == seq[pos + length - 1]:
        pos -= 1
    return pos


def left_ins(seq, pos, ins):
    """Leftmost (position, sequence) of ``ins`` inserted before seq[pos]."""
    while pos > 0 and seq[pos - 1] == ins[-1]:
        ins = ins[-1] + ins[:-1]
        pos -= 1
    return pos, ins


def truth_key(ref, t):
    """The normalised key of a planted event (0-based positions)."""
    seq = ref[t['chrom']]
    if t['type'] == 'SNV':
        return ('SNV', t['chrom'], t['pos'], t['alt'])
    if t['type'] == 'DEL':
        return ('DEL', t['chrom'], left_del(seq, t['pos'], t['len']), t['len'])
    if t['type'] == 'INS':
        return ('INS', t['chrom']) + left_ins(seq, t['pos'], t['seq'])
    return ('INV', t['chrom'], t['pos'], t['len'])


def vcf_calls(path, ref, haps=('h1', 'h2')):
    """{hap: [normalised key]} of a phased VCF's PASS records, a record on
    both sides of its GT once for each."""
    out = {h: [] for h in haps}
    with gzip.open(path, 'rt') as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            if f[6] != 'PASS':
                continue
            chrom, pos, ref_a, alt = f[0], int(f[1]), f[3].upper(), f[4].upper()
            info = dict(kv.split('=', 1) for kv in f[7].split(';') if '=' in kv)
            svtype = info.get('SVTYPE')
            seq = ref.get(chrom, '')
            if svtype == 'SNV':
                key = ('SNV', chrom, pos - 1, alt)
            elif svtype == 'DEL':
                key = ('DEL', chrom, left_del(seq, pos, len(ref_a) - 1), len(ref_a) - 1)
            elif svtype == 'INS':
                key = ('INS', chrom) + left_ins(seq, pos, alt[1:])
            elif svtype == 'INV':
                key = ('INV', chrom, pos, abs(int(info['SVLEN'])))
            else:
                key = (str(svtype), chrom, pos, alt)
            gt = f[9].split(':')[0].replace('/', '|').split('|')
            for hap, allele in zip(haps, gt):
                if allele not in ('0', '.'):
                    out[hap].append(key)
    return out


def _inv_hit(key, others):
    """Whether an INV key overlaps one of ``others`` (INV keys of the same
    haplotype) reciprocally by INV_MIN_RO."""
    _, chrom, pos, length = key
    for _, c2, p2, l2 in others:
        if c2 == chrom:
            inter = min(pos + length, p2 + l2) - max(pos, p2)
            if inter > 0 and inter >= INV_MIN_RO * max(length, l2):
                return True
    return False


def contig_ends(layout):
    """{hap: {chrom: sorted reference positions of its contigs' ends}} of
    a sample's layout (``gen.contigs``): where a contig starts or stops,
    an overlap with its neighbour included."""
    ends = {}
    for w in layout.values():
        ends.setdefault(w['hap'], {}).setdefault(w['chrom'], []).extend(
            [w['ref_start'], w['ref_end']])
    return {h: {c: np.unique(v) for c, v in cs.items()} for h, cs in ends.items()}


def near_end(key, ends):
    """Whether a normalised key lies within EDGE_BP of a contig end of
    ``ends`` ({chrom: sorted positions})."""
    at = ends.get(key[1])
    if at is None or not len(at):
        return False
    i = np.searchsorted(at, key[2])
    return any(abs(int(at[j]) - key[2]) <= EDGE_BP for j in (i - 1, i) if 0 <= j < len(at))


def compare_calls(want, got, ends=None):
    """Counts of one sample: {planted, missed, called, false, edge_planted,
    edge_missed, duplicate}. ``want`` and ``got`` are {hap: [normalised
    key]} (truth, calls); ``ends`` ({hap: {chrom: positions}},
    ``contig_ends``) marks the planted events near a contig end.
    ``duplicate`` counts the calls of a haplotype that repeat one of its
    earlier calls."""
    c = dict.fromkeys(('planted', 'missed', 'called', 'false', 'edge_planted', 'edge_missed',
                       'duplicate'), 0)
    for hap, keys in want.items():
        calls = got.get(hap, [])
        seen, truth_set = set(), set(keys)
        inv_truth = [k for k in keys if k[0] == 'INV']
        inv_calls = [k for k in calls if k[0] == 'INV']
        call_set = set(calls)
        hap_ends = (ends or {}).get(hap, {})
        for k in keys:
            hit = _inv_hit(k, inv_calls) if k[0] == 'INV' else k in call_set
            edge = near_end(k, hap_ends)
            c['planted'] += 1
            c['missed'] += not hit
            c['edge_planted'] += edge
            c['edge_missed'] += edge and not hit
        for k in calls:
            c['called'] += 1
            c['duplicate'] += k in seen
            if k[0] == 'INV':
                c['false'] += not _inv_hit(k, inv_truth)
            else:
                c['false'] += k not in truth_set or k in seen
            seen.add(k)
    return c


def control_calls(want):
    """The control's calls: the planted events themselves, every position
    rounded down to even (2 bp precision)."""
    return {hap: [k[:2] + (k[2] & ~1,) + k[3:] for k in keys] for hap, keys in want.items()}


# --------------------------------------------------------------------- DP

def gap_cost(g, sc):
    (o1, o2), (e1, e2) = sc['gap_open'], sc['gap_ext']
    return np.minimum(o1 + g * e1, o2 + g * e2)


def best_scores(q, r, m, n, sc):
    """The optimal two-piece affine global alignment score of each item:
    q int [b, >= max m], r int [b, >= max n] base codes (4 and above match
    nothing), m, n int [b]. Row by row over the query; a horizontal gap is
    the exclusive prefix maximum of the row without it (opening a gap from
    a gap never pays, both openings being positive)."""
    match, mismatch = sc['match'], sc['mismatch']
    (o1, o2), (e1, e2) = sc['gap_open'], sc['gap_ext']
    b = len(m)
    M, N = int(m.max()), int(n.max())
    W = N + 1
    neg = np.int64(-(1 << 40))
    j = np.arange(W, dtype=np.int64)[None, :]
    q = np.asarray(q, dtype=np.int64)[:, :M]
    r = np.asarray(r, dtype=np.int64)[:, :N]
    h = np.where(j == 0, 0, -gap_cost(j, sc)).astype(np.int64).repeat(b, axis=0)
    ea = np.full((b, W), neg)
    eb = np.full((b, W), neg)
    out = np.where(m == 0, h[np.arange(b), n], neg)
    rows = np.arange(b)
    for i in range(1, M + 1):
        ea = np.maximum(h - (o1 + e1), ea - e1)
        eb = np.maximum(h - (o2 + e2), eb - e2)
        e = np.maximum(ea, eb)
        qi = q[:, i - 1:i]
        sub = np.where((qi == r) & (qi < 4), match, mismatch)
        diag = np.full((b, W), neg)
        diag[:, 1:] = h[:, :-1] + sub
        ht = np.maximum(diag, e)
        f = np.full((b, W), neg)
        for o, ext in ((o1, e1), (o2, e2)):
            run = np.maximum.accumulate(ht + j * ext, axis=1)
            f[:, 1:] = np.maximum(f[:, 1:], run[:, :-1] - o - j[:, 1:] * ext)
        h = np.maximum(ht, f)
        done = m == i
        out[done] = h[rows[done], n[done]]
    return out


def decode_tape(row):
    """One fused walker row -> (forward step codes, error byte): 2-bit codes
    in walk order (end to start), then the path length as 4 little-endian
    bytes, then the error byte."""
    row = np.asarray(row, dtype=np.uint8)
    length = int(row[-5:-1].astype(np.int64) @ (1 << (8 * np.arange(4, dtype=np.int64))))
    packed = row[:-5]
    codes = (packed[:, None] >> (2 * np.arange(4, dtype=np.uint8))[None, :]) & 3
    codes = codes.reshape(-1)
    if length > len(codes):
        return None, int(row[-1])
    return codes[:length][::-1], int(row[-1])


def path_score(codes, q, r, m, n, sc):
    """The score of a step path over query q[:m] and reference r[:n], or
    None where it is no alignment of them: it consumes other lengths, or
    labels a match as a mismatch or the reverse."""
    if codes is None:
        return None
    codes = np.asarray(codes, dtype=np.int64)
    dq = (codes != STEP_D).astype(np.int64)
    dr = (codes != STEP_I).astype(np.int64)
    if dq.sum() != m or dr.sum() != n:
        return None
    qi = np.cumsum(dq) - dq
    rj = np.cumsum(dr) - dr
    diag = codes <= STEP_X
    qa = np.asarray(q, dtype=np.int64)[qi[diag]]
    ra = np.asarray(r, dtype=np.int64)[rj[diag]]
    eq = (qa == ra) & (qa < 4)
    if np.any(eq != (codes[diag] == STEP_EQ)):
        return None
    score = int(eq.sum()) * sc['match'] + int((~eq).sum()) * sc['mismatch']
    if len(codes):
        edge = np.flatnonzero(np.diff(codes) != 0) + 1
        starts = np.concatenate([[0], edge])
        lens = np.diff(np.concatenate([starts, [len(codes)]]))
        gaps = codes[starts] >= STEP_I
        score -= int(gap_cost(lens[gaps], sc).sum())
    return score


# ------------------------------------------------------ the DP's windows

WINDOW_K = 16           # bases a key of the slice index covers
WINDOW_STRIDE = 8       # the index keeps every WINDOW_STRIDE-th key
WINDOW_MIN = WINDOW_K + WINDOW_STRIDE - 1   # shorter windows are not placed
_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b'ACGT'):
    _CODE[_b] = _i
_COMP = str.maketrans('ACGTN', 'TGCAN')
_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)
# A window read reversed, complemented, or both: (reversed, complemented).
ORIENT = {'fwd': (0, 0), 'rev': (1, 0), 'comp': (0, 1), 'rc': (1, 1)}


def window_text(codes, length):
    """An item's window (base codes, 4 and above N) as a str of ACGTN."""
    return _DECODE[np.minimum(np.asarray(codes, dtype=np.int64)[:length], 4)].tobytes().decode()


class SliceIndex:
    """Every WINDOW_STRIDE-th WINDOW_K-mer of named sequences (joined by
    N), to find where a window of WINDOW_MIN bases or more lies."""

    def __init__(self, seqs):
        self.names = list(seqs)
        self.text = 'N'.join(seqs.values())
        self.starts = np.cumsum([0] + [len(v) + 1 for v in seqs.values()])[:-1]
        c = _CODE[np.frombuffer(self.text.encode('ascii'), dtype=np.uint8)]
        pos = np.arange(0, max(len(c) - WINDOW_K + 1, 0), WINDOW_STRIDE, dtype=np.int64)
        k4 = ((c[:-3] & 3) << 6) | ((c[1:-2] & 3) << 4) | ((c[2:-1] & 3) << 2) | (c[3:] & 3)
        keys = np.zeros(len(pos), dtype=np.uint64)
        for t in range(WINDOW_K // 4):
            keys = (keys << np.uint64(8)) | k4[4 * t::WINDOW_STRIDE][:len(pos)]
        unknown = np.flatnonzero(c >= 4)
        after = np.searchsorted(unknown, pos)
        keep = after == len(unknown)
        if len(unknown):
            keep |= unknown[np.minimum(after, len(unknown) - 1)] >= pos + WINDOW_K
        # key and position in one word, sorted together
        both = np.sort((keys[keep] << np.uint64(32)) | pos[keep].astype(np.uint64))
        self.keys, self.pos = both >> np.uint64(32), (both & np.uint64(0xFFFFFFFF)).astype(np.int64)

    @staticmethod
    def key(text):
        out = 0
        for b in text.encode('ascii'):
            out = (out << 2) | int(_CODE[b] & 3)
        return np.uint64(out)

    def find(self, needle):
        """The names of the sequences that hold ``needle`` (WINDOW_MIN
        bases or more, no N) as a slice."""
        found = set()
        for o in range(WINDOW_STRIDE):
            k = self.key(needle[o:o + WINDOW_K])
            lo = np.searchsorted(self.keys, k, side='left')
            hi = np.searchsorted(self.keys, k, side='right')
            for p in self.pos[lo:hi]:
                start = int(p) - o
                if start >= 0 and self.text[start:start + len(needle)] == needle:
                    found.add(self.names[int(np.searchsorted(self.starts, start, 'right')) - 1])
        return found

    def places(self, window):
        """{(name, ORIENT name)}: where ``window`` is a slice, read as it
        stands, reversed, complemented, or both."""
        comp = window.translate(_COMP)
        shown = {'fwd': window, 'rev': window[::-1], 'comp': comp, 'rc': comp[::-1]}
        return {(name, o) for o, text in shown.items() for name in self.find(text)}


def window_ok(a, b, ref_index, tig_index, strand):
    """Whether an item's two windows (str) are slices of the inputs as the
    aligner pairs them: one of the reference, forward or reversed; the
    other of a contig of the sample as the contig lies on the reference,
    read forward or reversed (a contig of ``strand`` '-', {contig:
    strand}, reverse-complemented or complemented); where both are long
    enough to place, reversed alike. None where neither window is long
    enough to place."""
    if max(len(a), len(b)) < WINDOW_MIN:
        return None
    any_rev = {False, True}
    for ref_w, tig_w in ((a, b), (b, a)):
        ref_rev = ({ORIENT[o][0] == 1 for _, o in ref_index.places(ref_w) if o in ('fwd', 'rev')}
                   if len(ref_w) >= WINDOW_MIN else any_rev)
        tig_rev = ({ORIENT[o][0] != ORIENT[o][1] for name, o in tig_index.places(tig_w)
                    if ORIENT[o][1] == (strand[name] == '-')}
                   if len(tig_w) >= WINDOW_MIN else any_rev)
        if ref_rev & tig_rev:
            return True
    return False


def sample_items(launches, count, rng):
    """(launch index, row) pairs to check: each launch's largest item, then
    rows drawn uniformly from all launches up to ``count`` in all."""
    picks = {(i, int(np.argmax(L['m'].astype(np.int64) * (L['n'] + 1))))
             for i, L in enumerate(launches)}
    rows = np.array([(i, k) for i, L in enumerate(launches) for k in range(len(L['m']))],
                    dtype=np.int64).reshape(-1, 2)
    if len(rows):
        for i, k in rows[rng.permutation(len(rows))[:max(0, count - len(picks))]]:
            picks.add((int(i), int(k)))
    return sorted(picks)


def check_dp(launches, picks, sc, control=False, indexes=None):
    """{checked, bad, widest_gap, windows_placed, bad_windows, band_exits}
    over the picked (launch, row) items. A full-width answer is bad where
    it is no alignment of the item (``path_score``) or scores below the
    optimum; a banded one where it is no alignment of the item (the band's
    optimum is no guarantee; a row whose walk left the band, its error
    byte set, is no answer and is counted in ``band_exits``).
    ``widest_gap`` is the largest shortfall (-1 where only invalid answers
    were bad). ``indexes(launch)`` gives the reference's and the contigs'
    ``SliceIndex`` and the contigs' strands of the sample a launch ran
    for: each item's windows are held to the inputs by ``window_ok``. With ``control`` the answers
    judged are the control's (``control_dp``)."""
    by_launch = {}
    for i, k in picks:
        by_launch.setdefault(i, []).append(k)
    out = dict.fromkeys(('checked', 'bad', 'widest_gap', 'windows_placed', 'bad_windows',
                         'band_exits'), 0)
    for i, ks in sorted(by_launch.items()):
        L = launches[i]
        ks = np.array(ks)
        q, r, m, n = L['q'][ks], L['r'][ks], L['m'][ks], L['n'][ks]
        full = L['kind'] == 'full'
        best = best_scores(q, r, m, n, sc) if full else [None] * len(ks)
        got = (control_dp(q, r, m, n, sc) if control
               else [_own_answer(L, int(k), sc) for k in ks])
        for row, opt, score in zip(range(len(ks)), best, got):
            if score == 'exit':
                out['band_exits'] += 1
                continue
            out['checked'] += 1
            if score is None or (full and score != opt):
                out['bad'] += 1
                out['widest_gap'] = max(out['widest_gap'], int(opt - score)
                                        if score is not None else -1)
        if indexes is not None and not control:
            ref_index, tig_index, strand = indexes(L)
            for row in range(len(ks)):
                ok = window_ok(window_text(q[row], int(m[row])), window_text(r[row], int(n[row])),
                               ref_index, tig_index, strand)
                if ok is not None:
                    out['windows_placed'] += 1
                    out['bad_windows'] += not ok
    return out


def _own_answer(L, k, sc):
    """The score of the program's answer for row k of a launch: its tape
    row decoded and judged by ``path_score`` (None where the walker set
    its error byte on a full-width item; 'exit' on a banded one)."""
    codes, err = decode_tape(L['out'][k])
    if err:
        return None if L['kind'] == 'full' else 'exit'
    return path_score(codes, L['q'][k], L['r'][k], int(L['m'][k]), int(L['n'][k]), sc)


def control_dp(q, r, m, n, sc):
    """The control's answers: the reference's optimum over each item's
    extents rounded down to even (2 bp precision). An answer over other
    extents than the item's is no alignment of it (None), as
    ``path_score`` judges a path; the rest are the optimum."""
    me, ne = m & ~1, n & ~1
    scores = best_scores(q, r, me, ne, sc)
    return [int(s) if (a, b) == (c, d) else None
            for s, a, b, c, d in zip(scores, me, ne, m, n)]
