"""Synthetic samples with planted truth: the port's test and bench data.

The generators of ``tests/helpers.py`` and ``bench.py`` (random background,
planted mutations with truth records, repeat-rich references, the diploid
bench sample) on the port's own codec, and the concordance of a VCF with
the planted truth at ``tests/test_recall.py``'s floors. Not a pipeline
feature: ``chip_smoke.py``, ``bench_torch.py`` and the port's tests import
it.
"""

import numpy as np

from . import seqcodec

BASES = 'ACGT'

# tests/test_recall.py's floors against planted truth: (class, column, least).
# INV also needs at least one INV in the truth.
RECALL_FLOORS = (('SNV', 'RECALL', 0.99), ('SNV', 'PRECISION', 0.99),
                 ('INS', 'RECALL', 0.97), ('DEL', 'RECALL', 0.97),
                 ('INS', 'PRECISION', 0.95), ('DEL', 'PRECISION', 0.95),
                 ('INV', 'RECALL', 1.0))
# The size bin of truth_report's ``min_len`` report (kilobase INS and DEL).
WIDE_MIN = 2000


def random_seq(n, rng, gc=0.5):
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


class Mutator:
    """Applies mutations to a code-array sequence, tracking truth records.

    Mutations are specified at original (reference) coordinates and must be
    non-overlapping and applied in ascending position order.
    """

    def __init__(self, ref_codes):
        self.ref = np.asarray(ref_codes, dtype=np.uint8)
        self.pieces = []   # list of code arrays composing the mutant
        self.cursor = 0    # position in ref consumed so far
        self.truth = []    # list of dicts: type, ref_pos, len, seq

    def _advance(self, pos):
        if pos < self.cursor:
            raise ValueError('Mutations must be applied in ascending order')
        self.pieces.append(self.ref[self.cursor:pos])
        self.cursor = pos

    def snv(self, pos, alt=None, rng=None):
        self._advance(pos)
        ref_base = int(self.ref[pos])
        if alt is None:
            choices = [b for b in range(4) if b != ref_base]
            alt = int((rng or np.random.default_rng(pos)).choice(choices))
        self.pieces.append(np.array([alt], dtype=np.uint8))
        self.cursor = pos + 1
        self.truth.append({'type': 'SNV', 'pos': pos, 'ref': BASES[ref_base], 'alt': BASES[alt]})

    def ins(self, pos, seq_codes):
        self._advance(pos)
        seq_codes = np.asarray(seq_codes, dtype=np.uint8)
        self.pieces.append(seq_codes)
        self.truth.append({'type': 'INS', 'pos': pos, 'len': len(seq_codes),
                           'seq': seqcodec.decode(seq_codes)})

    def dele(self, pos, length):
        self._advance(pos)
        self.cursor = pos + length
        self.truth.append({'type': 'DEL', 'pos': pos, 'len': length,
                           'seq': seqcodec.decode(self.ref[pos:pos + length])})

    def inv(self, pos, length):
        self._advance(pos)
        self.pieces.append(seqcodec.revcomp(self.ref[pos:pos + length]))
        self.cursor = pos + length
        self.truth.append({'type': 'INV', 'pos': pos, 'len': length})

    def finish(self):
        self._advance(len(self.ref))
        return np.concatenate(self.pieces) if self.pieces else np.zeros(0, dtype=np.uint8)


def repeat_rich_ref(length, rng, n_gap_prop=0.005):
    """A reference with realistic repeat structure: tandem arrays, diverged
    segmental duplications, inverted duplications, an interspersed repeat
    family, and N-gap runs over a random background.

    These are the inputs that actually break aligners (VERDICT r1 weak #6;
    reference stressors: pavlib/inv.py:457-561 inverted dups,
    scripts/density.py:47 low-complexity bail). Returns (codes, annotations)
    where annotations is a list of (kind, pos, end) for the planted features.
    """
    seg = []
    ann = []
    cur = 0

    # An ALU-like 300bp family consensus reused genome-wide with divergence.
    family = random_seq(300, rng)

    def diverge(codes, rate):
        out = codes.copy()
        n_mut = rng.binomial(len(codes), rate)
        if n_mut:
            idx = rng.choice(len(codes), n_mut, replace=False)
            out[idx] = (out[idx] + 1 + rng.integers(0, 3, n_mut)) % 4
        return out

    segdup_bank = []
    while cur < length:
        r = rng.random()
        if r < 0.42:                                  # unique background
            n = int(rng.integers(3000, 12000))
            seg.append(random_seq(n, rng))
        elif r < 0.62:                                # tandem array
            unit = random_seq(int(rng.integers(2, 200)), rng)
            copies = int(rng.integers(5, max(6, 2000 // max(len(unit), 1))))
            arr = diverge(np.tile(unit, copies), 0.01)
            ann.append(('tandem', cur, cur + len(arr)))
            seg.append(arr)
        elif r < 0.74:                                # interspersed family
            seg.append(diverge(family, 0.08))
            ann.append(('family', cur, cur + 300))
        elif r < 0.86 and segdup_bank:                # segdup copy (1-5% div)
            src = segdup_bank[rng.integers(0, len(segdup_bank))]
            dup = diverge(src, rng.uniform(0.01, 0.05))
            if rng.random() < 0.3:                    # inverted duplication
                dup = seqcodec.revcomp(dup)
                ann.append(('inv_dup', cur, cur + len(dup)))
            else:
                ann.append(('segdup', cur, cur + len(dup)))
            seg.append(dup)
        elif r < 0.86:                                # seed a segdup source
            n = int(rng.integers(5000, 20000))
            block = random_seq(n, rng)
            segdup_bank.append(block)
            ann.append(('segdup_src', cur, cur + n))
            seg.append(block)
        elif r < 0.86 + n_gap_prop * 10:              # N-gap
            n = int(rng.integers(100, 5000))
            ann.append(('n_gap', cur, cur + n))
            seg.append(np.full(n, seqcodec.AMBIG, dtype=np.uint8))
        else:                                         # low-complexity run
            unit = random_seq(int(rng.integers(1, 4)), rng)
            n = int(rng.integers(200, 1500))
            arr = np.tile(unit, n // len(unit) + 1)[:n]
            ann.append(('low_complexity', cur, cur + n))
            seg.append(arr)
        cur += len(seg[-1])

    codes = np.concatenate(seg)[:length]
    ann = [(k, p, min(e, length)) for k, p, e in ann if p < length]
    return codes, ann


def bench_sv_len(rng):
    """bench.py's SV length spectrum: uniform in [50, 1500)."""
    return int(rng.integers(50, 1500))


def wide_sv_len(rng):
    """Kilobase SVs: 70% of SVs uniform in [50, 1500), 30% uniform in
    [2000, 10000]."""
    if rng.random() < 0.7:
        return int(rng.integers(50, 1500))
    return int(rng.integers(WIDE_MIN, 10001))


def bench_genome(ref_len, seed, hap_seeds=None, sv_len=bench_sv_len):
    """The diploid sample of bench.py's build_genome (no cache): (ref, h1,
    h2, truth of h1, truth of h2), the truths as Mutator.truth lists;
    haplotype seeds default to bench.py's (seed + 1, seed + 2). ``sv_len``
    draws an SV's length from a haplotype's rng (default: bench.py's
    draw)."""
    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)
    s1, s2 = hap_seeds or (seed + 1, seed + 2)

    def make_hap(seed2, with_inv):
        rng2 = np.random.default_rng(seed2)
        mut = Mutator(ref)
        pos = 2000
        inv_planted = False
        while pos < ref_len - 20000:
            r = rng2.random()
            if r < 0.80:
                mut.snv(pos, rng=rng2)
            elif r < 0.95:
                ln = int(rng2.integers(1, 25))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            elif r < 0.985:
                ln = sv_len(rng2)
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            else:
                if with_inv and not inv_planted and pos < ref_len - 40000:
                    mut.inv(pos, int(rng2.integers(3000, 8000)))
                    inv_planted = True
            pos = max(pos + int(rng2.integers(800, 1800)), mut.cursor + 200)
        return mut.finish(), mut.truth

    (h1, t1), (h2, t2) = make_hap(s1, False), make_hap(s2, True)
    return ref, h1, h2, t1, t2


def wide_genome(ref_len, seed):
    """bench_genome with kilobase SVs (wide_sv_len): bench.py's event mix,
    spacing and inversion on h2, 30% of SVs of 2-10 kb, whose DP segments
    take the full-width classes of widths 8193 and 32769."""
    return bench_genome(ref_len, seed, sv_len=wide_sv_len)


# wide_genome's samples, (reference length, seed). WIDE_SMALL (chip_smoke.py
# phase 13a, tests/test_torch_wide_sv.py): seed 29 is the first from 0 whose
# 400 kb genome plants 8-12 SVs of 2-10 kb (10, 32% of its SVs), two of them
# above 8192 bp (an INS of 9109 and a DEL of 9262 bp, both on h1), and on h2
# 2-8 kb SVs with none above 8192 beside them, so that h2's width-8193 class
# is not folded into a width-32769 one (align/aligner/core.py
# _coalesce_buckets folds classes of < 32 items). WIDE16 (phase 13b): wide16,
# bench16's size.
WIDE_SMALL = (400_000, 29)
WIDE16 = (16_000_000, 41)
# The full-width classes of dp_full's wide path that these samples launch.
WIDE_WIDTHS = (8193, 32769)
# wide16's VCF records by pav_tpu on its accelerator branch, on the CPU
# (``python tests/wide_reference.py``; tests/test_torch_wide16_reference.py
# recomputes it): records_digest's (count, SHA-256).
WIDE16_REFERENCE = (23640, '5036b778e70850ab0c38db657955940f9b13fa29f5665de668aeb91032bcf69f')


def records_digest(vcf_path):
    """(count, SHA-256) of a gzipped VCF's records (its non-header lines,
    joined by newlines)."""
    import gzip
    import hashlib
    with gzip.open(vcf_path, 'rt') as fh:
        recs = [line for line in fh.read().splitlines() if not line.startswith('#')]
    return len(recs), hashlib.sha256('\n'.join(recs).encode()).hexdigest()


def repeat_genome(ref_len, seed):
    """The repeat-rich sample of bench.py (repeat_rich_ref + its mutator)."""
    rrng = np.random.default_rng(seed)
    rref, _ = repeat_rich_ref(ref_len, rrng)
    rmut = Mutator(rref)
    pos = 2000
    while pos < len(rref) - 20000:
        r = rrng.random()
        if r < 0.8:
            if rref[pos] < 4:
                rmut.snv(pos, rng=rrng)
        elif r < 0.97:
            ln = int(rrng.integers(1, 40))
            if rrng.random() < 0.5:
                rmut.ins(pos, random_seq(ln, rrng))
            else:
                rmut.dele(pos, ln)
        else:
            ln = int(rrng.integers(50, 1200))
            if rrng.random() < 0.5:
                rmut.ins(pos, random_seq(ln, rrng))
            else:
                rmut.dele(pos, ln)
        pos = max(pos + int(rrng.integers(900, 2000)), rmut.cursor + 200)
    return rref, rmut.finish()


def e2e_genome():
    """The genome of tests/test_pipeline_e2e.py."""
    rng = np.random.default_rng(71)
    ref = random_seq(150000, rng)
    m1 = Mutator(ref)
    m1.snv(10000, rng=rng)
    m1.ins(20000, random_seq(12, rng))
    m1.dele(30000, 7)
    m1.ins(50000, random_seq(250, rng))
    m1.dele(70000, 400)
    m1.snv(90000, rng=rng)
    h1 = m1.finish()
    m2 = Mutator(ref)
    m2.snv(10000, alt=int(m1.truth[0]['alt'] == 'A'), rng=rng)
    m2.pieces[-1] = np.array(['ACGT'.index(m1.truth[0]['alt'])], dtype=np.uint8)
    m2.ins(50000, np.array(['ACGT'.index(c) for c in m1.truth[3]['seq']],
                           dtype=np.uint8))
    m2.snv(60000, rng=rng)
    m2.inv(100000, 4000)
    return ref, h1, m2.finish()


# ------------------------------------------------------ planted truth

def truth_to_df(truth, chrom='chr1'):
    """Mutator truth records as a call table (tests/test_recall.py's)."""
    import pandas as pd
    rows = []
    for t in truth:
        if t['type'] == 'SNV':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'SNV', 1, t['ref'], t['alt']))
        elif t['type'] == 'INS':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'INS', t['len'], 'N', 'N'))
        elif t['type'] == 'DEL':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'DEL', t['len'], 'N', 'N'))
        elif t['type'] == 'INV':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'INV', t['len'], 'N', 'N'))
    df = pd.DataFrame(rows, columns=['#CHROM', 'POS', 'END', 'SVTYPE', 'SVLEN', 'REF', 'ALT'])
    df['ID'] = [f'truth{i}' for i in range(df.shape[0])]
    df['FILTER'] = 'PASS'
    df['GT'] = '1'
    return df


def _size_bin(truth, calls, min_len):
    """INS and DEL of SVLEN >= min_len: recall of the bin's truth against
    the whole callset, precision of the bin's calls against the whole
    truth (eval's matching, PASS calls only, as eval.concordance)."""
    import pandas as pd
    from . import eval as ev
    calls = calls.loc[calls['FILTER'].isin(['PASS', '.'])]
    rows = []
    for svtype in ('INS', 'DEL'):
        tp_t, n_t = ev._match_class(truth.loc[truth['SVLEN'] >= min_len], calls, svtype)
        tp_c, n_c = ev._match_class(calls.loc[calls['SVLEN'] >= min_len], truth, svtype)
        rows.append((svtype, n_t, n_c, tp_t / n_t if n_t else np.nan,
                     tp_c / n_c if n_c else np.nan))
    return pd.DataFrame(rows, columns=['SVTYPE', 'N_TRUTH', 'N_CALL', 'RECALL', 'PRECISION'])


def truth_report(vcf_path, truth, min_len=None):
    """(report, misses): the concordance of a VCF with planted truth by
    class (pav_tpu_torch.eval, the matching of tests/test_recall.py, the
    truth deduplicated as there) and the RECALL_FLOORS it misses. With
    ``min_len``, the INS and DEL of SVLEN >= min_len only (_size_bin),
    held to the INS and DEL floors."""
    from . import eval as ev
    want = truth_to_df(truth).drop_duplicates(subset=['POS', 'SVTYPE', 'SVLEN', 'ALT'])
    calls = ev.read_vcf(vcf_path)
    if min_len is None:
        rep = ev.concordance(want, calls).set_index('SVTYPE')
    else:
        rep = _size_bin(want, calls, min_len).set_index('SVTYPE')
    misses = [f'{cls} {col} {rep.loc[cls, col]:.4f} < {floor}'
              for cls, col, floor in RECALL_FLOORS
              if cls in rep.index and not rep.loc[cls, col] >= floor]
    if min_len is None and not rep.loc['INV', 'N_TRUTH'] >= 1:
        misses.append('no INV in the truth')
    return rep, misses


def hold_to_truth(label, vcf_path, truth):
    """Exit nonzero unless the VCF meets RECALL_FLOORS against planted
    truth; prints the concordance table either way."""
    import time
    t0 = time.time()
    rep, misses = truth_report(vcf_path, truth)
    print(f'{label} against planted truth ({time.time() - t0:.1f} s):\n{rep.to_string()}',
          flush=True)
    if misses:
        raise SystemExit(f'FAILED: {label} misses the recall floors: {"; ".join(misses)}')
    print(f'{label}: every recall floor met', flush=True)
