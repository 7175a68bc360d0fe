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


def plant_hap(ref, seed, with_inv, sv_len=bench_sv_len):
    """bench.py's build_genome haplotype: its event mix and spacing planted
    on ``ref`` from ``seed`` (one inversion where ``with_inv``). Returns
    (haplotype codes, Mutator.truth)."""
    ref_len = len(ref)
    rng2 = np.random.default_rng(seed)
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


def bench_genome(ref_len, seed, hap_seeds=None, sv_len=bench_sv_len):
    """The diploid sample of bench.py's build_genome (no cache): (ref, h1,
    h2, truth of h1, truth of h2), the truths as Mutator.truth lists;
    haplotype seeds default to bench.py's (seed + 1, seed + 2). ``sv_len``
    draws an SV's length from a haplotype's rng (default: bench.py's
    draw)."""
    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)
    s1, s2 = hap_seeds or (seed + 1, seed + 2)
    (h1, t1), (h2, t2) = plant_hap(ref, s1, False, sv_len), plant_hap(ref, s2, True, sv_len)
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


# ------------------------------------------------ assembly-shaped samples

# GRCh38's chr21 and chr22 (primary assembly, GenBank GCA_000001405.15;
# UCSC hg38.chrom.sizes).
GRCH38_CHR21_22 = (('chr21', 46_709_983), ('chr22', 50_818_468))
# Fragmentation: each haplotype's copy of a chromosome is cut at 1-3
# points (mean 2 a chromosome, about one cut per 24 Mbp), each contig at
# least a tenth of its chromosome: a contig NG50 of roughly 20-35 Mbp at
# full length, the order HiFi haplotype assemblies reach (the HPRC year-1
# assemblies, Liao et al., Nature 2023, report contig NG50s of about 40
# Mb). Stand-ins without a source: half of the cuts leave the two contigs
# sharing 1-10 kb (uniform) of sequence, and a contig is reverse-complemented
# with probability 0.5 (an assembler does not orient contigs to a
# reference).
ASM_CUTS = (1, 3)
ASM_MIN_SHARE = 10          # a contig spans at least 1/ASM_MIN_SHARE of its chromosome
ASM_OVERLAP_P = 0.5
ASM_OVERLAP = (1000, 10000)


def asm_lens(scale):
    """GRCH38_CHR21_22 at 1/scale of their lengths (rounded)."""
    return tuple((chrom, round(length / scale)) for chrom, length in GRCH38_CHR21_22)


# asm_genome's samples, (chromosome lengths, seed). Each seed is the first
# from 0 whose sample has, in each haplotype, a reverse-strand contig, an
# overlapping pair of contigs and contig names out of reference order
# (tests/test_torch_asm.py holds it): asm97 at full length (97,528,451 bp
# of reference), asm10 at 1/10, asm_tiny at 1/200.
ASM97 = (asm_lens(1), 0)
ASM10 = (asm_lens(10), 0)
ASM_TINY = (asm_lens(200), 0)

# asm10's VCF records by pav_tpu on its accelerator branch, on the CPU
# (``python tests/test_torch_asm_reference.py``, which recomputes it in
# tier-1): records_digest's (count, SHA-256).
ASM10_REFERENCE = (14700, '4cf8d495c6f271b1316a074abffbc8bbebd1a74d69d4e6234f28082f18ec8ca0')


def asm_chrom(length, seed, index):
    """Chromosome ``index`` of asm_genome(..., seed): bench_genome's
    reference and haplotypes (bench.py's event mix and spacing, the
    inversion on h2) at ``length``, from a seed of its own."""
    return bench_genome(length, 10 * seed + 3 * index)


def _cuts(truth, ref_len, rng):
    """The cuts of one haplotype's copy of a chromosome, in order:
    [((ref, hap) position of the cut, (ref, hap) position of the overlap
    end or None)]. The right contig starts at the cut; the left one ends
    there or, for an overlap, runs on to the overlap end. Every cut and
    overlap end is the midpoint of a gap between planted events, never
    inside one, where the two coordinates map exactly."""
    spans = np.array([(t['pos'], t['pos'] + (t['len'] if t['type'] in ('DEL', 'INV') else 1))
                      for t in truth], dtype=np.int64).reshape(-1, 2)
    shift = np.cumsum([t['len'] if t['type'] == 'INS' else -t['len'] if t['type'] == 'DEL'
                       else 0 for t in truth], dtype=np.int64)
    mids = (spans[:-1, 1] + spans[1:, 0]) // 2
    hmids = mids + shift[:-1]
    least = -(-ref_len // ASM_MIN_SHARE)
    k = int(rng.integers(ASM_CUTS[0], ASM_CUTS[1] + 1))
    while True:
        at = np.unique(np.searchsorted(mids, rng.integers(0, ref_len, k)).clip(0, len(mids) - 1))
        edges = np.concatenate([[0], mids[at], [ref_len]])
        if len(at) == k and np.diff(edges).min() >= least:
            break
    cuts = []
    for i in at:
        end = None
        if rng.random() < ASM_OVERLAP_P:
            target = hmids[i] + int(rng.integers(ASM_OVERLAP[0], ASM_OVERLAP[1] + 1))
            room = np.nonzero((hmids - hmids[i] >= ASM_OVERLAP[0])
                              & (hmids - hmids[i] <= ASM_OVERLAP[1]))[0]
            j = room[np.argmin(np.abs(hmids[room] - target))]
            end = (int(mids[j]), int(hmids[j]))
        cuts.append(((int(mids[i]), int(hmids[i])), end))
    return cuts


def asm_genome(chrom_lens, seed):
    """A diploid assembly shaped like a user's. Per (chromosome, length) of
    ``chrom_lens``, asm_chrom's reference and two haplotypes; each
    haplotype's copy is cut into contigs (_cuts, sources beside ASM_CUTS),
    each contig reverse-complemented with probability 0.5, and a
    haplotype's contigs are named ``<hap>_tig<k>`` in a shuffled order, so
    FASTA order is not reference order. Returns (ref {chrom: codes}, h1
    {contig: codes}, h2, truth of h1, truth of h2, layout): truth records
    carry their ``chrom``; layout maps each contig to {hap, chrom, start,
    end, strand, ref_start, ref_end}: its span on the haplotype's copy of
    the chromosome (before any reverse complement) and the reference
    positions of its two ends."""
    rng = np.random.default_rng([seed, 1])
    ref, truths, pieces = {}, ([], []), ([], [])
    for index, (chrom, length) in enumerate(chrom_lens):
        codes, h1, h2, t1, t2 = asm_chrom(length, seed, index)
        ref[chrom] = codes
        for h, (hap, truth) in enumerate(((h1, t1), (h2, t2))):
            truths[h].extend(dict(t, chrom=chrom) for t in truth)
            cuts = _cuts(truth, length, rng)
            starts = [(0, 0)] + [cut for cut, _ in cuts]
            ends = [end or cut for cut, end in cuts] + [(length, len(hap))]
            for (r0, s0), (r1, s1) in zip(starts, ends):
                strand = '-' if rng.random() < 0.5 else '+'
                tig = hap[s0:s1] if strand == '+' else seqcodec.revcomp(hap[s0:s1])
                pieces[h].append((tig, dict(chrom=chrom, start=s0, end=s1, strand=strand,
                                            ref_start=r0, ref_end=r1)))
    haps, layout = ({}, {}), {}
    for h, hap in enumerate(('h1', 'h2')):
        names = [f'{hap}_tig{k + 1}' for k in rng.permutation(len(pieces[h]))]
        for name, (tig, where) in sorted(zip(names, pieces[h]), key=lambda x: x[0]):
            haps[h][name] = tig
            layout[name] = dict(where, hap=hap)
    return ref, haps[0], haps[1], truths[0], truths[1], layout


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
    """Mutator truth records as a call table (tests/test_recall.py's), each
    on its record's ``chrom`` (asm_genome's), else on ``chrom``."""
    import pandas as pd
    rows = []
    for t in truth:
        chrom_t = t.get('chrom', chrom)
        if t['type'] == 'SNV':
            rows.append((chrom_t, t['pos'], t['pos'] + 1, 'SNV', 1, t['ref'], t['alt']))
        elif t['type'] == 'INS':
            rows.append((chrom_t, t['pos'], t['pos'] + 1, 'INS', t['len'], 'N', 'N'))
        elif t['type'] == 'DEL':
            rows.append((chrom_t, t['pos'], t['pos'] + t['len'], 'DEL', t['len'], 'N', 'N'))
        elif t['type'] == 'INV':
            rows.append((chrom_t, t['pos'], t['pos'] + t['len'], 'INV', t['len'], 'N', 'N'))
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
    want = truth_to_df(truth).drop_duplicates(subset=['#CHROM', 'POS', 'SVTYPE', 'SVLEN', 'ALT'])
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
