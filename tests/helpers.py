"""Synthetic-genome test fixtures.

The reference ships no automated tests (SURVEY.md §4); this framework's test
strategy is truth-based: generate a random reference, apply known mutations to
produce haplotypes, cut them into contigs, then verify the engine recovers the
planted variants.
"""

import numpy as np

from pav_tpu import seqcodec

BASES = 'ACGT'


def random_seq(n, rng, gc=0.5):
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def random_seq_str(n, rng, gc=0.5):
    return seqcodec.decode(random_seq(n, rng, gc))


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


def make_diploid(ref_len=60000, seed=7, n_snv=40, n_indel=20, sv_spec=(('INS', 300), ('DEL', 400)),
                 inv_spec=()):
    """Build (ref_store_dict, {hap: mutant_codes}, truth) with deterministic layout."""
    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)

    def mutate(seed2):
        rng2 = np.random.default_rng(seed2)
        mut = Mutator(ref)
        n_events = n_snv + n_indel + len(sv_spec) + len(inv_spec)
        positions = np.sort(rng2.choice(
            np.arange(2000, ref_len - 2000), size=n_events * 3, replace=False))[::3][:n_events]
        kinds = (['SNV'] * n_snv + ['INDEL'] * n_indel
                 + [f'SV:{t}:{l}' for t, l in sv_spec] + [f'INV:{l}' for l in inv_spec])
        rng2.shuffle(kinds)
        for pos, kind in zip(positions, kinds):
            pos = int(pos)
            if kind == 'SNV':
                mut.snv(pos, rng=rng2)
            elif kind == 'INDEL':
                ln = int(rng2.integers(1, 20))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            elif kind.startswith('SV:'):
                _, t, l = kind.split(':')
                if t == 'INS':
                    mut.ins(pos, random_seq(int(l), rng2))
                else:
                    mut.dele(pos, int(l))
            elif kind.startswith('INV:'):
                mut.inv(pos, int(kind.split(':')[1]))
        return mut.finish(), mut.truth

    h1, truth1 = mutate(seed + 1)
    h2, truth2 = mutate(seed + 2)
    return ref, {'h1': h1, 'h2': h2}, {'h1': truth1, 'h2': truth2}


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


def write_two_hap_sample(d, h2_cut=None):
    """The 200 kb diploid sample of the port's CLI tests, written under
    ``d`` with the port's FASTA writer: ref.fa (chr1), h1.fa (tig1: an SNV,
    a 300 bp deletion, another SNV), h2.fa (tig2: its own SNV and a 25 bp
    insertion; cut at ``h2_cut`` into tig2a and tig2b where given) and
    asm.tsv (sample S1). Returns the CLI's input arguments and the
    contigs' lengths."""
    from pav_tpu_torch import seqcodec as torch_codec
    from pav_tpu_torch.io.fasta import write_fasta

    rng = np.random.default_rng(7)
    ref = random_seq(200000, rng)
    m1 = Mutator(ref)
    m1.snv(5000, rng=rng)
    m1.dele(50000, 300)
    m1.snv(120000, rng=rng)
    m2 = Mutator(ref)
    m2.snv(30000, rng=rng)
    m2.ins(90000, random_seq(25, rng))
    h1, h2 = m1.finish(), m2.finish()
    tigs2 = ({'tig2': h2} if h2_cut is None
             else {'tig2a': h2[:h2_cut], 'tig2b': h2[h2_cut:]})
    write_fasta({'chr1': torch_codec.decode(ref)}, str(d / 'ref.fa'))
    write_fasta({'tig1': torch_codec.decode(h1)}, str(d / 'h1.fa'))
    write_fasta({k: torch_codec.decode(v) for k, v in tigs2.items()}, str(d / 'h2.fa'))
    (d / 'asm.tsv').write_text(f'NAME\tHAP_h1\tHAP_h2\nS1\t{d / "h1.fa"}\t{d / "h2.fa"}\n')
    lengths = {'tig1': len(h1), **{k: len(v) for k, v in tigs2.items()}}
    return ['--ref', str(d / 'ref.fa'), '--assemblies', str(d / 'asm.tsv'),
            '--device', 'cpu'], lengths
