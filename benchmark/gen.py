"""The benchmark's sample generator: a reference, diploid assemblies with
planted truth, and their FASTA files. NumPy only; imports nothing of the
program.

Frozen copy of ``pav_tpu_torch/synth.py`` at commit ea5ac27 (``random_seq``,
``Mutator``, ``plant_hap``, ``_cuts`` and ``asm_genome``'s cutting loop, here
``contigs``), with the event spectrum read from a traffic mix
(``mixes/<mix>.json``) and the contig layout from a configuration
(``configs/<config>.json``) instead of constants. For the values of
``mixes/bench_mix.json`` and ``configs/hprc_chr21.json`` each piece draws
what synth's does, base for base (the tests hold it).

A cohort (``cohort_*``) is what one run measures: one reference from the
run's seed and the configuration's individuals, each planted from a seed of
its own against that reference. ``python benchmark/gen.py OUT_DIR CONFIG
MIX SEED WHAT`` writes one part of it (``ref``, then an individual's number,
or ``warmup``) into OUT_DIR, so that the measuring process never holds the
generator's arrays; an individual reads the reference that ``ref`` wrote.
"""

import json
import os
import sys

import numpy as np

BASES = 'ACGT'
_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
FASTA_WIDTH = 80
# The reference seed paths: rng([seed, REF_PATH, chromosome index]); the
# individuals take [seed, k] for k = 1, 2, ...; the warm-up sample its own.
REF_PATH = 0
WARMUP_PATH = 1_000_003


def revcomp(codes):
    return _COMP[np.asarray(codes, dtype=np.uint8)][::-1].copy()


def decode(codes):
    return _DECODE[np.minimum(np.asarray(codes, dtype=np.uint8), 4)].tobytes().decode('ascii')


def random_seq(n, rng, gc=0.5):
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


class Mutator:
    """Applies mutations at reference coordinates, in ascending order, and
    keeps their truth records."""

    def __init__(self, ref_codes):
        self.ref = np.asarray(ref_codes, dtype=np.uint8)
        self.pieces = []
        self.cursor = 0
        self.truth = []

    def _advance(self, pos):
        if pos < self.cursor:
            raise ValueError('Mutations must be applied in ascending order')
        self.pieces.append(self.ref[self.cursor:pos])
        self.cursor = pos

    def snv(self, pos, rng):
        self._advance(pos)
        ref_base = int(self.ref[pos])
        alt = int(rng.choice([b for b in range(4) if b != ref_base]))
        self.pieces.append(np.array([alt], dtype=np.uint8))
        self.cursor = pos + 1
        self.truth.append({'type': 'SNV', 'pos': pos, 'ref': BASES[ref_base], 'alt': BASES[alt]})

    def ins(self, pos, seq_codes):
        self._advance(pos)
        seq_codes = np.asarray(seq_codes, dtype=np.uint8)
        self.pieces.append(seq_codes)
        self.truth.append({'type': 'INS', 'pos': pos, 'len': len(seq_codes),
                           'seq': decode(seq_codes)})

    def dele(self, pos, length):
        self._advance(pos)
        self.cursor = pos + length
        self.truth.append({'type': 'DEL', 'pos': pos, 'len': length,
                           'seq': decode(self.ref[pos:pos + length])})

    def inv(self, pos, length):
        self._advance(pos)
        self.pieces.append(revcomp(self.ref[pos:pos + length]))
        self.cursor = pos + length
        self.truth.append({'type': 'INV', 'pos': pos, 'len': length})

    def finish(self):
        self._advance(len(self.ref))
        return np.concatenate(self.pieces) if self.pieces else np.zeros(0, dtype=np.uint8)


def plant_hap(ref, seed, with_inv, mix):
    """One haplotype: the mix's events planted on ``ref`` from ``seed``, an
    inversion where ``with_inv``. The draws are bench.py's build_genome's,
    in its order: per site a uniform r against the cumulative thresholds
    (SNV, indel, SV; above them an inversion, else nothing), then the next
    site. Returns (haplotype codes, truth records)."""
    cut = mix['thresholds']
    ilo, ihi = mix['indel_len']
    slo, shi = mix['sv_len']
    vlo, vhi = mix['inv_len']
    glo, ghi = mix['spacing']
    ref_len = len(ref)
    rng = np.random.default_rng(seed)
    mut = Mutator(ref)
    pos = mix['start']
    inv_planted = False
    while pos < ref_len - mix['end_margin']:
        r = rng.random()
        if r < cut['snv']:
            mut.snv(pos, rng)
        elif r < cut['sv']:
            lo, hi = (ilo, ihi) if r < cut['indel'] else (slo, shi)
            ln = int(rng.integers(lo, hi))
            if rng.random() < 0.5:
                mut.ins(pos, random_seq(ln, rng))
            else:
                mut.dele(pos, ln)
        elif with_inv and not inv_planted and pos < ref_len - mix['inv_end_margin']:
            mut.inv(pos, int(rng.integers(vlo, vhi)))
            inv_planted = True
        pos = max(pos + int(rng.integers(glo, ghi)), mut.cursor + mix['min_after'])
    return mut.finish(), mut.truth


def _cuts(truth, ref_len, rng, layout):
    """The cuts of one haplotype's copy of a chromosome, in order:
    [((ref, hap) cut, (ref, hap) overlap end or None)], each at the midpoint
    of a gap between planted events, where both coordinates map exactly.
    The right contig starts at the cut; the left one ends there or runs on
    to the overlap end."""
    spans = np.array([(t['pos'], t['pos'] + (t['len'] if t['type'] in ('DEL', 'INV') else 1))
                      for t in truth], dtype=np.int64).reshape(-1, 2)
    shift = np.cumsum([t['len'] if t['type'] == 'INS' else -t['len'] if t['type'] == 'DEL'
                       else 0 for t in truth], dtype=np.int64)
    mids = (spans[:-1, 1] + spans[1:, 0]) // 2
    hmids = mids + shift[:-1]
    least = -(-ref_len // layout['min_share'])
    olo, ohi = layout['overlap_bp']
    k = int(rng.integers(layout['cuts'][0], layout['cuts'][1] + 1))
    while True:
        at = np.unique(np.searchsorted(mids, rng.integers(0, ref_len, k)).clip(0, len(mids) - 1))
        edges = np.concatenate([[0], mids[at], [ref_len]])
        if len(at) == k and np.diff(edges).min() >= least:
            break
    cuts = []
    for i in at:
        end = None
        if rng.random() < layout['overlap_p']:
            target = hmids[i] + int(rng.integers(olo, ohi + 1))
            room = np.nonzero((hmids - hmids[i] >= olo) & (hmids - hmids[i] <= ohi))[0]
            j = room[np.argmin(np.abs(hmids[room] - target))]
            end = (int(mids[j]), int(hmids[j]))
        cuts.append(((int(mids[i]), int(hmids[i])), end))
    return cuts


def contigs(haps, truths, chroms, rng, layout):
    """Cut each haplotype's chromosome copies into contigs by ``layout``.
    ``haps`` and ``truths`` are ({chrom: codes}, ...) and ({chrom: truth},
    ...) per haplotype. With no cuts a haplotype keeps one contig a
    chromosome. Returns ({contig: codes} per haplotype, layout {contig:
    {hap, chrom, start, end, strand, ref_start, ref_end}})."""
    pieces = ([], [])
    for chrom, length in chroms:
        for h in range(2):
            hap, truth = haps[h][chrom], truths[h][chrom]
            cuts = _cuts(truth, length, rng, layout) if layout['cuts'][1] > 0 else []
            starts = [(0, 0)] + [cut for cut, _ in cuts]
            ends = [end or cut for cut, end in cuts] + [(length, len(hap))]
            for (r0, s0), (r1, s1) in zip(starts, ends):
                flip = layout['reverse_p'] > 0 and rng.random() < layout['reverse_p']
                strand = '-' if flip else '+'
                tig = hap[s0:s1] if strand == '+' else revcomp(hap[s0:s1])
                pieces[h].append((tig, dict(chrom=chrom, start=s0, end=s1, strand=strand,
                                            ref_start=r0, ref_end=r1)))
    out, where = ({}, {}), {}
    for h, hap in enumerate(('h1', 'h2')):
        order = rng.permutation(len(pieces[h])) if layout['shuffle'] else range(len(pieces[h]))
        names = [f'{hap}_tig{k + 1}' for k in order]
        for name, (tig, w) in sorted(zip(names, pieces[h]), key=lambda x: x[0]):
            out[h][name] = tig
            where[name] = dict(w, hap=hap)
    return out[0], out[1], where


# ------------------------------------------------------------ the cohort

def scaled(chroms, scale):
    return [(chrom, round(length / scale)) for chrom, length in chroms]


def cohort_reference(chroms, seed, path=REF_PATH):
    """The run's reference: chromosome i from rng([seed, path, i])."""
    return {chrom: random_seq(length, np.random.default_rng([seed, path, i]))
            for i, (chrom, length) in enumerate(chroms)}


def cohort_individual(ref, chroms, key, k, mix, layout):
    """Individual ``k`` of the run's cohort against ``ref``, from the seed
    path ``key`` (a list of ints): haplotype h's copy of chromosome i
    planted from rng([*key, k, 1 + h, i]) (the inversion on the mix's
    haplotypes), cut by ``layout`` from rng([layout['seed'], k]): the
    layout's draws do not depend on the run's seed, so every run cuts its
    individual k at the same places (to the nearest gap between events)
    and the seed changes the bases and the events alone."""
    haps, truths = ({}, {}), ({}, {})
    for i, (chrom, _) in enumerate(chroms):
        for h, hap in enumerate(('h1', 'h2')):
            haps[h][chrom], truths[h][chrom] = plant_hap(
                ref[chrom], [*key, k, 1 + h, i], hap in mix['inv_haps'], mix)
    h1, h2, where = contigs(haps, truths, chroms, np.random.default_rng([layout['seed'], k]),
                            layout)
    flat = {hap: [dict(t, chrom=chrom) for chrom, _ in chroms for t in truths[h][chrom]]
            for h, hap in enumerate(('h1', 'h2'))}
    return h1, h2, flat, where


def write_fasta(seqs, path):
    """{name: codes} -> FASTA with FASTA_WIDTH bases a line."""
    with open(path, 'wb') as fh:
        for name, codes in seqs.items():
            fh.write(f'>{name}\n'.encode())
            raw = _DECODE[np.minimum(codes, 4)]
            full = len(raw) // FASTA_WIDTH * FASTA_WIDTH
            if full:
                lines = np.concatenate(
                    [raw[:full].reshape(-1, FASTA_WIDTH),
                     np.full((full // FASTA_WIDTH, 1), ord('\n'), dtype=np.uint8)], axis=1)
                fh.write(lines.tobytes())
            if full < len(raw):
                fh.write(raw[full:].tobytes() + b'\n')


def sample_name(k):
    return 'WARMUP' if k == 0 else f'IND{k}'


def write_part(out_dir, config, mix, seed, what):
    """Write one part of a run's inputs: ``ref`` (ref.fa, and ref.npz for
    the individuals), individual ``k`` (IND<k>_h1.fa, IND<k>_h2.fa,
    IND<k>.truth.json) or ``warmup``
    (its own reference at 1 / mix['warmup_scale'] and one individual)."""
    chroms = [tuple(c) for c in config['chromosomes']]
    layout = config['layout']
    if what == 'ref':
        ref = cohort_reference(chroms, seed)
        np.savez(os.path.join(out_dir, 'ref.npz'), **ref)
        write_fasta(ref, os.path.join(out_dir, 'ref.fa'))
        return
    if what == 'warmup':
        chroms = scaled(chroms, mix['warmup_scale'])
        ref = cohort_reference(chroms, seed, WARMUP_PATH)
        write_fasta(ref, os.path.join(out_dir, 'warmup_ref.fa'))
        k, key = 0, [seed, WARMUP_PATH]
    else:
        k = int(what)
        with np.load(os.path.join(out_dir, 'ref.npz')) as saved:
            ref = {chrom: saved[chrom] for chrom, _ in chroms}
        key = [seed]
    h1, h2, truth, where = cohort_individual(ref, chroms, key, k, mix, layout)
    name = sample_name(k)
    write_fasta(h1, os.path.join(out_dir, f'{name}_h1.fa'))
    write_fasta(h2, os.path.join(out_dir, f'{name}_h2.fa'))
    with open(os.path.join(out_dir, f'{name}.truth.json'), 'w') as fh:
        json.dump({'truth': truth, 'layout': where,
                   'contig_bp': int(sum(len(s) for s in h1.values())
                                    + sum(len(s) for s in h2.values()))}, fh)


if __name__ == '__main__':
    out, config_path, mix_path, seed, what = sys.argv[1:6]
    with open(config_path) as fh:
        cfg = json.load(fh)
    with open(mix_path) as fh:
        mx = json.load(fh)
    write_part(out, cfg, mx, int(seed), what)
