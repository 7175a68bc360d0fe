"""The frozen generator against the program's: for the values of
bench_mix and hprc_chr21 each piece that the cohort runs (plant_hap,
_cuts, contigs) draws what synth's does, base for base, at 1/200 scale;
the T2T layout keeps one forward contig a haplotype chromosome; a run's
individuals are planted on the one reference it wrote."""

import json
import os

import numpy as np
import pytest

from cpu_harness import BENCH, load

gen = load(os.path.join(BENCH, 'gen.py'), 'bench_gen')


def data(kind, name):
    with open(os.path.join(BENCH, kind, name + '.json')) as fh:
        return json.load(fh)


def same_haps(a, b):
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize('seed', [0, 3])
def test_plant_hap_and_cuts_match_synth(seed):
    from pav_tpu_torch import synth
    mix, layout = data('mixes', 'bench_mix'), data('configs', 'hprc_chr21')['layout']
    (chrom, length), = synth.ASM_TINY[0][:1]
    ref = synth.random_seq(length, np.random.default_rng(seed))
    for with_inv in (False, True):
        want = synth.plant_hap(ref, seed + 1, with_inv)
        got = gen.plant_hap(ref, seed + 1, with_inv, mix)
        assert np.array_equal(want[0], got[0]) and want[1] == got[1]
        cuts = (synth._cuts(want[1], length, np.random.default_rng([seed, 5])),
                gen._cuts(got[1], length, np.random.default_rng([seed, 5]), layout))
        assert cuts[0] == cuts[1]


@pytest.mark.parametrize('seed', [0, 3])
def test_contigs_match_synth_asm_genome(seed):
    """synth.asm_genome's haplotypes cut by gen.contigs with synth's
    layout draws give synth's contigs and layout."""
    from pav_tpu_torch import synth
    chroms = synth.ASM_TINY[0]
    want = synth.asm_genome(chroms, seed)
    haps, truths = ({}, {}), ({}, {})
    for index, (chrom, length) in enumerate(chroms):
        _, h1, h2, t1, t2 = synth.asm_chrom(length, seed, index)
        haps[0][chrom], haps[1][chrom], truths[0][chrom], truths[1][chrom] = h1, h2, t1, t2
    h1, h2, where = gen.contigs(haps, truths, chroms, np.random.default_rng([seed, 1]),
                                data('configs', 'hprc_chr21')['layout'])
    assert same_haps(want[1], h1) and same_haps(want[2], h2) and want[5] == where


def test_t2t_layout_one_forward_contig():
    chroms = gen.scaled(data('configs', 't2t_chr21')['chromosomes'], 200)
    ref = gen.cohort_reference(chroms, 12345)
    mix, layout = data('mixes', 'pub_mix'), data('configs', 't2t_chr21')['layout']
    h1, h2, truth, where = gen.cohort_individual(ref, chroms, [12345], 1, mix, layout)
    assert list(h1) == ['h1_tig1'] and list(h2) == ['h2_tig1']
    assert all(w['strand'] == '+' and w['start'] == 0 for w in where.values())
    assert sum(t['type'] == 'INV' for t in truth['h2']) == 1
    assert not any(t['type'] == 'INV' for t in truth['h1'])
    hprc = gen.cohort_individual(ref, chroms, [12345], 1, mix,
                                 data('configs', 'hprc_chr21')['layout'])
    assert hprc[2] == truth       # the same events in both cells, cut otherwise


def test_pub_mix_densities():
    """pub_mix plants its stated events a haplotype Mbp, within 5%."""
    mix = data('mixes', 'pub_mix')
    ref = gen.random_seq(2_000_000, np.random.default_rng(1))
    _, truth = gen.plant_hap(ref, 2, False, mix)
    mbp = (len(ref) - mix['start'] - mix['end_margin']) / 1e6
    kinds = {'snv': 0, 'indel': 0, 'sv': 0}
    for t in truth:
        kinds['snv' if t['type'] == 'SNV' else 'indel' if t['len'] < 50 else 'sv'] += 1
    for kind, want in mix['per_hap_per_mbp'].items():
        tol = 0.05 if kind != 'sv' else 0.25      # 13 SVs in 2 Mbp
        assert abs(kinds[kind] / mbp / want - 1) < tol, (kind, kinds[kind] / mbp)


def test_seed_sets_the_inputs(tmp_path):
    cfg = dict(data('configs', 'hprc_chr21'))
    cfg['chromosomes'] = gen.scaled(cfg['chromosomes'], 400)
    mix = data('mixes', 'pub_mix')
    for out in ('a', 'b'):
        (tmp_path / out).mkdir()
        for part in ('ref', '1'):
            gen.write_part(str(tmp_path / out), cfg, mix, 2**31 + 11, part)
    for name in ('ref.fa', 'IND1_h1.fa', 'IND1_h2.fa', 'IND1.truth.json'):
        assert (tmp_path / 'a' / name).read_bytes() == (tmp_path / 'b' / name).read_bytes()
    # the individual is planted on the reference that 'ref' wrote
    truth = json.loads((tmp_path / 'a' / 'IND1.truth.json').read_text())['truth']
    ref = gen.cohort_reference([tuple(c) for c in cfg['chromosomes']], 2**31 + 11)
    snv = next(t for t in truth['h1'] if t['type'] == 'SNV')
    assert gen.BASES[ref[snv['chrom']][snv['pos']]] == snv['ref']
