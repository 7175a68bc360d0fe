"""The port on test_repeat_stress.py's 3 Mbp repeat-rich genome, held
against pav_tpu on the CPU.

The genome, its planted variants and the config are the reference test's
(seeds 13 and 99). The port runs on ``device='cpu'``, its CPU class ladder,
against the unforced reference: the reference's accelerator branch would
run the wavefront band's plain version on the CPU, far slower at this
size (test_torch_aligner.py covers that ladder on a 250 kb repeat-rich
genome). Held: the N-gap table, the alignment tables, every stage table
and the integrated and merged calls.
"""

import os

import numpy as np
import pandas as pd
import pytest

from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.pipeline import _HAP_ARTIFACTS
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import affine_dp
from pav_tpu_torch.pipeline import Pipeline

from helpers import Mutator, random_seq, repeat_rich_ref

CONFIG = {'aligner_min_chain_score': 1000}


def _genome():
    """test_repeat_stress.py's ``repeat_run`` inputs: (ref, hap, planted)."""
    rng = np.random.default_rng(13)
    ref, ann = repeat_rich_ref(3_000_000, rng)
    covered = np.zeros(len(ref), dtype=bool)
    for _, p, e in ann:
        covered[max(p - 500, 0):e + 500] = True
    mut = Mutator(ref)
    planted = 0
    pos = 50000
    rng2 = np.random.default_rng(99)
    while pos < len(ref) - 50000:
        if not covered[pos:pos + 1200].any():
            r = rng2.random()
            if r < 0.6:
                mut.snv(pos, rng=rng2)
            elif r < 0.85:
                ln = int(rng2.integers(1, 30))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            else:
                ln = int(rng2.integers(60, 900))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            planted += 1
        pos += 2500
    return ref, mut.finish(), planted


@pytest.fixture(scope='module')
def runs():
    ref, hap, planted = _genome()
    assert planted > 100
    log = open(os.devnull, 'w')
    ref_pipe = RefPipeline(RefSeqStore({'chr1': ref}), dict(CONFIG), log=log)
    want = ref_pipe.run_sample('rep', {'h1': RefSeqStore({'tig1': hap})}, write_vcf=False)
    affine_dp.stats_reset()
    port_pipe = Pipeline(SeqStore({'chr1': ref}), dict(CONFIG), log=log, device='cpu')
    got = port_pipe.run_sample('rep', {'h1': SeqStore({'tig1': hap})}, write_vcf=False)
    classes = dict(affine_dp.STATS['classes'])
    return ref, (ref_pipe, want), (port_pipe, got), classes


def test_n_gap_tables_equal(runs):
    ref, (ref_pipe, _), (port_pipe, _), _ = runs
    assert port_pipe.n_gaps.shape[0] > 0
    pd.testing.assert_frame_equal(port_pipe.n_gaps, ref_pipe.n_gaps)
    pd.testing.assert_frame_equal(SeqStore({'chr1': ref}).n_gap_table(),
                                  RefSeqStore({'chr1': ref}).n_gap_table())


def test_alignment_tables_equal(runs):
    """The alignment tables, through the CPU ladder's row bands."""
    ref, (_, want), (_, got), classes = runs
    res = got['haps']['h1']
    for attr in ('align_none', 'align_qry', 'align_qryref'):
        pd.testing.assert_frame_equal(getattr(res, attr), getattr(want['haps']['h1'], attr),
                                      obj=attr)
    aligned_bp = int((res.align_qryref['END'] - res.align_qryref['POS']).sum())
    assert aligned_bp > 0.9 * len(ref)
    assert any(width < max_n + 1 for _, max_n, width, _ in classes), 'no row band ran'


def test_stage_tables_and_calls_equal(runs):
    """Every stage table, the integrated calls (PASS and FAIL) and the
    merged calls."""
    _, (_, want), (_, got), _ = runs
    g, w = got['haps']['h1'], want['haps']['h1']
    for _, attr in _HAP_ARTIFACTS:
        pd.testing.assert_frame_equal(getattr(g, attr), getattr(w, attr), obj=attr)
    assert set(g.integrated) == set(w.integrated)
    for key, (want_pass, want_fail) in w.integrated.items():
        pd.testing.assert_frame_equal(g.integrated[key][0], want_pass, obj=f'{key} pass')
        pd.testing.assert_frame_equal(g.integrated[key][1], want_fail, obj=f'{key} fail')
    assert set(got['merged']) == set(want['merged'])
    for key, df in want['merged'].items():
        pd.testing.assert_frame_equal(got['merged'][key], df, obj=str(key))
    assert got['merged'][('snv_snv', 'pass')].shape[0] > 100
