"""wide16's reference digest, recomputed from ``pav_tpu`` on the CPU.

chip_smoke.py phase 13b holds the card's VCF of wide16
(``synth.wide_genome(*synth.WIDE16)``: 16 Mbp, seed 41, diploid) to
``synth.WIDE16_REFERENCE``, the count and SHA-256 of the records that
``pav_tpu`` writes for it on its accelerator branch (the classes of the
port's CUDA path). The card has no JAX, so this test is where that
constant is held to the reference: it runs ``pav_tpu`` on the sample
(tests/wide_reference.py; about 45 s and 4 GiB here) and compares. The same
VCF meets the planted truth's floors, overall and in the >= 2 kb bin.
"""

import pytest

from pav_tpu_torch import synth

from wide_reference import run_reference


@pytest.fixture(scope='module')
def wide16(tmp_path_factory):
    genome = synth.wide_genome(*synth.WIDE16)
    res, _ = run_reference(genome, str(tmp_path_factory.mktemp('wide16_ref')), 'accel')
    return genome, res['vcf']


def test_wide16_reference_digest(wide16):
    _, vcf = wide16
    assert synth.records_digest(vcf) == synth.WIDE16_REFERENCE


@pytest.mark.parametrize('min_len', [None, synth.WIDE_MIN], ids=['all', 'wide'])
def test_wide16_reference_meets_floors(wide16, min_len):
    """The reference's VCF against the planted truth: RECALL_FLOORS over
    every class, and the INS and DEL floors in the >= 2 kb bin, which phase
    13b holds the card to."""
    genome, vcf = wide16
    rep, misses = synth.truth_report(vcf, genome[3] + genome[4], min_len=min_len)
    assert misses == [], rep
