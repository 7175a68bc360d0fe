"""asm10's reference digest, recomputed from ``pav_tpu`` on the CPU.

    JAX_PLATFORMS=cpu python tests/test_torch_asm_reference.py [--sample ASM10]

chip_smoke.py phase 14a holds the card's VCF of asm10
(``synth.asm_genome(*synth.ASM10)``: GRCh38's chr21 and chr22 at 1/10 of
their lengths, each haplotype in contigs on both strands, some of them
overlapping) to ``synth.ASM10_REFERENCE``, the count and SHA-256 of the
records that ``pav_tpu`` writes for it on its accelerator branch (the
classes of the port's CUDA path). The card has no JAX, so this test is
where that constant is held to the reference: it runs ``pav_tpu`` on the
sample (about 30 s and 3 GiB here) and compares. The same VCF meets the
planted truth's floors, and both inversions (one on each chromosome's h2)
are called. Run as a script, the file prints the digest and the
concordance of any ``synth`` assembly sample on either branch.
"""

import argparse
import contextlib
import io
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from pav_tpu_torch import synth  # noqa: E402


def run_reference_asm(genome, run_dir, branch='accel'):
    """``pav_tpu``'s Pipeline.run_sample on an asm_genome sample (ref
    {chrom: codes}, h1 {contig: codes}, h2, ...) in ``run_dir``, on its
    accelerator or CPU branch, with the CLI's default configuration: (its
    result, wall seconds)."""
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.pipeline import Pipeline
    from test_torch_pipeline import reference_accel_branch

    ref, h1, h2 = genome[:3]
    ctx = reference_accel_branch() if branch == 'accel' else contextlib.nullcontext()
    with ctx:
        t0 = time.time()
        res = Pipeline(SeqStore(ref), {}, run_dir=run_dir, log=io.StringIO()).run_sample(
            'asm', {'h1': SeqStore(h1), 'h2': SeqStore(h2)})
    return res, time.time() - t0


@pytest.fixture(scope='module')
def asm10(tmp_path_factory):
    genome = synth.asm_genome(*synth.ASM10)
    res, _ = run_reference_asm(genome, str(tmp_path_factory.mktemp('asm10_ref')), 'accel')
    return genome, res['vcf']


def test_asm10_reference_digest(asm10):
    _, vcf = asm10
    assert synth.records_digest(vcf) == synth.ASM10_REFERENCE


def test_asm10_reference_meets_floors(asm10):
    """The reference's VCF against the planted truth: RECALL_FLOORS over
    every class (INV recall 1.0: both inversions called)."""
    genome, vcf = asm10
    rep, misses = synth.truth_report(vcf, genome[3] + genome[4])
    assert misses == [], rep
    assert rep.loc['INV', 'N_TRUTH'] == 2


def main(argv=None):
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sample', choices=('ASM_TINY', 'ASM10', 'ASM97'), default='ASM10')
    ap.add_argument('--branch', choices=('accel', 'cpu'), default='accel')
    args = ap.parse_args(argv)

    genome = synth.asm_genome(*getattr(synth, args.sample))
    with tempfile.TemporaryDirectory(prefix='pav_asm_reference_') as run_dir:
        res, wall = run_reference_asm(genome, run_dir, args.branch)
        rep, misses = synth.truth_report(res['vcf'], genome[3] + genome[4])
        count, digest = synth.records_digest(res['vcf'])
    print(f'pav_tpu on its {args.branch} branch, asm_genome(*synth.{args.sample}): {count} VCF '
          f'records, sha256 {digest}; {wall:.1f} s on the CPU')
    print(f'against planted truth:\n{rep.to_string()}\nfloors missed: {misses or "none"}')
    return 0


if __name__ == '__main__':
    import conftest  # noqa: F401  (JAX on the CPU backend, as under pytest)
    sys.exit(main())
