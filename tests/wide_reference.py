"""The JAX reference on a kilobase-SV sample, on the CPU: the numbers the
torch port's card runs are set beside.

    JAX_PLATFORMS=cpu python tests/wide_reference.py --ref-mbp 16 --seed 41

Builds ``pav_tpu_torch.synth.wide_genome`` (chip_smoke.py phase 13b's
wide16 at its defaults), runs ``pav_tpu``'s pipeline on it with the CLI's
default configuration, on the reference's accelerator branch (``--branch
accel``, the classes of the port's CUDA path, as
tests/test_torch_pipeline.py forces it) or on its own CPU branch
(``--branch cpu``), and prints the concordance with the planted truth by
class and in the >= 2 kb INS and DEL bin, and ``synth.records_digest`` of
the VCF (its records' count and SHA-256), which chip_smoke.py phase 13b
holds the card's VCF of the same sample to (``synth.WIDE16_REFERENCE``;
tests/test_torch_wide16_reference.py recomputes it).
"""

import argparse
import contextlib
import io
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def run_reference(genome, run_dir, branch='accel'):
    """``pav_tpu``'s Pipeline.run_sample on a (ref, h1, h2, ...) genome of
    ``synth`` in ``run_dir``, on its accelerator or CPU branch, with the
    CLI's default configuration: (its result, wall seconds)."""
    from pav_tpu.io.fasta import SeqStore
    from pav_tpu.pipeline import Pipeline
    from test_torch_pipeline import reference_accel_branch

    ref, h1, h2 = genome[:3]
    ctx = reference_accel_branch() if branch == 'accel' else contextlib.nullcontext()
    with ctx:
        t0 = time.time()
        res = Pipeline(SeqStore({'chr1': ref}), {}, run_dir=run_dir, log=io.StringIO()).run_sample(
            'wide', {'h1': SeqStore({'wtig_h1': h1}), 'h2': SeqStore({'wtig_h2': h2})})
    return res, time.time() - t0


def main(argv=None):
    import tempfile

    from pav_tpu_torch import synth
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ref-mbp', type=float, default=synth.WIDE16[0] / 1e6)
    ap.add_argument('--seed', type=int, default=synth.WIDE16[1])
    ap.add_argument('--branch', choices=('accel', 'cpu'), default='accel')
    args = ap.parse_args(argv)

    genome = synth.wide_genome(int(args.ref_mbp * 1e6), args.seed)
    truth = genome[3] + genome[4]
    with tempfile.TemporaryDirectory(prefix='pav_wide_reference_') as run_dir:
        res, wall = run_reference(genome, run_dir, args.branch)
        rep, misses = synth.truth_report(res['vcf'], truth)
        wide, wide_misses = synth.truth_report(res['vcf'], truth, min_len=synth.WIDE_MIN)
        count, digest = synth.records_digest(res['vcf'])
    print(f'pav_tpu on its {args.branch} branch, wide_genome({int(args.ref_mbp * 1e6)}, '
          f'{args.seed}): {count} VCF records, sha256 {digest}; {wall:.1f} s on the CPU')
    print(f'against planted truth:\n{rep.to_string()}\nfloors missed: {misses or "none"}')
    print(f'SVs of >= {synth.WIDE_MIN} bp:\n{wide.to_string()}\n'
          f'floors missed: {wide_misses or "none"}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
