"""Command-line entry: python -m pav_tpu_torch --ref ref.fa --assemblies asm.tsv

The flags of ``python -m pav_tpu``, plus ``--device`` (default ``cuda``; a
run that asks for CUDA on a host without it stops). One process, one engine,
VCF per sample.
"""

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='pav_tpu_torch',
        description='Assembly-to-reference variant calling engine '
                    '(PyTorch/CUDA port of pav_tpu)')
    parser.add_argument('--ref', required=True, help='Reference FASTA')
    parser.add_argument('--assemblies', required=True,
                        help='Assembly table TSV/CSV (NAME + HAP_* columns)')
    parser.add_argument('--config', default=None, help='config.json path')
    parser.add_argument('--run-dir', default='pav_run', help='Artifact directory')
    parser.add_argument('--sample', action='append', default=None,
                        help='Run only this sample (repeatable)')
    parser.add_argument('--set', action='append', default=[], metavar='KEY=VAL',
                        help='Config override (repeatable)')
    parser.add_argument('--resume', action='store_true',
                        help='Resume from stage artifacts in the run dir')
    parser.add_argument('--profile-dir', default=None,
                        help='Write a torch.profiler trace (trace.json) here')
    parser.add_argument('--device', default=None,
                        help='torch device: cuda (default) or cpu; overrides '
                             'the config key "device"')
    # Multi-host cohort flags of pav_tpu: not ported yet (ROADMAP A9).
    parser.add_argument('--coordinator', default=None, metavar='HOST:PORT')
    parser.add_argument('--num-processes', type=int, default=1)
    parser.add_argument('--process-id', type=int, default=0)
    parser.add_argument('--cohort-timeout', type=float, default=None,
                        metavar='SECONDS')
    parser.add_argument('--ship-artifacts', action='store_true')
    parser.add_argument('--no-keep-going', action='store_true')
    args = parser.parse_args(argv)

    if (args.coordinator or args.num_processes != 1 or args.process_id
            or args.cohort_timeout is not None or args.ship_artifacts
            or args.no_keep_going):
        raise NotImplementedError(
            'cohort mode (--coordinator and its flags) is not ported to '
            'pav_tpu_torch yet (ROADMAP A9)')

    overrides = {}
    if args.config:
        with open(args.config) as fh:
            overrides.update(json.load(fh))
    for item in args.set:
        key, _, val = item.partition('=')
        overrides[key] = val

    from .pipeline import run
    results = run(args.ref, args.assemblies, config=overrides,
                  run_dir=args.run_dir, samples=args.sample,
                  resume=args.resume, profile_dir=args.profile_dir,
                  device=args.device)
    for asm_name, res in results.items():
        print(f'{asm_name}: {res["vcf"]}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
