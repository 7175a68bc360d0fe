"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card: for each seed, one run of the cell as ``run.py`` makes it (its
window, its samples, its DP launches), with the numbers compared for the
program and for the control (``reference.control_calls``,
``reference.control_dp``: the reference in the program's place, positions
and DP extents at 2 bp). All seeds of all cells run in this one process.

    python benchmark/control.py --workload <cell> [--workload ...] --seeds <n> [<n> ...]

Prints one JSON line a run, then a summary a cell: the largest reading of
the program and the smallest of the control, per number. The benchmark's
own runs do not run it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run as harness  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', action='append', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    seconds = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))['run_seconds']
    for workload in args.workload:
        program, control = {}, {}
        for seed in args.seeds:
            res = harness.measure(workload, seed, seconds, False, control=True)
            row = {'workload': workload, 'seed': seed, 'correct': res['correct'],
                   'attempted': res['attempted'], 'failed': res['failed'],
                   'program': {k: c['value'] for k, c in res['checks'].items()},
                   'control': res['control'], 'metrics': res['metrics']}
            print(json.dumps(row), flush=True)
            for k, v in row['program'].items():
                program[k] = max(program.get(k, v), v)
            for k, v in row['control'].items():
                control[k] = min(control.get(k, v), v)
        print(json.dumps({'workload': workload, 'seeds': args.seeds,
                          'program_largest': program, 'control_smallest': control}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
