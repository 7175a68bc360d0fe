"""Drive ``benchmark/run.py`` on the CPU at a small size, for the tests.

Skips the harness's look for a card, runs the port on ``cpu`` with the
accelerator's class ladder (the classes the card runs), and cuts each
configuration's chromosomes to 1/``scale`` of their length, the warm-up
sample to the same size and the cohort to two individuals, with the
missed shares' limits set for that size (``SMALL_LIMITS``). Everything else
is the harness as the card runs it.
"""

import importlib.util
import json
import os
import tempfile

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The shares of missed events that a sample at 1/200 is held to. Such a
# sample holds about 900 planted events, 115 of them near a contig end, so
# one miss reads 0.0011 and 0.0087: the cells' limits, set for samples of
# about 100,000 events, would fail a sound run here on the two or three
# misses at contig ends that a sound one has. Every other limit is the
# cell's own.
SMALL_LIMITS = {'missed_share': 0.01, 'edge_missed_share': 0.1}


def shrink(run, monkeypatch, scale=200):
    """Cut each cell of ``run`` to 1/``scale`` of its chromosomes' length,
    its warm-up to the same size and its cohort to two individuals, and
    hold it to SMALL_LIMITS."""
    full = run.cell_files
    tmp = tempfile.mkdtemp(prefix='bench-small-')

    def small(bench, workload):
        cell, cfg, _, mix, _, limits = full(bench, workload)
        cfg = dict(cfg, individuals=2,
                   chromosomes=[[c, round(n / scale)] for c, n in cfg['chromosomes']])
        mix = dict(mix, warmup_scale=1)
        limits = dict(limits, **SMALL_LIMITS)
        paths = []
        for name, obj in (('config.json', cfg), ('mix.json', mix)):
            paths.append(os.path.join(tmp, name))
            with open(paths[-1], 'w') as fh:
                json.dump(obj, fh)
        return cell, cfg, paths[0], mix, paths[1], limits

    monkeypatch.setattr(run, 'cell_files', small)
    return run


def harness(monkeypatch, scale=200):
    """The benchmark's run module, patched for a small CPU run."""
    run = load(os.path.join(BENCH, 'run.py'), 'bench_run_under_test')
    monkeypatch.setattr(run, 'DEVICE', 'cpu')
    monkeypatch.setattr(run, 'require_cards', lambda count: None)
    monkeypatch.setattr(run, 'device_info', lambda count: {
        'platform': 'cpu', 'kind': 'cpu', 'count': count, 'memory_peak_bytes': 0})
    from pav_tpu_torch.align.aligner import core
    monkeypatch.setattr(core, 'resolve_ladder', lambda ladder, device: 'accel')
    return shrink(run, monkeypatch, scale)
