"""One run of one cell of the benchmark of ``pav_tpu_torch`` on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``: chromosomes, contig layout, PAV settings, the
individuals a window reaches) under a traffic mix (``mixes/<mix>.json``: the
event spectrum).

Set-up generates the run's reference and its individuals from ``--seed`` in
child processes (``gen.py``), writes their FASTA files under ``TMPDIR``,
imports the program and runs one small warm-up sample through the CLI (the
first run in a checkout builds the kernels there, into the program's fixed
``build/`` directories). The window then runs the individuals back to back
through the port's CLI, ``pav_tpu_torch.__main__.main``, in this process on
``cuda``, FASTA in and VCF out; the next one starts only while the time
left is at least the last one's wall, and one always runs. With
``--trace 1`` the same window runs inside ``torch.profiler`` (CPU and CUDA
activity).

Once the window has closed, the peaks are read and the program's state is
gone, the plain reference (``reference.py``) judges every sample's VCF
against the planted truth and a sample of the DP kernels' answers; the
numbers compared and their limits (``limits/<cell>.json``) are printed as
the last lines of standard error and under ``checks`` in the result. The
last line of standard output is the result: the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics, each read from the run's
record by ``e2e/<metric>.py`` or ``layers/<metric>.py``; the kernels' work
is counted by ``kernels/<kernel>.py``. Every reader is also read into a
line on standard error, listed in the cell or not.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pav_tpu')
DEVICE = 'cuda'


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path):
    name = 'bench_' + os.path.splitext(os.path.basename(path))[0].replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench, workload):
    """(cell entry, config, config path, mix, mix path, limits) of a
    workload, each found by its name."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}: {sorted(cells)}')
    cell = cells[workload]
    config = next(c for c in bench['configs'] if c['name'] == cell['config'])
    cfg_path = os.path.join(ROOT, config['file'])
    mix_path = os.path.join(HERE, 'mixes', cell['traffic'] + '.json')
    limits = load_json(os.path.join(HERE, 'limits', workload + '.json'))
    return cell, load_json(cfg_path), cfg_path, load_json(mix_path), mix_path, limits


def require_cards(count):
    """Exit without a result unless torch sees ``count`` CUDA devices."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        print(f'benchmark: needs {count} CUDA device(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        sys.exit(3)


def device_info(count):
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': count,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among module names (by default those
    loaded), each compared whole."""
    return sorted({name.split('.')[0] for name in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


# ----------------------------------------------------------------- set-up

def generate(workdir, cfg_path, mix_path, seed, individuals):
    """Write the reference (beside the warm-up sample), then the
    individuals against it, each part in a child process of its own."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    for parts in (['ref', 'warmup'], [str(k) for k in range(1, individuals + 1)]):
        procs = [subprocess.Popen([sys.executable, os.path.join(HERE, 'gen.py'), workdir,
                                   cfg_path, mix_path, str(seed), part], env=env)
                 for part in parts]
        failed = [part for part, p in zip(parts, procs) if p.wait() != 0]
        if failed:
            raise RuntimeError(f'generating {failed} failed')


def write_table(path, names, workdir):
    with open(path, 'w') as fh:
        fh.write('NAME\tHAP_h1\tHAP_h2\n')
        for name in names:
            fh.write(f'{name}\t{workdir}/{name}_h1.fa\t{workdir}/{name}_h2.fa\n')


class DPRecorder:
    """Keeps every launch of ``affine_dp.align_and_trace`` (its inputs and
    the walker's fused output, as device tensors) while installed; the
    reference reads them after the window."""

    def __init__(self, affine_dp):
        self.mod = affine_dp
        self.orig = affine_dp.align_and_trace
        self.launches = []
        self.sample = None

    def tag(self, sample):
        """Mark the launches from here on as the named sample's."""
        self.sample = sample

    def __call__(self, q, r, m, n, max_m, width, scoring, band='wave'):
        out = self.orig(q, r, m, n, max_m, width, scoring, band)
        self.launches.append((self.sample, q, r, m, n, width, out))
        return out

    def __enter__(self):
        self.mod.align_and_trace = self
        return self

    def __exit__(self, *exc):
        self.mod.align_and_trace = self.orig

    def host(self):
        """The launches as NumPy: the sample, kind (full or banded), q, r,
        m, n, out and each row's path length."""
        import numpy as np
        out = []
        for sample, q, r, m, n, width, fused in self.launches:
            o = fused.cpu().numpy()
            out.append({'sample': sample, 'kind': 'full' if width == r.shape[1] + 1 else 'band',
                        'q': q.cpu().numpy(), 'r': r.cpu().numpy(),
                        'm': m.cpu().numpy().astype(np.int64),
                        'n': n.cpu().numpy().astype(np.int64), 'out': o,
                        'path': o[:, -5:-1].astype(np.int64) @ (1 << (8 * np.arange(4)))})
        return out


# ----------------------------------------------------------------- window

def run_window(cli, samples, seconds, argv_of, trace, tag):
    """Run the samples back to back; returns (per-sample results, window
    seconds, profiler or None). ``tag`` is called with each sample's name
    before it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof_cm = contextlib.nullcontext()
    if trace:
        acts = [ProfilerActivity.CPU]
        if DEVICE != 'cpu':
            acts.append(ProfilerActivity.CUDA)
        prof_cm = profile(activities=acts)
    results = []
    gc.collect()
    gc.freeze()
    with prof_cm as prof:
        with record_function('bench:window'):
            t_start = time.perf_counter()
            for name in samples:
                tag(name)
                ru0 = resource.getrusage(resource.RUSAGE_SELF)
                t0 = time.perf_counter()
                ok = True
                with record_function(f'bench:sample:{name}'):
                    try:
                        with contextlib.redirect_stdout(sys.stderr):
                            ok = cli.main(argv_of(name)) == 0
                    except Exception:
                        traceback.print_exc()
                        ok = False
                    if DEVICE != 'cpu':
                        torch.cuda.synchronize()
                t1 = time.perf_counter()
                ru = resource.getrusage(resource.RUSAGE_SELF)
                results.append({'name': name, 'ok': ok, 'wall_s': t1 - t0,
                                'cpu_s': ru.ru_utime + ru.ru_stime - ru0.ru_utime - ru0.ru_stime})
                if not ok or seconds - (t1 - t_start) < t1 - t0:
                    break
            t_end = time.perf_counter()
    return results, t_end - t_start, prof


def read_timings(path):
    if not os.path.isfile(path):
        return []
    with open(path) as fh:
        next(fh)
        return [(a, b, float(c)) for a, b, c in (line.rstrip('\n').split('\t') for line in fh)]


# ------------------------------------------------------------------ check

def judge(workdir, done, launches, mix, seed, scoring, control=False):
    """The numbers compared: (checks {name: value}, details) of the samples
    ``done`` and the recorded DP launches, by ``reference.py``. With
    ``control`` the control's answers are judged instead."""
    import numpy as np
    R = load_module(os.path.join(HERE, 'reference.py'))

    ref = R.read_fasta(os.path.join(workdir, 'ref.fa'))
    tot = {}
    for s in done:
        sample = load_json(os.path.join(workdir, f"{s['name']}.truth.json"))
        want = {hap: [R.truth_key(ref, t) for t in ts] for hap, ts in sample['truth'].items()}
        got = (R.control_calls(want) if control
               else R.vcf_calls(os.path.join(s['run_dir'], f"{s['name']}.vcf.gz"), ref))
        for k, v in R.compare_calls(want, got, R.contig_ends(sample['layout'])).items():
            tot[k] = tot.get(k, 0) + v
    mine = [L for L in launches if L['sample'] in {s['name'] for s in done}]
    picks = R.sample_items(mine, mix['dp_items_checked'], np.random.default_rng([seed, 7]))
    cache = {}

    def indexes(launch):
        """The slice indexes of the reference and of the launch's sample, and
        its contigs' strands (launches come sample by sample: one sample's
        index is kept at a time)."""
        name = launch['sample']
        if 'ref' not in cache:
            cache['ref'] = R.SliceIndex(ref)
        if cache.get('name') != name:
            layout = load_json(os.path.join(workdir, f'{name}.truth.json'))['layout']
            tigs = {tig: seq for hap in ('h1', 'h2')
                    for tig, seq in R.read_fasta(os.path.join(workdir, f'{name}_{hap}.fa')).items()}
            cache.update(name=name, tig=R.SliceIndex(tigs),
                         strand={tig: w['strand'] for tig, w in layout.items()})
        return cache['ref'], cache['tig'], cache['strand']

    dp = R.check_dp(mine, picks, scoring, control=control, indexes=indexes)
    checks = {'missed_share': tot.get('missed', 0) / max(tot.get('planted', 0), 1),
              'edge_missed_share': tot.get('edge_missed', 0) / max(tot.get('edge_planted', 0), 1),
              'false_share': tot.get('false', 0) / max(tot.get('called', 0), 1),
              'duplicate_calls': tot.get('duplicate', 0),
              'dp_bad_items': dp['bad'],
              'dp_bad_windows': dp['bad_windows']}
    details = dict(tot, **{'dp_' + k: v for k, v in dp.items()},
                   dp_banded_launches=sum(L['kind'] == 'band' for L in mine))
    return checks, details


# ----------------------------------------------------------------- record

def build_record(results, window_s, contig_bp, launches, align_by_hap, dp_stats, prof):
    done = [r for r in results if r['ok']]
    record = {'samples': [dict(r, timings=read_timings(os.path.join(r['run_dir'], r['name'],
                                                                    'timings.tsv')))
                          for r in done],
              'contig_mbp': sum(contig_bp[r['name']] for r in done) / 1e6,
              'window_s': window_s,
              'align_by_hap': align_by_hap,
              'dp_stats': dp_stats,
              'launches': launches,
              'peaks': load_json(os.path.join(HERE, 'peaks.json')),
              'trace': None, 'kernels': {}}
    if prof is not None:
        record['trace'] = load_module(os.path.join(HERE, 'devtrace.py')).reduce(prof)
    for path in sorted(os.listdir(os.path.join(HERE, 'kernels'))):
        if not path.endswith('.py'):
            continue
        k = load_module(os.path.join(HERE, 'kernels', path))
        work = k.work(launches)
        if work is None:
            continue
        t = record['trace']
        secs = (sum(v for name, v in t['kernels'].items() if k.NEEDLE in name) if t else 0.0)
        record['kernels'][path[:-3]] = {'ops': work[0], 'bytes': work[1], 'peak': k.PEAK,
                                        'device_s': secs}
    return record


def metrics_of(bench, cell, trace, record):
    """The cell's metrics of this run, each read from the record by its
    reader: end-to-end (``e2e/<metric>.py``), or with ``trace`` per-layer
    (``layers/<metric>.py``). A per-layer reader that finds nothing to read
    leaves its metric out."""
    group, folder = ('per_layer', 'layers') if trace else ('end_to_end', 'e2e')
    out = {}
    for m in bench[group]:
        if cell['name'] not in m.get('workloads', [cell['name']]):
            continue
        value = load_module(os.path.join(HERE, folder, m['name'] + '.py')).read(record)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def readings(record):
    """Every reader's reading of the record (``e2e/`` and ``layers/``),
    those that the cell does not list included; None where a reader
    finds nothing to read."""
    return {path[:-3]: load_module(os.path.join(HERE, folder, path)).read(record)
            for folder in ('e2e', 'layers')
            for path in sorted(os.listdir(os.path.join(HERE, folder))) if path.endswith('.py')}


# ------------------------------------------------------------------- main

def measure(workload, seed, seconds, trace, control=False, log=sys.stderr):
    """One run: set-up, window, check. Returns the result line's object
    (and, with ``control``, the control's checks under ``control``)."""
    t_setup = time.perf_counter()
    bench = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cell, config, cfg_path, mix, mix_path, limits = cell_files(bench, workload)
    require_cards(cell['chips'])
    parts = {'torch and the card': time.perf_counter() - t_setup}
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    seed = int(seed) % (1 << 63)
    workdir = tempfile.mkdtemp(prefix='pavbench-')
    try:
        return _measure(bench, cell, config, cfg_path, mix, mix_path, limits, seed, seconds,
                        trace, control, workdir, t_setup, parts, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _measure(bench, cell, config, cfg_path, mix, mix_path, limits, seed, seconds, trace,
             control, workdir, t_setup, parts, log):
    names = [f'IND{k}' for k in range(1, config['individuals'] + 1)]
    t = time.perf_counter()
    generate(workdir, cfg_path, mix_path, seed, config['individuals'])
    parts['generation'] = time.perf_counter() - t
    write_table(os.path.join(workdir, 'asm.tsv'), names, workdir)
    write_table(os.path.join(workdir, 'warmup.tsv'), ['WARMUP'], workdir)
    extra = []
    if config.get('pav_config'):
        with open(os.path.join(workdir, 'pav_config.json'), 'w') as fh:
            json.dump(config['pav_config'], fh)
        extra = ['--config', os.path.join(workdir, 'pav_config.json')]

    t = time.perf_counter()
    import torch  # noqa: F401  (CUDA initialised in set-up)
    import pav_tpu_torch.__main__ as cli
    from pav_tpu_torch import _build
    from pav_tpu_torch.align.aligner import core
    from pav_tpu_torch.ops import affine_dp, dp_kernels
    parts['program import'] = time.perf_counter() - t

    def argv_of(name):
        warm = name == 'WARMUP'
        return ['--ref', os.path.join(workdir, 'warmup_ref.fa' if warm else 'ref.fa'),
                '--assemblies', os.path.join(workdir, 'warmup.tsv' if warm else 'asm.tsv'),
                '--run-dir', os.path.join(workdir, f'run_{name}'), '--sample', name,
                '--device', DEVICE] + extra

    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        if cli.main(argv_of('WARMUP')) != 0:
            raise RuntimeError('the warm-up sample failed')
    parts['warm-up sample'] = time.perf_counter() - t
    contig_bp = {n: load_json(os.path.join(workdir, f'{n}.truth.json'))['contig_bp']
                 for n in names}
    affine_dp.stats_reset()
    core.align_stats_reset()
    dp_kernels.launches_reset()
    setup_s = time.perf_counter() - t_setup
    build = {k: v for k, v in _build.BUILD_INFO.items() if k in ('seconds', 'cached')}
    print(f'benchmark: set-up {setup_s:.3f} s, of it ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in parts.items()) + f'; kernel library {build}', file=log)

    with DPRecorder(affine_dp) as rec:
        results, window_s, prof = run_window(cli, names, seconds, argv_of, trace, rec.tag)
    peak_rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    device = device_info(cell['chips'])
    bad = forbidden_modules()
    if bad:
        print(f'benchmark: modules loaded that the port may not load: {bad}', file=log)
        sys.exit(4)
    for r in results:
        r['run_dir'] = os.path.join(workdir, f"run_{r['name']}")
    launches = rec.host()
    rec.launches.clear()
    record = build_record(results, window_s, contig_bp, launches,
                          json.loads(json.dumps(core.ALIGN_STATS_BY_HAP)),
                          {'resolve_s': affine_dp.STATS['resolve_s'],
                           'classes': dict(affine_dp.STATS['classes'])}, prof)
    record.update(setup_s=setup_s, setup_parts=parts, peak_rss_gib=peak_rss_gib)
    del prof
    done = [r for r in results if r['ok']]
    checks, details = judge(workdir, done, launches, mix, seed, config['scoring'])
    failed = len(results) - len(done)
    correct = bool(done) and not failed and all(checks[k] <= limits[k] for k in checks)
    metrics = metrics_of(bench, cell, trace, record) if done else {}
    if done:
        print(f'benchmark: readings {json.dumps(readings(record))}', file=log)
    print('benchmark: samples ' + ', '.join(f"{r['name']} {r['wall_s']:.3f} s"
                                             + ('' if r['ok'] else ' FAILED') for r in results)
          + f'; window {window_s:.3f} s; {record["contig_mbp"]:.6f} contig Mbp', file=log)
    for s in record['samples']:
        stages = {}
        for label, stage, t in s['timings']:
            key = stage if label == s['name'] else 'hap.' + stage
            stages[key] = max(stages.get(key, 0.0), t) if key == 'hap.align' else (
                stages.get(key, 0.0) + t)
        print(f"benchmark: {s['name']} cpu {s['cpu_s']:.3f} s; "
              + ', '.join(f'{k} {v:.3f}' for k, v in stages.items()), file=log)
    print(f'benchmark: check counts {json.dumps(details)}', file=log)
    result = {'correct': correct, 'attempted': len(results), 'failed': failed,
              'metrics': metrics, 'device': device}
    if trace and record['trace']:
        device['busy_s'] = record['trace']['busy_s']
        device['window_s'] = record['trace']['window_s']
        result['breakdown'] = record['trace']['breakdown']
    if control:
        result['control'] = judge(workdir, done, launches, mix, seed, config['scoring'],
                                  control=True)[0]
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(workdir) for f in files)
    print(f'benchmark: {written} bytes written under {workdir}', file=log)
    for k in checks:
        print(f'check {k} {checks[k]!r} limit {limits[k]!r}', file=log)
    result['checks'] = {k: {'value': checks[k], 'limit': limits[k]} for k in checks}
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 1 if result['failed'] else 0


if __name__ == '__main__':
    sys.exit(main())
