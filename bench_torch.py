#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: contig Mbp aligned and called per second.

The protocol of bench.py on ``pav_tpu_torch``:

    python3 bench_torch.py                  # on the card (device cuda)
    python3 bench_torch.py --device cpu     # on the CPU (the CPU class ladder)

1. Headline: a warm-up run on a 300 kb diploid sample, then the best of N
   in-process ``Pipeline.run_sample`` iterations on the 16 Mbp diploid
   sample of bench.py (seed 11; ``PAV_BENCH_REF_MBP``), a fresh Pipeline
   each, until the best improves by less than 5% (at least
   ``PAV_BENCH_ITERS``, at most ``PAV_BENCH_MAX_ITERS``) or the budget
   (``PAV_BENCH_TOTAL_S``) runs short. The best iteration's VCF must meet
   tests/test_recall.py's floors against the planted truth
   (``pav_tpu_torch.synth.hold_to_truth``), and on the card its dp_full and walker
   launches must be non-zero; otherwise the script exits nonzero and prints
   no number.
2. Repeat-rich: a child process (``--repeat-child``) runs bench.py's
   repeat-rich sample at half the reference length (seed 18), one untimed
   pass, one timed pass; it prints ``REPEAT <mbp> <s>``, ``REPSTAGE`` and
   ``REPLAUNCHES`` lines.
3. Chromosome scale: a child process (``--chrom-child``) runs bench.py's
   diploid sample at ``PAV_BENCH_CHROM_MBP`` (default 100; seed 28), a warm
   pass and a timed pass; it prints ``CHROM <mbp> <s> <rss_gb>``,
   ``CHROMSTAGE``, ``CHROMLAUNCHES`` and, on the card, ``CHROMMEM
   <max_memory_allocated> <max_memory_reserved>`` of the timed pass (bytes).

Stdout carries JSON lines with bench.py's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``mfu``, ``peak_rss_gb``, ``backend``); each
finished secondary metric reprints the line with ``repeat_rich_mbp_s``, then
``chrom_scale_mbp_s`` and ``chrom_peak_rss_gb`` added. A child that fails or
times out is reported on stderr with its return code, and the lines printed
so far stand. Stderr carries the card (nvidia-smi name and power limit), the
host's cores, per-stage seconds, ``affine_dp.STATS``, the host spans'
seconds by name (``pav_tpu_torch.spans``) and the DP class table.

``mfu`` is the DP kernels' share of the card's int32 rate while they run:
the int32 operations of the run's DP classes, counted on the plain
recurrences (``chip_smoke.OPS_FULL_CELL`` over B_pad*max_m*(max_n+1) cells
a full-width launch, ``chip_smoke.OPS_WAVE_CELL`` over B_pad*(max_m+max_n)*Ww
a wavefront launch), over the DP kernels' device time (each class timed
alone with CUDA events, times its launches) at ``chip_smoke.INT32_OPS_S``.
On the CPU there is no card rate and ``mfu`` is null.

The samples and the truth check come from ``pav_tpu_torch.synth``; the DP
class timing and the operation counts from ``chip_smoke.py``. Imports torch,
numpy, pav_tpu_torch and chip_smoke.py; never jax.
"""

import argparse
import contextlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time


ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pav_tpu_torch import synth  # noqa: E402

T0 = time.time()
BASELINE_MBP_S = 0.33          # the reference PAV's CPU rate (BASELINE.md)
SEED = 11
CONFIG = {'aligner_min_chain_score': 1000}
REF_MBP = float(os.environ.get('PAV_BENCH_REF_MBP', 16))
TOTAL_BUDGET_S = float(os.environ.get('PAV_BENCH_TOTAL_S', 1500))


def budget_left():
    return TOTAL_BUDGET_S - (time.time() - T0)


def say(msg):
    sys.stderr.write(f'[bench] {msg}\n')
    sys.stderr.flush()


def prefault(env_key):
    """retain_heap, as the CLI calls it, with a prefault of the GB in
    ``env_key`` (default 0: on the H100 host the prefault moved no wall and
    only raised the peak RSS)."""
    from pav_tpu_torch.runtime import retain_heap
    retain_heap(int(float(os.environ.get(env_key, 0)) * 1e9))


def reset_stats():
    from pav_tpu_torch.align.aligner.core import align_stats_reset
    from pav_tpu_torch.ops import affine_dp, dp_kernels
    affine_dp.stats_reset()
    dp_kernels.launches_reset()
    align_stats_reset()


def stage_totals(timings):
    """{stage: seconds summed over haplotypes}, largest first."""
    tot = {}
    for (_, stage), secs in timings.items():
        tot[stage] = tot.get(stage, 0.0) + secs
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def launches():
    from pav_tpu_torch.ops import dp_kernels
    return dict(dp_kernels.LAUNCHES)


def dp_ops(classes):
    """int32 operations of a run's DP classes ({(max_m, max_n, width,
    B_pad): (launches, ...)}, ``affine_dp.STATS['classes']``), counted on
    the plain recurrences: a full-width class (width = max_n + 1) scans
    B_pad*max_m*(max_n+1) cells a launch, a wavefront class
    B_pad*(max_m+max_n)*Ww, Ww its lanes; chip_smoke.full_bound and
    wave_bound count the same cells."""
    from pav_tpu_torch.ops import affine_dp
    ops = 0
    for (mm, nn, width, b_pad), row in classes.items():
        if width == nn + 1:
            ops += row[0] * chip_smoke.OPS_FULL_CELL * b_pad * mm * (nn + 1)
        else:
            ops += (row[0] * chip_smoke.OPS_WAVE_CELL * b_pad * (mm + nn)
                    * affine_dp._wave_width(width))
    return ops


def report_dp_mfu(classes, dev):
    """Per-class DP accounting on stderr; returns the DP roofline share
    (module docstring) or None off the card. On the card each class's DP
    kernel and walker are timed alone with CUDA events at the class's shape
    (chip_smoke.dp_classes)."""
    timed = {}
    if dev.type == 'cuda':
        with contextlib.redirect_stdout(sys.stderr):
            rows = chip_smoke.dp_classes('bench', classes, dev, events=True)
        timed = {(r['max_m'], r['max_n'], r['width'], r['b_pad']): r for r in rows}
    dp_ms = walk_ms = 0.0
    for key, (count, res_s, items, c_pad, c_real, *_) in sorted(classes.items()):
        mm, nn, width, b_pad = key
        row = timed.get(key)
        note = ''
        if row is not None:
            dp_ms += count * row['ms']
            walk_ms += count * row['walk_ms']
            note = (f', {row["kind"]} {row["ms"]:.4f} ms a launch ({count * row["ms"]:.4f} ms), '
                    f'walker {row["walk_ms"]:.4f} ms a launch ({count * row["walk_ms"]:.4f} ms)')
        say(f'  dp class m{mm} n{nn} w{width} B{b_pad}: {count} launches, {items} items, '
            f'wait {res_s:.2f}s, {c_pad / 1e9:.4f}G cells padded, useful '
            f'{100 * c_real / max(c_pad, 1):.1f}%{note}')
    if not timed:
        say('DP roofline: no card, mfu null')
        return None
    ops = dp_ops(classes)
    mfu = ops / (dp_ms / 1e3 * chip_smoke.INT32_OPS_S)
    say(f'DP roofline: {ops / 1e12:.6f} T int32 operations (plain recurrences) over '
        f'{dp_ms:.4f} ms of DP kernels (CUDA events, a class alone x its launches) -> '
        f'{ops / (dp_ms / 1e3) / 1e12:.3f} T op/s = {100 * mfu:.2f}% of '
        f'{chip_smoke.INT32_OPS_S / 1e12:.1f} T op/s int32; walker {walk_ms:.4f} ms')
    return mfu


def card_line():
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else smi.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f'not available ({ex})'


# ------------------------------------------------------------------ children

def repeat_sample():
    """(reference, haplotype) of bench.py's repeat-rich sample: half the
    headline's reference length, seed 18."""
    return synth.repeat_genome(int(REF_MBP * 1e6 / 2), SEED + 7)


def repeat_child(dev):
    """--repeat-child: bench.py's repeat-rich sample at REF_MBP/2, an
    untimed pass, then a timed one."""
    from pav_tpu_torch import spans
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    prefault('PAV_BENCH_REPEAT_PREFAULT_GB')
    rref, rhap = repeat_sample()

    def one_pass():
        pipe = Pipeline(SeqStore({'chr1': rref}), dict(CONFIG), device=dev)
        t0 = time.time()
        pipe.run_sample('bench_rep', {'h1': SeqStore({'rtig1': rhap})}, write_vcf=False)
        return time.time() - t0, pipe
    warm_s, _ = one_pass()
    reset_stats()
    rep_s, pipe = one_pass()
    print(f'REPEAT {len(rhap) / 1e6:.4f} {min(rep_s, warm_s):.4f}', flush=True)
    print(f'REPLAUNCHES {json.dumps(launches())}', flush=True)
    for stage, secs in stage_totals(pipe.timings).items():
        print(f'REPSTAGE {stage} {secs:.3f}', flush=True)
    for name, secs in spans.seconds_by_name(pipe.spans.records).items():
        print(f'REPSTAGE span.{name} {secs:.3f}', flush=True)
    return 0


def chrom_child(dev):
    """--chrom-child: bench.py's diploid sample at PAV_BENCH_CHROM_MBP, a
    warm pass and a timed pass; the faster pass is reported, as bench.py
    keeps the best of its passes."""
    import torch
    from pav_tpu_torch import spans
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    chrom_mbp = float(os.environ.get('PAV_BENCH_CHROM_MBP', 100))
    prefault('PAV_BENCH_CHROM_PREFAULT_GB')
    ref, h1, h2, _, _ = synth.bench_genome(int(chrom_mbp * 1e6), SEED + 17)
    contig_mbp = (len(h1) + len(h2)) / 1e6

    def one_pass():
        reset_stats()
        pipe = Pipeline(SeqStore({'chr1': ref}), dict(CONFIG), device=dev)
        t0 = time.time()
        pipe.run_sample('bench_chrom', {'h1': SeqStore({'c1': h1}), 'h2': SeqStore({'c2': h2})},
                        write_vcf=False)
        return (time.time() - t0, pipe, launches(),
                spans.seconds_by_name(pipe.spans.records))
    warm = one_pass()
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    timed = one_pass()
    if dev.type == 'cuda':
        mem = (torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev))
    best = min(warm, timed, key=lambda p: p[0])
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f'CHROM {contig_mbp:.4f} {best[0]:.4f} {rss_gb:.2f}', flush=True)
    print(f'CHROMPASSES {warm[0]:.4f} {timed[0]:.4f}', flush=True)
    if dev.type == 'cuda':
        print(f'CHROMMEM {mem[0]} {mem[1]}', flush=True)
    print(f'CHROMLAUNCHES {json.dumps(timed[2])}', flush=True)
    for stage, secs in stage_totals(best[1].timings).items():
        print(f'CHROMSTAGE {stage} {secs:.3f}', flush=True)
    for name, secs in best[3].items():
        print(f'CHROMSTAGE span.{name} {secs:.3f}', flush=True)
    return 0


def run_child(flag, device, timeout_key, timeout_default, least_s):
    """This script with ``flag`` in a child process under a timeout bounded
    by the budget; (its stdout lines, or None when it failed or timed out:
    then reported on stderr with its return code)."""
    label = flag.strip('-')
    timeout = min(float(os.environ.get(timeout_key, timeout_default)), budget_left() - 20)
    if timeout < least_s:
        say(f'skipping {label} ({budget_left():.0f}s of budget left)')
        return None
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                               '--device', device], timeout=timeout, capture_output=True,
                              text=True)
    except subprocess.TimeoutExpired as ex:
        out = ex.stdout.decode() if isinstance(ex.stdout, bytes) else (ex.stdout or '')
        say(f'{label} timed out ({timeout:.0f}s; rc none); its lines so far: '
            f'{out.splitlines()[:3]}')
        return None
    if proc.returncode != 0:
        say(f'{label} failed (rc={proc.returncode}): '
            f'{proc.stderr.strip().splitlines()[-5:]}')
        return None
    return proc.stdout.splitlines()


def run_repeat(device):
    """The repeat-rich child; Mbp/s or None."""
    lines = run_child('--repeat-child', device, 'PAV_BENCH_REPEAT_TIMEOUT', 1200, 60)
    out = None
    for line in lines or ():
        tag, _, rest = line.partition(' ')
        if tag == 'REPEAT':
            mbp, secs = (float(x) for x in rest.split())
            out = mbp / secs
            say(f'repeat-rich genome: {mbp:.4f} Mbp in {secs:.4f}s = {out:.4f} Mbp/s '
                f'({out / BASELINE_MBP_S:.2f}x baseline)')
        elif tag == 'REPLAUNCHES':
            say(f'  repeat launches {rest}')
        elif tag == 'REPSTAGE':
            stage, secs = rest.split()
            say(f'  repeat {stage:<18} {float(secs):8.3f}s')
    if lines is not None and out is None:
        say('repeat-rich child printed no REPEAT line')
    return out


def run_chrom(device):
    """The chromosome-scale child; (Mbp/s, peak RSS GB) or None."""
    lines = run_child('--chrom-child', device, 'PAV_BENCH_CHROM_TIMEOUT', 900, 180)
    out = None
    for line in lines or ():
        tag, _, rest = line.partition(' ')
        if tag == 'CHROM':
            mbp, secs, rss = (float(x) for x in rest.split())
            out = (mbp / secs, rss)
            say(f'chromosome-scale genome: {mbp:.4f} Mbp in {secs:.4f}s = {out[0]:.4f} Mbp/s '
                f'({out[0] / BASELINE_MBP_S:.2f}x baseline), peak RSS {rss:.2f} GB')
        elif tag == 'CHROMPASSES':
            say(f'  chrom passes (warm, timed) {rest} s')
        elif tag == 'CHROMMEM':
            alloc, reserved = (int(x) for x in rest.split())
            say(f'  chrom torch max_memory_allocated {alloc / 2**20:.1f} MiB, '
                f'max_memory_reserved {reserved / 2**20:.1f} MiB (timed pass)')
        elif tag == 'CHROMLAUNCHES':
            say(f'  chrom launches {rest}')
        elif tag == 'CHROMSTAGE':
            stage, secs = rest.split()
            say(f'  chrom {stage:<18} {float(secs):8.3f}s')
    if lines is not None and out is None:
        say('chromosome-scale child printed no CHROM line')
    return out


# ---------------------------------------------------------------- headline

def headline(dev, work):
    """The best of N timed iterations; (seconds, timings, DP stats, host span
    seconds by name, launches, VCF path, truth) of the best."""
    import torch
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    from pav_tpu_torch import spans
    from pav_tpu_torch.ops import affine_dp

    prefault('PAV_BENCH_PREFAULT_GB')
    ref, h1, h2, t1, t2 = synth.bench_genome(int(REF_MBP * 1e6), SEED)
    ref_store = SeqStore({'chr1': ref})
    wref, wh1, wh2, _, _ = synth.bench_genome(300000, SEED + 99)
    Pipeline(SeqStore({'chr1': wref}), dict(CONFIG), device=dev).run_sample(
        'warm', {'h1': SeqStore({'w1': wh1}), 'h2': SeqStore({'w2': wh2})}, write_vcf=False)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)

    n_iters = int(os.environ.get('PAV_BENCH_ITERS', 4))
    max_iters = int(os.environ.get('PAV_BENCH_MAX_ITERS', 12))
    best = prev_best = None
    for it in range(max_iters):
        if best is not None and budget_left() < 3 * best[0] + 60:
            say(f'stopping after {it} iterations ({budget_left():.0f}s of budget left)')
            break
        if it >= n_iters and prev_best is not None and best[0] > prev_best * 0.95:
            break   # converged: <5% improvement over the previous best
        reset_stats()
        run_dir = os.path.join(work, f'run_{it}')
        pipeline = Pipeline(ref_store, dict(CONFIG), run_dir=run_dir, device=dev)
        t0 = time.time()
        result = pipeline.run_sample(
            'bench', {'h1': SeqStore({'tig1': h1}), 'h2': SeqStore({'tig2': h2})})
        it_s = time.time() - t0
        n_snv = result['merged'][('snv_snv', 'pass')].shape[0]
        n_indel = (result['merged'][('svindel_ins', 'pass')].shape[0]
                   + result['merged'][('svindel_del', 'pass')].shape[0])
        assert n_snv > 100 and n_indel > 10, f'implausible callset: {n_snv} SNV, {n_indel} indel'
        say(f'iteration {it}: {it_s:.4f}s')
        prev_best = best[0] if best is not None else None
        if best is None or it_s < best[0]:
            if best is not None:
                shutil.rmtree(os.path.dirname(best[5]), ignore_errors=True)
            best = (it_s, dict(pipeline.timings),
                    {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in affine_dp.STATS.items()},
                    spans.seconds_by_name(pipeline.spans.records), launches(),
                    result['vcf'])
        else:
            shutil.rmtree(run_dir, ignore_errors=True)
    return (*best, t1 + t2, (len(h1) + len(h2)) / 1e6)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help='torch device: cuda (default) or cpu')
    ap.add_argument('--repeat-child', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('--chrom-child', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    from pav_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)     # raises where CUDA is asked for and absent
    if args.repeat_child:
        return repeat_child(dev)
    if args.chrom_child:
        return chrom_child(dev)
    import torch

    say(f'nvidia-smi: {card_line()}')
    say(f'device {dev} ({torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}); '
        f'host {os.cpu_count()} cores; torch {torch.__version__} (CUDA {torch.version.cuda}); '
        f'python {sys.version.split()[0]}')
    with tempfile.TemporaryDirectory(prefix='pav_bench_torch_') as work:
        (elapsed, timings, st, span_secs, n_launch, vcf, truth,
         contig_mbp) = headline(dev, work)
        say(f'backend={dev.type} elapsed={elapsed:.4f}s breakdown (summed over haps):')
        for stage, secs in stage_totals(timings).items():
            say(f'  {stage:<14} {secs:7.3f}s  {100 * secs / max(elapsed, 1e-9):5.1f}%')
        say(f'device DP: {st["launches"]} launches, {st["items"]} items, '
            f'h2d {st["h2d_bytes"] / 1e6:.1f}MB, d2h {st["d2h_bytes"] / 1e6:.1f}MB, '
            f'dispatch {st["dispatch_s"]:.2f}s, resolve-wait {st["resolve_s"]:.2f}s; '
            f'kernel launches {json.dumps(n_launch)}')
        mfu = report_dp_mfu(st['classes'], dev)
        say('host spans: ' + '  '.join(f'{k}={v:.2f}s' for k, v in span_secs.items()))
        if dev.type == 'cuda' and (n_launch['full'] <= 0 or n_launch['traceback'] <= 0):
            say(f'the headline run launched no dp_full or walker kernel: {n_launch}')
            return 1
        with contextlib.redirect_stdout(sys.stderr):
            synth.hold_to_truth('headline VCF', vcf, truth)

    value = round(contig_mbp / elapsed, 4)   # the ratio below is of the value printed
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    say(f'peak RSS {peak_rss_gb:.2f} GB at {REF_MBP:g} Mbp reference')
    out = {
        'metric': 'contig_mbp_aligned_called_per_s',
        'value': value,
        'unit': 'Mbp/s',
        'vs_baseline': round(value / BASELINE_MBP_S, 3),
        'mfu': None if mfu is None else round(mfu, 4),
        'peak_rss_gb': round(peak_rss_gb, 2),
        'backend': dev.type,
    }
    print(json.dumps(out), flush=True)

    repeat_mbp_s = run_repeat(args.device)
    if repeat_mbp_s is not None:
        out['repeat_rich_mbp_s'] = round(repeat_mbp_s, 4)
        print(json.dumps(out), flush=True)
    chrom = run_chrom(args.device)
    if chrom is not None:
        out['chrom_scale_mbp_s'] = round(chrom[0], 4)
        out['chrom_peak_rss_gb'] = round(chrom[1], 2)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
