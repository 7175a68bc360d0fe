#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, parity, main path.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero):
  1. environment: nvidia-smi name and power limit, versions, device name;
  2. build: nvcc builds pav_tpu_torch/csrc/*.cu, timed;
  3. kernels: each CUDA kernel against its plain PyTorch version, bit for bit,
     on CUDA tensors at the DP classes of the main path; the kernel's median
     time and the plain version's time (one run, the compared one);
  4. main path: a 16 Mbp reference and a diploid sample (the generator of
     bench.py, seed 11) from FASTA through ``python -m pav_tpu_torch
     --device cuda`` to a VCF; the full-width and traceback kernels must run;
  5. wavefront path: a 2 Mbp repeat-rich sample through the same CLI; the
     wavefront kernel must run;
  6. parity: the e2e test genome through the CLI on cuda and on cpu (plain
     versions); identical VCF records.
The line before last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and no network;
imports no jax.
"""

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCORING = (1, -5, 5, 56, 4, 1)
_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)

DEVICE = 'cuda'
BENCH_REF_LEN = 16_000_000     # phase 4 reference (bench.py's headline size)
REPEAT_REF_LEN = 2_000_000     # phase 5 repeat-rich reference
# Phase 3 classes: full width (B, max_m, max_n) and wavefront (B, max_m,
# max_n, width).
FULL_SHAPES = [(4096, 16, 16), (512, 256, 256), (64, 2048, 2048), (16, 16, 32768)]
WAVE_SHAPES = [(8, 8192, 8192, 513), (4, 8192, 8192, 2049)]
KERNELS = {
    # name: (source, TPU kernel replaced, LAUNCHES key)
    'dp_full': ('pav_tpu_torch/csrc/dp_full.cu', 'pav_tpu/ops/pallas_dp.py:62', 'full'),
    'dp_wave': ('pav_tpu_torch/csrc/dp_wave.cu', 'pav_tpu/ops/pallas_dp.py:227', 'wave'),
    'traceback': ('pav_tpu_torch/csrc/traceback.cu', 'pav_tpu/ops/affine_dp.py:767',
                  'traceback'),
}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ inputs

def dp_inputs(B, max_m, max_n, seed):
    """Random codes 0-4, ragged m <= n, code-4 padding past each length, and
    the last B/8 rows padding items (m = n = 1), as the aligner pads."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 5, (B, max_n)).astype(np.int8)
    m = rng.integers(max(1, max_m // 2), max_m + 1, B).astype(np.int32)
    n = rng.integers(max(1, max_n // 2), max_n + 1, B).astype(np.int32)
    m, n = np.minimum(m, n), np.maximum(m, n)
    pad = max(1, B // 8)
    m[-pad:] = 1
    n[-pad:] = 1
    for b in range(B):
        q[b, m[b]:] = 4
        r[b, n[b]:] = 4
    return q, r, m, n


def write_fasta(path, records):
    with open(path, 'wb') as fh:
        for name, codes in records.items():
            seq = _DECODE[np.minimum(codes, 4)].tobytes()
            fh.write(f'>{name}\n'.encode())
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + b'\n')


def bench_genome(ref_len, seed):
    """The diploid sample of bench.py's build_genome (no cache)."""
    from helpers import Mutator, random_seq
    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)

    def make_hap(seed2, with_inv):
        rng2 = np.random.default_rng(seed2)
        mut = Mutator(ref)
        pos = 2000
        inv_planted = False
        while pos < ref_len - 20000:
            r = rng2.random()
            if r < 0.80:
                mut.snv(pos, rng=rng2)
            elif r < 0.95:
                ln = int(rng2.integers(1, 25))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            elif r < 0.985:
                ln = int(rng2.integers(50, 1500))
                if rng2.random() < 0.5:
                    mut.ins(pos, random_seq(ln, rng2))
                else:
                    mut.dele(pos, ln)
            else:
                if with_inv and not inv_planted and pos < ref_len - 40000:
                    mut.inv(pos, int(rng2.integers(3000, 8000)))
                    inv_planted = True
            pos = max(pos + int(rng2.integers(800, 1800)), mut.cursor + 200)
        return mut.finish()

    return ref, make_hap(seed + 1, False), make_hap(seed + 2, True)


def repeat_genome(ref_len, seed):
    """The repeat-rich sample of bench.py (repeat_rich_ref + its mutator)."""
    from helpers import Mutator, random_seq, repeat_rich_ref
    rrng = np.random.default_rng(seed)
    rref, _ = repeat_rich_ref(ref_len, rrng)
    rmut = Mutator(rref)
    pos = 2000
    while pos < len(rref) - 20000:
        r = rrng.random()
        if r < 0.8:
            if rref[pos] < 4:
                rmut.snv(pos, rng=rrng)
        elif r < 0.97:
            ln = int(rrng.integers(1, 40))
            if rrng.random() < 0.5:
                rmut.ins(pos, random_seq(ln, rrng))
            else:
                rmut.dele(pos, ln)
        else:
            ln = int(rrng.integers(50, 1200))
            if rrng.random() < 0.5:
                rmut.ins(pos, random_seq(ln, rrng))
            else:
                rmut.dele(pos, ln)
        pos = max(pos + int(rrng.integers(900, 2000)), rmut.cursor + 200)
    return rref, rmut.finish()


def e2e_genome():
    """The genome of tests/test_pipeline_e2e.py."""
    from helpers import Mutator, random_seq
    rng = np.random.default_rng(71)
    ref = random_seq(150000, rng)
    m1 = Mutator(ref)
    m1.snv(10000, rng=rng)
    m1.ins(20000, random_seq(12, rng))
    m1.dele(30000, 7)
    m1.ins(50000, random_seq(250, rng))
    m1.dele(70000, 400)
    m1.snv(90000, rng=rng)
    h1 = m1.finish()
    m2 = Mutator(ref)
    m2.snv(10000, alt=int(m1.truth[0]['alt'] == 'A'), rng=rng)
    m2.pieces[-1] = np.array(['ACGT'.index(m1.truth[0]['alt'])], dtype=np.uint8)
    m2.ins(50000, np.array(['ACGT'.index(c) for c in m1.truth[3]['seq']],
                           dtype=np.uint8))
    m2.snv(60000, rng=rng)
    m2.inv(100000, 4000)
    return ref, h1, m2.finish()


# ------------------------------------------------------------------ timing

def median_ms(fn, reps):
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timed_ms(fn):
    """(result, ms) of one call of ``fn``, timed with CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b):
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


# ------------------------------------------------------------------ phases

def phase_kernels(dev):
    import torch
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K

    stats = {name: {'err': 0, 'ms': None, 'plain_ms': None} for name in KERNELS}
    # Warm up the plain versions' torch kernels once at a tiny class, so the
    # timed plain runs below exclude one-time CUDA start-up costs.
    q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(8, 16, 16, 99))
    tb, offs = K.align_full_ref(q, r, m, n, SCORING)
    K.traceback_ref(tb, offs, q, r, m, n, False)
    doffs = affine_dp._wave_geometry(m, n, 16, 16, 32, 128)
    K.traceback_ref(K.align_wave_ref(q, r, m, n, doffs, 128, SCORING), doffs,
                    q, r, m, n, True)
    torch.cuda.synchronize()
    tapes = []
    for i, (B, mm, nn) in enumerate(FULL_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(B, mm, nn, 100 + i))
        tb, offs = K.align_full(q, r, m, n, SCORING)
        (tb_ref, _), pms = timed_ms(lambda: K.align_full_ref(q, r, m, n, SCORING))
        if not torch.equal(tb, tb_ref):
            fail(f'dp_full differs from align_full_ref at B={B} {mm}x{nn + 1}')
        err = max_abs_err(tb, tb_ref)
        ms = median_ms(lambda: K.align_full(q, r, m, n, SCORING), 5 if mm >= 2048 else 20)
        log(f'kernel dp_full B={B} {mm}x{nn + 1}: bit-identical, {ms:.4f} ms '
            f'(plain {pms:.2f} ms, one run)')
        if i == 0:
            stats['dp_full'].update(ms=ms, plain_ms=pms)
        stats['dp_full']['err'] = max(stats['dp_full']['err'], err)
        tapes.append((f'full B={B} {mm}x{nn + 1}', tb, offs, q, r, m, n, False))
    for i, (B, mm, nn, width) in enumerate(WAVE_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(B, mm, nn, 200 + i))
        ww = affine_dp._wave_width(width)
        doffs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)
        tb = K.align_wave(q, r, m, n, doffs, ww, SCORING)
        tb_ref, pms = timed_ms(lambda: K.align_wave_ref(q, r, m, n, doffs, ww, SCORING))
        if not torch.equal(tb, tb_ref):
            fail(f'dp_wave differs from align_wave_ref at B={B} {mm}x{nn} w{width}')
        ms = median_ms(lambda: K.align_wave(q, r, m, n, doffs, ww, SCORING), 3)
        log(f'kernel dp_wave B={B} {mm}x{nn} width {width} ({ww} lanes): '
            f'bit-identical, {ms:.3f} ms (plain {pms:.1f} ms, one run)')
        if i == 0:
            stats['dp_wave'].update(ms=ms, plain_ms=pms)
        tapes.append((f'wave B={B} {mm}x{nn} w{width}', tb, doffs, q, r, m, n, True))
    for i, (label, tb, offs, q, r, m, n, wave) in enumerate(tapes):
        out = K.traceback(tb, offs, q, r, m, n, wave)
        ref, pms = timed_ms(lambda: K.traceback_ref(tb, offs, q, r, m, n, wave))
        if not torch.equal(out, ref):
            fail(f'traceback differs from traceback_ref on the {label} tape')
        stats['traceback']['err'] = max(stats['traceback']['err'], max_abs_err(out, ref))
        ms = median_ms(lambda: K.traceback(tb, offs, q, r, m, n, wave), 5)
        log(f'kernel traceback on {label}: bit-identical, {ms:.4f} ms '
            f'(plain {pms:.1f} ms, one run)')
        if i == 0:
            stats['traceback'].update(ms=ms, plain_ms=pms)
    return stats


def run_cli(argv):
    from pav_tpu_torch.__main__ import main
    t0 = time.time()
    rc = main(argv)
    wall = time.time() - t0
    if rc != 0:
        fail(f'CLI returned {rc}: {argv}')
    return wall


def vcf_records(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh.read().splitlines() if not line.startswith('#')]


def stage_seconds(run_dir, sample):
    import pandas as pd
    df = pd.read_csv(os.path.join(run_dir, sample, 'timings.tsv'), sep='\t')
    return {f'{row.LABEL}:{row.STAGE}': float(row.SECONDS) for row in df.itertuples()}


def run_sample(work, name, ref, haps, device, extra=()):
    """Write FASTAs + assembly table under work/name and run the CLI."""
    d = os.path.join(work, name)
    os.makedirs(d, exist_ok=True)
    write_fasta(os.path.join(d, 'ref.fa'), {'chr1': ref})
    cols, paths = [], []
    for hap, (tig, codes) in haps.items():
        path = os.path.join(d, f'{hap}.fa')
        write_fasta(path, {tig: codes})
        cols.append(f'HAP_{hap}')
        paths.append(path)
    with open(os.path.join(d, 'asm.tsv'), 'w') as fh:
        fh.write('NAME\t' + '\t'.join(cols) + '\n' + name + '\t' + '\t'.join(paths) + '\n')
    run_dir = os.path.join(d, f'run_{device}')
    wall = run_cli(['--ref', os.path.join(d, 'ref.fa'), '--assemblies',
                    os.path.join(d, 'asm.tsv'), '--run-dir', run_dir,
                    '--device', device, *extra])
    return run_dir, wall


def main():
    if not os.path.isfile(os.path.join(ROOT, 'pav_tpu_torch', 'ops', 'dp_kernels.py')):
        fail(f'no pav_tpu_torch package beside {__file__}: run from a checkout of the repo')
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs one CUDA GPU')
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, 'tests'))

    # 1. environment
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import pandas
    log(f'torch {torch.__version__} (CUDA {torch.version.cuda}), numpy {np.__version__}, '
        f'pandas {pandas.__version__}, python {sys.version.split()[0]}')
    kind = torch.cuda.get_device_name(0)
    log(f'device: {kind} (count {torch.cuda.device_count()})')
    dev = torch.device(DEVICE, 0) if DEVICE == 'cuda' else torch.device(DEVICE)

    # 2. build
    from pav_tpu_torch import _build
    t0 = time.time()
    _build.lib()
    log(f'build: {time.time() - t0:.2f} s ({"cached" if _build.BUILD_INFO["cached"] else "nvcc"}) '
        f'{_build.BUILD_INFO["path"]}')
    for line in _build.BUILD_INFO['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')

    # 3. kernels against their plain versions
    stats = phase_kernels(dev)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
        main_launches = drive_main_path(work, card)

    if 'jax' in sys.modules:
        fail('jax was imported')
    kernels = [{'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
                'launches': main_launches[key], 'max_abs_err': stats[name]['err'],
                'ms': stats[name]['ms'], 'plain_ms': stats[name]['plain_ms']}
               for name, (src, rep, key) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


def drive_main_path(work, card):
    """Phases 4-6; returns the kernel launches of phases 4 and 5."""
    from pav_tpu_torch.ops import dp_kernels

    # 4. main path, 16 Mbp diploid
    t0 = time.time()
    ref, h1, h2 = bench_genome(BENCH_REF_LEN, 11)
    log(f'genome: {len(ref) / 1e6:g} Mbp reference, haps {len(h1)} + {len(h2)} bp '
        f'({time.time() - t0:.1f} s)')
    dp_kernels.launches_reset()
    run_dir, wall = run_sample(work, 'bench16', ref,
                               {'h1': ('tig_h1', h1), 'h2': ('tig_h2', h2)}, DEVICE)
    main_launches = dict(dp_kernels.LAUNCHES)
    recs = vcf_records(os.path.join(run_dir, 'bench16.vcf.gz'))
    mbp = (len(h1) + len(h2)) / 1e6
    log(f'main path {len(ref) / 1e6:g} Mbp diploid: {len(recs)} VCF records, wall {wall:.2f} s, '
        f'{mbp / wall:.3f} contig Mbp/s on {card}; launches {main_launches}')
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, 'bench16')))
    if not recs:
        fail('the 16 Mbp VCF has no records')
    if main_launches['full'] <= 0 or main_launches['traceback'] <= 0:
        fail(f'the main path did not launch the full/traceback kernels: {main_launches}')

    # 5. repeat-rich sample: the wavefront band kernel
    rref, rhap = repeat_genome(REPEAT_REF_LEN, 18)
    before = dict(dp_kernels.LAUNCHES)
    run_dir, wall = run_sample(work, 'rep2', rref, {'h1': ('rtig1', rhap)}, DEVICE)
    rep_launches = {k: dp_kernels.LAUNCHES[k] - before[k] for k in before}
    for k in main_launches:
        main_launches[k] = dp_kernels.LAUNCHES[k]
    log(f'repeat-rich {len(rref) / 1e6:g} Mbp: wall {wall:.2f} s, {len(rhap) / 1e6 / wall:.3f} contig '
        f'Mbp/s on {card}; launches {rep_launches}')
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, 'rep2')))
    if rep_launches['wave'] <= 0:
        fail(f'the repeat-rich sample did not launch the wave kernel: {rep_launches}')

    # 6. cuda vs cpu on the e2e genome
    ref, h1, h2 = e2e_genome()
    haps = {'h1': ('tig1_1', h1), 'h2': ('tig2_1', h2)}
    extra = ('--set', 'aligner_min_chain_score=500')
    run_gpu, _ = run_sample(work, 'samp1', ref, haps, DEVICE, extra)
    run_cpu, _ = run_sample(work, 'samp1', ref, haps, 'cpu', extra)
    gpu_recs = vcf_records(os.path.join(run_gpu, 'samp1.vcf.gz'))
    cpu_recs = vcf_records(os.path.join(run_cpu, 'samp1.vcf.gz'))
    if not gpu_recs or gpu_recs != cpu_recs:
        fail(f'cuda and cpu VCFs differ ({len(gpu_recs)} vs {len(cpu_recs)} records)')
    log(f'parity: cuda and cpu VCFs of the e2e genome identical ({len(gpu_recs)} records)')
    return main_launches


if __name__ == '__main__':
    sys.exit(main())
