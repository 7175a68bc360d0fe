#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, parity, main path.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --dp-full-times
    python3 chip_smoke.py --seed-times
    python3 chip_smoke.py --chrom
    python3 chip_smoke.py --wide
    python3 chip_smoke.py --asm

With ``--kernel-times`` it only times the DP kernels, the walker and the
chain scan of the checkout it sits in (phase 3's inputs and device timing,
no parity) at every phase-3 shape and tape, and prints one JSON line
{"root", "card", "chain_step_ns", "kernels": {"dp_full": [[B, max_m, max_n,
ms, bound_ms, how], ...], "dp_wave": [[B, max_m, max_n, width, ms,
bound_ms, how], ...], "dp_band": [[B, max_m, max_n, width, ms, bound_ms,
how], ...], "traceback": [[tape, ms, bound_ms, how, longest path,
windowed ms, how], ...], "chain_scan": [[label, B, n, ms, how, bound_ms,
dependency_bound_ms, native.chain_dp host ms], ...]}} (the chain scan also
at 64 x 4096 with limits of 2^31, its int -> float path); the walker's
windowed design is timed beside the default at every tape where the
checkout's library can force it (``pav_traceback_whole_max``). Phase 3 of
a full run takes its device times from such a fresh process.
``--dp-full-times`` prints the dp_full part alone as {"root", "card",
"shapes": [...]}. ``--seed-times`` runs phase 3's seeding part alone
(``seed_times``) and prints its JSON line. ``--chrom`` runs phases
1, 2 and 11 alone, ``--wide`` phases 1, 2 and 13, ``--asm`` phases 1, 2
and 14; none prints a result line. A copy of this file
placed in another checkout (``git archive`` of a parent commit) times that
checkout's kernels: run the two in one call, in turns (A, B, B, A), to
compare two versions on one card.

Phases (each prints its lines; any failure exits nonzero):
  1. environment: nvidia-smi name and power limit, versions, device name;
  2. build: nvcc builds pav_tpu_torch/csrc/*.cu (one process per source),
     timed;
  3. kernels: each CUDA kernel against its plain PyTorch version, bit for bit,
     on CUDA tensors at the DP classes of the main path and, for the chain
     scan, at 64 slabs x 4096 anchors; the kernel's device time from a
     fresh ``--kernel-times`` process and the plain version's time (one
     run, the compared one). The row band (dp_band) at every BAND_SHAPES
     class on random and related inputs: score, tape and offsets against
     align_band_ref, which runs on CPU copies (it is CPU only). The walker
     runs on the tapes of the first
     TRACED_FULL classes, of both WAVE_SHAPES and on edge tapes (a
     whole-row deletion run, a whole-column insertion run, padded items
     with m = n = 0, B = 1, a band exit that sets err); each line gives the
     longest path and ns per step. The chain scan also at one slab of 2^20
     anchors against the native host kernel it stands in for (bit for bit,
     and its host time), with its bound over the card and its dependency
     bound (n steps of the probe's dependent chain). Then minimizer
     seeding at chr21's length (``seed_times``): the device index's tables
     against MinimizerIndex, a contig's sorted anchors against the host
     path, and the sketch, run and probe/fill wrappers against their plain
     versions on the same CUDA inputs, all bit for bit, each kernel's device
     time from one trace. Then the batched
     density on CUDA against the same call on the CPU (decision level),
     with its bound at DENSITY_LONG;
  4. main path: a 16 Mbp reference and a diploid sample (the generator of
     bench.py, seed 11) from FASTA through ``python -m pav_tpu_torch
     --device cuda`` to a VCF; the full-width, traceback and seeding
     kernels must run.
     The wall, the launches, torch's peak device memory and nvidia-smi's
     samples (memory, power, clocks, utilisation) are read from that run,
     without a profiler; its VCF must meet tests/test_recall.py's recall
     and precision floors against the planted truth. The same sample then
     runs again under a CUDA-activity trace (equal VCF records) for the
     device time by kernel;
  5. wavefront path: a 2 Mbp repeat-rich sample through the same CLI; the
     wavefront kernel must run. Wall and launches without a profiler; the
     sample again under a CUDA-activity trace (equal VCF records) for the
     device time by kernel and by launch grid. Then each sample's DP class
     table (launches, items, cells, path lengths), each class timed alone,
     and the per-run bounds of dp_full, dp_wave and the walker;
  6. parity: the e2e test genome through the CLI on cuda, and on the cpu
     (plain versions) through ``Pipeline(ladder='accel')``, the CUDA path's
     classes: identical VCF records;
  7. mesh: phase 4's h1 through ``Aligner.align_store`` unsharded and with
     its DP sharded over the mesh [cuda:0, cuda:0]; equal tables, balanced
     shards;
  8. chain fallback: the same through ``Aligner.align_store`` with the
     native chain kernel missing, so chaining runs the chain scan kernel on
     the card, each contig's anchors cut into exact pieces and scanned in
     one launch; the table equals the native run's;
  9. cohort: two 16 Mbp diploid samples on one reference through one CLI
     process, then through a 2-process cohort (``--coordinator``,
     ``--ship-artifacts``) on the one card, both without a profiler (the
     samples-per-hour ratio), then the cohort again with ``--profile-dir``;
     equal VCF records, kernels in each profiled process's trace;
 10. entry points: ``entry.entry()`` on the card against align_band_ref
     (bit for bit), then ``entry.dryrun_multichip(2)`` over the mesh
     [cuda:0, cuda:0] against the same dry run on the CPU; the row band,
     full-width, walker and chain scan kernels must launch (dp_band's
     launches in the kernels line are this phase's);
 11. chromosome scale: bench.py's chromosome sample (100 Mbp reference,
     seed 28, about 200 contig Mbp) through the same CLI in a child process
     (``--cli-child``), twice: a warm-up, then the measured run (wall, stage
     seconds, launches, DP class table with the DP kernel and the walker
     timed per class, density paths, the child's peak RSS from os.wait4 and
     torch's peak allocation in it, nvidia-smi samples beside it); equal VCF
     records in both, the full-width, traceback and seeding kernels must
     run, the
     walker's launches are timed on the run's own tapes in the warm-up run
     (the measured run carries no such instrumentation), and the VCF must
     meet the recall floors against the planted truth;
 13. kilobase SVs (pav_tpu_torch.synth.wide_genome: bench.py's generator
     with 30% of its SVs of 2-10 kb), whose DP segments take dp_full's wide
     path: (a) a 400 kb genome through the CLI on cuda and on the cpu
     through ``Pipeline(ladder='accel')``: identical VCF records, widths
     8193 and 32769 launched on the card; (b) wide16 (16 Mbp, seed 41)
     measured as phase 4 is, both widths and the walker launched, its VCF
     records equal to pav_tpu's on its accelerator branch (a digest from
     tests/wide_reference.py, synth.WIDE16_REFERENCE), held to the recall
     floors and its SVs of >= 2 kb to the INS and DEL floors, then again
     under a CUDA-activity trace (equal VCF records; dp_full by launch
     grid, the walker on the run's tapes), its DP class table, and each of
     its classes (dp_full at widths 8193 and 32769, dp_wave's 8192-row
     class) at its own shape and batch, kernel and walker against their
     plain versions bit for bit;
 14. assemblies shaped like users' (pav_tpu_torch.synth.asm_genome:
     GRCh38's chr21 and chr22 lengths, each haplotype cut into contigs on
     both strands, some overlapping, in shuffled FASTA order): (a)
     asm_tiny (1/200 of the lengths) through the CLI on cuda and on the cpu
     through ``Pipeline(ladder='accel')``: identical VCF records; asm10
     (1/10) through the CLI on cuda: its records equal to pav_tpu's on its
     accelerator branch (a digest from tests/test_torch_asm_reference.py,
     synth.ASM10_REFERENCE), held to the recall floors; both runs must read
     reverse-strand windows in the resident gather (flags 2 and 3), plan
     more than one contig a haplotype, merge over 2 chromosome batches on
     the sharded branch and trim the contigs' overlaps; (b) asm97 (full
     length, 97.5 Mbp) through the CLI in a child process, measured as
     phase 11's run is (wall, stage seconds, ALIGN_STATS_BY_HAP,
     launches, DP class table, gather flags, density paths, peak RSS,
     torch's peak allocation, nvidia-smi samples, contig count and NG50),
     the same paths and the floors held. Where a floor is missed only
     through records within 1 kb of a contig end, it is held on the rest
     and the records set aside are counted (ROADMAP C12).
The line before last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs one CUDA device, nvcc and no network;
imports no jax.
"""

import contextlib
import gzip
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
SCORING = (1, -5, 5, 56, 4, 1)
_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)

DEVICE = 'cuda'
BENCH_REF_LEN = 16_000_000     # phase 4 reference (bench.py's headline size)
REPEAT_REF_LEN = 2_000_000     # phase 5 repeat-rich reference
# Phase 3 classes: full width (B, max_m, max_n) and wavefront (B, max_m,
# max_n, width).
FULL_SHAPES = [(4096, 16, 16), (512, 256, 256), (64, 2048, 2048), (16, 16, 32768),
               # bench16's classes by dp_full time (the first carries ~90%)
               (8, 2048, 2048), (8, 32, 2048), (128, 16, 64), (256, 16, 1024),
               (1024, 16, 16), (64, 16, 256), (1024, 16, 32),
               # the widths 8193 (the 512 x 8192 class) and 8194
               (16, 512, 8192), (8, 16, 8193),
               # width 129, a power-of-two class of the main path that
               # bench16 happens not to launch (dp_full_warp<32, 4>)
               (256, 16, 128),
               # the 128 x 32769 class, the largest item of the wide path, at
               # half its batch cap (align/aligner/core.py _shape_batch)
               (64, 128, 32768)]
TRACED_FULL = 6   # the first FULL_SHAPES whose tapes also go through the walker
WAVE_SHAPES = [(8, 8192, 8192, 513), (4, 8192, 8192, 2049)]
# Row-band classes (B, max_m, max_n, width): entry(), the dry run's device
# step, then the CPU ladder's real band classes at its batch cap
# (align/aligner/core.py _cpu_bucket, _cpu_shape_batch).
BAND_SHAPES = [(4, 64, 72, 65), (8, 32, 32, 33), (4096, 256, 256, 33),
               (255, 2048, 2048, 257), (31, 8192, 8192, 513), (8, 8192, 8192, 4097)]
CHAIN_SHAPE = (64, 4096)        # phase 3 chain scan parity: slabs x anchors
CHAIN_LONG = 1 << 20            # phase 3 chain scan alone: one slab
CHAIN_ARGS = (64, 19, 50000.0, 10000.0, 0.19)   # lookback, k, limits, gap scale
# Limits of 2^31 take the kernel's int -> float (I2F) forms; the engine's
# take the exact integer forms (csrc/chain_scan.cu).
CHAIN_ARGS_I2F = (64, 19, 2.0 ** 31, 2.0 ** 31, 0.19)
CHAIN_PROBE_STEPS = 1 << 20     # steps of the dependency-chain probe
DENSITY_LONG = (4, 1 << 18)     # phase 3 density: regions x n_pad
# Phase 11: bench.py's chromosome-scale sample at its default length,
# seed SEED + 17.
CHROM_REF_LEN = 100_000_000
CHROM_SEED = 28
# Phase 13's samples, widths and wide16's reference digest are
# pav_tpu_torch.synth's WIDE_SMALL, WIDE16, WIDE_WIDTHS and WIDE16_REFERENCE.
ASM_TIMEOUT = 600               # phase 14b: the asm97 CLI child's limit
# What nvidia-smi samples beside a measured run, every SMI_PERIOD_MS.
SMI_QUERY = 'memory.used,power.draw,clocks.sm,clocks.mem,utilization.gpu'
SMI_PERIOD_MS = 200
TRACE_KERNEL = 'dp_full'       # phase 9: a dp_full kernel must appear in each trace
# Kernel names hold these (the walker's kernels are traceback_*).
NEEDLES = {'dp_full': 'dp_full', 'dp_wave': 'dp_wave', 'dp_band': 'dp_band',
           'traceback': 'traceback', 'chain_scan': 'chain_scan'}
# Bounds (bound_ms): the larger of bytes over HBM and operations over the
# peak rate of their type. NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s
# HBM3; 67 TFLOP/s float32 outside the tensor cores. int32, which the data
# sheet does not list: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost =
# 16.7 T op/s (Hopper white paper lanes and clock).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
FP32_OPS_S = 67e12
# int32 operations per DP cell, counted on the plain versions' recurrences:
# full width: E1/E2 open, extend, max (6), E max (1), substitution compare
# and select (2), diagonal add (1), Htilde max (1), a = Htilde + j*e (2),
# running prefix max (2), F (2), open-at-left compares (2), F and H max (2),
# eight tape bits each a compare and an or-shift into the byte (16), the
# three validity selects (3): 40. Wavefront: the same plus F's own
# open/extend/max per piece instead of the scan (6 for 4) and the band's
# neighbour selects (7): 49. Traceback: one step of the walk (the branches
# of traceback_ref's step body): 40. Chain scan: per anchor and lookback
# candidate (64): distances, limits, the log2, gap cost FMA, score and the
# running argmax: 20 float32/int32 operations. Density, per region: nine
# real FFTs of N = 4 n_pad points (3 histograms, 3 kernels, 3 inverse) at
# 2.5 N log2 N float32 operations each (half a complex FFT's 5 N log2 N),
# and the 3 (N/2 + 1) complex products at 6 each. Row band, counted on
# align_band_ref's recurrence as the full width is on align_full_ref's: the
# full-width cell (40) plus the global column off + w (1), the window tests
# of the two shifted indices w + s and w + s - 1 (2), the selects of the
# four shifted neighbours (H up, H diagonal, E1 up, E2 up) (4) and the
# column-0 sentinel select of the substitution (1): 48.
OPS_FULL_CELL = 40
OPS_WAVE_CELL = 49
OPS_BAND_CELL = 48
OPS_TRACE_STEP = 40
OPS_CHAIN_PAIR = 20
KERNELS = {
    # name: (source, TPU kernel replaced, LAUNCHES key)
    'dp_full': ('pav_tpu_torch/csrc/dp_full.cu', 'pav_tpu/ops/pallas_dp.py:62', 'full'),
    'dp_wave': ('pav_tpu_torch/csrc/dp_wave.cu', 'pav_tpu/ops/pallas_dp.py:227', 'wave'),
    'dp_band': ('pav_tpu_torch/csrc/dp_band.cu', 'pav_tpu/ops/affine_dp.py:192', 'band'),
    'traceback': ('pav_tpu_torch/csrc/traceback.cu', 'pav_tpu/ops/affine_dp.py:767',
                  'traceback'),
    'chain_scan': ('pav_tpu_torch/csrc/chain_scan.cu', 'pav_tpu/ops/chain_scan.py:20',
                   'chain_scan'),
    # Minimizer seeding replaces no TPU kernel: pav_tpu seeds on the host.
    'seed_sketch': ('pav_tpu_torch/csrc/seed.cu', 'none (host: native/minimizer.cpp)',
                    'sketch'),
    'seed_runs': ('pav_tpu_torch/csrc/seed.cu', 'none (host: np.unique in index.py)', 'runs'),
    'seed_probe': ('pav_tpu_torch/csrc/seed.cu', 'none (host: native/lookup.cpp)', 'probe'),
    'seed_fill': ('pav_tpu_torch/csrc/seed.cu', 'none (host: native/lookup.cpp)', 'fill'),
}


def launches_reset():
    """Zero the launch counters of every kernel in KERNELS."""
    from pav_tpu_torch.ops import chain_scan, dp_kernels, seed
    dp_kernels.launches_reset()
    chain_scan.launches_reset()
    seed.launches_reset()


def launches_read():
    """{KERNELS' LAUNCHES key: launches since launches_reset}."""
    from pav_tpu_torch.ops import chain_scan, dp_kernels, seed
    return dict(dp_kernels.LAUNCHES, chain_scan=chain_scan.LAUNCHES['chain_scan'],
                **seed.LAUNCHES)


def require_main_path(name, launches):
    """Fail unless a main-path run launched the full-width DP, the walker
    and every seeding kernel (its index and its contigs' anchors seeded on
    the card)."""
    missing = [key for key in ('full', 'traceback', 'sketch', 'runs', 'probe', 'fill')
               if launches[key] <= 0]
    if missing:
        fail(f'{name} did not launch {missing}: {launches}')


def require_native_text(run_dir, name, fastas=3):
    """Fail unless the text codec read every FASTA of sample ``name`` (the
    reference and each haplotype: ``fastas`` ``io.fasta`` spans) and wrote
    every table under the sample's directory and its VCF (one
    ``emit.table`` span a file), all on its native path."""
    import csv
    with open(os.path.join(run_dir, name, 'spans.tsv'), newline='') as fh:
        rows = [r for r in csv.DictReader(fh, delimiter='\t')
                if r['NAME'] in ('io.fasta', 'emit.table')]
    reads = sum(r['NAME'] == 'io.fasta' for r in rows)
    files = 1 + sum(f.endswith('.tsv.gz') for _, _, names in os.walk(os.path.join(run_dir, name))
                    for f in names)
    off = [r['COUNTS'] for r in rows if 'on=native' not in r['COUNTS'].split(',')]
    if reads != fastas or len(rows) - reads != files or off:
        fail(f'{name}: {reads} io.fasta spans for {fastas} FASTAs, {len(rows) - reads} '
             f'emit.table spans for {files} files (tables and VCF), not native: {off[:3]}')
    log(f'{name}: {reads} io.fasta and {len(rows) - reads} emit.table spans '
        f'({files} files), all on=native')


def require_native_aligner(run_dir, name):
    """Fail unless the aligner's host path planned every contig of sample
    ``name`` and assembled each haplotype's records natively: its
    ``align.plan_contig`` and ``align.emit`` spans all read ``on=native``
    (``hostplan.BUILD_INFO`` says why where they do not)."""
    import csv
    from pav_tpu_torch.align.aligner import hostplan
    with open(os.path.join(run_dir, name, 'spans.tsv'), newline='') as fh:
        rows = [r for r in csv.DictReader(fh, delimiter='\t')
                if r['NAME'] in ('align.plan_contig', 'align.emit')]
    emits = sum(r['NAME'] == 'align.emit' for r in rows)
    off = [r['COUNTS'] for r in rows if 'on=native' not in r['COUNTS'].split(',')]
    if not emits or emits == len(rows) or off:
        fail(f'{name}: {len(rows) - emits} align.plan_contig and {emits} align.emit spans, '
             f'not native: {off[:3]}; planner build: {hostplan.BUILD_INFO}')
    log(f'{name}: {len(rows) - emits} align.plan_contig and {emits} align.emit spans, '
        f'all on=native')


def log(msg):
    print(msg, flush=True)


def stamp(label):
    log(f'[{time.time() - T0:.0f} s] {label}')


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


def related_inputs(B, max_m, max_n, seed):
    """Related pairs: a random reference of [max_n/2, max_n] bases and a
    query that is it with SNVs and 1-8 base indels, cut to max_m; code-4
    padding past each length."""
    rng = np.random.default_rng(seed)
    q = np.full((B, max_m), 4, np.int8)
    r = np.full((B, max_n), 4, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        rr = rng.integers(0, 4, int(rng.integers(max_n // 2, max_n + 1))).astype(np.int8)
        qq = rr.copy()
        for _ in range(max(4, len(rr) // 64)):
            p = int(rng.integers(0, max(len(qq) - 9, 1)))
            x = rng.random()
            if x < 0.6:
                qq[p] = (qq[p] + 1) % 4
            elif x < 0.8:
                qq = np.delete(qq, slice(p, p + int(rng.integers(1, 9))))
            else:
                qq = np.insert(qq, p, rng.integers(0, 4, int(rng.integers(1, 9))).astype(np.int8))
        qq = qq[:max_m]
        q[b, :len(qq)], r[b, :len(rr)] = qq, rr
        m[b], n[b] = len(qq), len(rr)
    return q, r, m, n


def edge_tapes(dev):
    """Tapes that stress the walker's staged windows, made by the DP
    kernels: [(label, tb, offs, q, r, m, n, wave)]."""
    import torch
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K
    rng = np.random.default_rng(900)
    out = []

    def full(label, *arrays):
        q, r, m, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
        tb, offs = K.align_full(q, r, m, n, SCORING)
        out.append((label, tb, offs, q, r, m, n, False))

    # A whole-row deletion run: 16 query bases found inside 2048 reference
    # bases, so the walk crosses the tape's columns window after window.
    r = rng.integers(0, 4, (16, 2048)).astype(np.int8)
    starts = rng.integers(0, 2048 - 16, 16)
    q = np.stack([r[b, s:s + 16] for b, s in enumerate(starts)])
    full('row deletion 16 x 16 x 2049', q, r, np.full(16, 16, np.int32),
         np.full(16, 2048, np.int32))
    # A whole-column insertion run: 16 reference bases inside a 2048-base
    # query, so the walk goes straight up the rows.
    q = rng.integers(0, 4, (8, 2048)).astype(np.int8)
    r = np.stack([q[b, s:s + 16] for b, s in enumerate(rng.integers(0, 2048 - 16, 8))])
    full('column insertion 8 x 2048 x 17', q, r, np.full(8, 2048, np.int32),
         np.full(8, 16, np.int32))
    # Padded items (m = n = 0) and pure edges (m = 0 < n, n = 0 < m).
    q, r, m, n = dp_inputs(8, 64, 256, 901)
    m[:3] = 0
    n[:2] = 0
    n[4] = 0
    full('padded m = n = 0 8 x 64 x 257', q, r, m, n)
    # B = 1: a related pair whose walk crosses many windows up-left.
    full('related B=1 1 x 2048 x 2049', *related_inputs(1, 2048, 2048, 902))
    # A band exit: a 384-lane wave tape walked within its first 128 lanes,
    # so every walk leaves the band (err set) and reads clamped lanes.
    q, r, m, n = (torch.from_numpy(a).to(dev) for a in related_inputs(4, 1024, 1024, 903))
    doffs = affine_dp._wave_geometry(m, n, 1024, 1024, 2048, 384)
    tb = K.align_wave(q, r, m, n, doffs, 384, SCORING)[:, :, :128].contiguous()
    out.append(('band exit 4 x 1024 x 1024, 128 of 384 lanes', tb, doffs, q, r, m, n, True))
    return out


def chain_inputs(B, n, seed):
    """int32 [B, n] anchor slabs like the aligner's: slab 0 full, the others
    of ragged length in [n/2, n]; qpos ascending about 10 bp apart, rpos =
    qpos + jitter in [-25, 25), group 0 then 1 (second half), padding
    anchors zero with group -9."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, n), dtype=np.int32)
    r = np.zeros((B, n), dtype=np.int32)
    g = np.full((B, n), -9, dtype=np.int32)
    for b in range(B):
        ln = n if b == 0 else int(rng.integers(n // 2, n + 1))
        qp = np.sort(rng.integers(0, 10 * ln, ln))
        q[b, :ln] = qp
        r[b, :ln] = qp + rng.integers(-25, 25, ln)
        g[b, :ln] = np.arange(ln) >= ln // 2
    return q, r, g


def chain_piece_anchors(seed, groups=3, clusters=4, per=60, max_dist=50000):
    """Sorted anchors (group, rpos, qpos) in several groups, each group a
    few clusters of diagonal anchors separated by rpos gaps > max_dist:
    the exact pieces the chain fallback cuts at (groups x clusters)."""
    rng = np.random.default_rng(seed)
    q, r, g = [], [], []
    for gi in range(groups):
        r0 = int(rng.integers(0, 1000))
        for _ in range(clusters):
            qp = np.sort(rng.integers(0, 20 * per, per))
            rp = r0 + qp + rng.integers(-30, 30, per)
            q.append(qp)
            r.append(rp)
            g.append(np.full(per, gi))
            r0 = int(rp.max()) + max_dist + int(rng.integers(1, 5000))
    q, r, g = (np.concatenate(x).astype(np.int64) for x in (q, r, g))
    order = np.lexsort((q, r, g))
    return q[order], r[order], g[order]


def chain_tie_slab(blocks=6, dup=20):
    """Blocks of ``dup`` identical anchors (which cannot chain to each
    other: dq = 0) and one follower on their diagonal: every predecessor of
    the first follower gives the same candidate, 2k."""
    q, r = [], []
    for b in range(blocks):
        q += [1000 * b] * dup + [1000 * b + 50]
        r += [1000 * b + 7] * dup + [1000 * b + 57]
    return np.array(q, np.int64), np.array(r, np.int64), np.zeros(len(q), np.int64)


def density_regions(count, lo, hi, seed):
    """State-label regions in runs (FWD / FWDREV / REV, 5% noise) with
    Scott sigmas at bandwidth factor 0.25; lengths in [lo, hi)."""
    from pav_tpu_torch.ops import kde
    rng = np.random.default_rng(seed)
    regions, sigmas = [], []
    for _ in range(count):
        n = int(rng.integers(lo, hi))
        st = np.zeros(n, dtype=np.int8)
        pos = 0
        while pos < n:
            ln = int(rng.integers(50, max(51, n // 6)))
            st[pos:pos + ln] = rng.choice(3, p=[0.5, 0.1, 0.4])
            pos += ln
        noise = rng.random(n) < 0.05
        st[noise] = rng.integers(0, 3, int(noise.sum()))
        regions.append(st)
        sigmas.append(kde.scott_sigmas(st, 0.25))
    return regions, sigmas


def write_fasta(path, records):
    with open(path, 'wb') as fh:
        for name, codes in records.items():
            seq = _DECODE[np.minimum(codes, 4)].tobytes()
            fh.write(f'>{name}\n'.encode())
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + b'\n')


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


def device_ms(fn, reps, needle):
    """(ms, how): the median device time of the kernels whose name holds
    ``needle`` over ``reps`` calls of ``fn``, from a CUDA-activity
    torch.profiler trace, as phase 4 traces (how = 'profiler'): the kernel's
    own time, without the host time of the call. A trace that lost the
    kernels' records is taken again; after three such traces the time is
    that of ``reps`` calls queued behind a sleep kernel (how = 'queued':
    the call's other device work, such as a zero fill, included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.NamedTemporaryFile(suffix='.json') as fh:
            prof.export_chrome_trace(fh.name)
            with open(fh.name) as trace:
                events = json.load(trace).get('traceEvents', [])
        durs = [ev['dur'] / 1e3 for ev in events
                if ev.get('cat') == 'kernel' and needle in ev.get('name', '')]
        if durs:
            return float(np.median(durs)), 'profiler'
    log(f'  (no {needle} kernel in three profiler traces: timed queued behind a sleep)')
    return queued_ms(fn, reps), 'queued'


def queued_ms(fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` enqueued while the stream runs a
    sleep kernel, between CUDA events: back to back on the device, so the
    host time of a call is hidden (the call's other device work, such as a
    zero fill, is included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)    # ~20 ms at 1.98 GHz: the calls queue up behind it
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def bound(ops, ops_rate, nbytes):
    """(bound_ms, bound_by): the larger of nbytes over HBM and ops over
    ops_rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_S
    t_ops = 1e3 * ops / ops_rate
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def full_bound(B, mm, nn):
    """dp_full at (B, max_m, max_n): every padded cell of the tape is an
    output byte and is computed (rows past m and columns past n included)."""
    cells = B * mm * (nn + 1)
    return bound(cells * OPS_FULL_CELL, INT32_OPS_S, B * (mm + nn + 8) + cells)


def wave_bound(B, mm, nn, ww):
    cells = B * (mm + nn) * ww
    return bound(cells * OPS_WAVE_CELL, INT32_OPS_S,
                 B * (mm + nn + 8) + 4 * B * (mm + nn) + cells)


def item_bound(cells, ops_cell):
    """The one-item-per-SM bound in ms: an item's cells at one SM's INT32
    issue rate (64 lanes x 1.98 GHz), the least time an item takes on one
    SM; a bound for a batch of fewer items than the card has SMs, where each
    item keeps to one SM."""
    return 1e3 * cells * ops_cell / (64 * 1.98e9)


def band_bound(B, mm, nn, width):
    """dp_band at (B, max_m, max_n, width): every window cell is computed
    and is an output byte; q, r and the lengths read, offsets and the last
    row's scores written."""
    cells = B * mm * width
    return bound(cells * OPS_BAND_CELL, INT32_OPS_S,
                 B * (mm + nn + 8) + cells + 4 * B * (mm + width))


def path_lengths(out):
    """The path length of every row of a fused walker output."""
    lens = out[:, -5:-1].cpu().numpy().astype(np.int64)
    return (lens << (8 * np.arange(4, dtype=np.int64))).sum(axis=1)


def walk_bound(steps, items, out_bytes):
    """The walk of ``steps`` path steps: per step one tape byte and two base
    codes read; the items' lengths read and the fused output written."""
    return bound(steps * OPS_TRACE_STEP, INT32_OPS_S, 3 * steps + 8 * items + out_bytes)


def trace_bound(out):
    """walk_bound of one launch's paths, from its fused output."""
    return walk_bound(int(path_lengths(out).sum()), out.shape[0], out.numel())


def chain_bound(B, n, lookback=CHAIN_ARGS[0]):
    """The chain scan over the card: every anchor scans its lookback
    (OPS_CHAIN_PAIR float32/int32 operations a pair); 3 int32 inputs and 2
    4-byte outputs per anchor."""
    return bound(B * n * lookback * OPS_CHAIN_PAIR, FP32_OPS_S, 20 * B * n)


def chain_step_ns(dev):
    """(ns, how) of one step of the chain scan's dependency chain (a
    shuffle, an add, a subtract and a max, each waiting for the one before),
    from the library's probe, or (None, None) where it has none. A slab of
    n anchors cannot take less than n of these: the dependency bound."""
    import torch
    from pav_tpu_torch import _build
    probe = getattr(_build.lib(), 'pav_chain_step_probe', None)
    if probe is None:
        return None, None
    out = torch.zeros(32, dtype=torch.float32, device=dev)

    def run():
        _build.check(probe(out.data_ptr(), CHAIN_PROBE_STEPS,
                           torch.cuda.current_stream(dev).cuda_stream),
                     'pav_chain_step_probe')
    ms, how = device_ms(run, 3, 'chain_step_probe')
    return 1e6 * ms / CHAIN_PROBE_STEPS, how


def density_bound(count, n_pad):
    """smoothed_states_batch of ``count`` regions at ``n_pad``: the FFT
    operations (OPS note above); int8 labels in, int8 states out."""
    N = 4 * n_pad
    ops = count * (9 * 2.5 * N * np.log2(N) + 3 * (N // 2 + 1) * 6)
    return bound(ops, FP32_OPS_S, count * (2 * n_pad + 12))


# ------------------------------------------------------------------ phases

def fresh_kernel_times():
    """Phase 3's kernel times: this script with --kernel-times in a fresh
    process (in a long process the CUDA-activity traces lose kernel
    records; a fresh one has not lost any). Its log lines are relayed, its
    JSON line's kernels returned."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--kernel-times'],
                          capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f'--kernel-times exited {proc.returncode}:\n{proc.stdout[-3000:]}\n'
             f'{proc.stderr[-3000:]}')
    for line in lines[:-1]:
        log(f'  --kernel-times: {line}')
    kt = json.loads(lines[-1])['kernels']
    log(f'kernel times: a fresh --kernel-times process, {time.time() - t0:.1f} s')
    return kt


def phase_kernels(dev, kt):
    """Each DP kernel and the walker against its plain version at phase 3's
    shapes and tapes; device ms from ``kt`` (fresh_kernel_times)."""
    import torch
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K

    stats = {name: {'err': 0, 'ms': None, 'ms_by': None, 'plain_ms': None, 'bound_ms': None,
                    'bound_by': None, 'library_ms': None} for name in KERNELS}
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
        reps = 5 if mm * nn >= 1 << 22 else 20
        call_ms = median_ms(lambda: K.align_full(q, r, m, n, SCORING), reps)
        ms, how = kt['dp_full'][i][3], kt['dp_full'][i][5]
        bms, by = full_bound(B, mm, nn)
        extra = ''
        if B < 132:
            ibm = item_bound(mm * (nn + 1), OPS_FULL_CELL)
            extra = f'; one-item-per-SM bound {ibm:.4f} ms ({100 * ibm / ms:.1f}%)'
        log(f'kernel dp_full B={B} {mm}x{nn + 1}: bit-identical, {ms:.4f} ms device ({how}) '
            f'({call_ms:.4f} ms per call, CUDA events around the wrapper; plain '
            f'{pms:.2f} ms, one run); bound {bms:.4f} ms ({by}), '
            f'{100 * bms / ms:.1f}% of bound{extra}')
        if i == 0:
            stats['dp_full'].update(ms=ms, ms_by=how, plain_ms=pms, bound_ms=bms, bound_by=by)
        stats['dp_full']['err'] = max(stats['dp_full']['err'], err)
        if i < TRACED_FULL:
            tapes.append((f'full B={B} {mm}x{nn + 1}', tb, offs, q, r, m, n, False))
    for i, (B, mm, nn, width) in enumerate(WAVE_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(B, mm, nn, 200 + i))
        ww = affine_dp._wave_width(width)
        doffs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)
        tb = K.align_wave(q, r, m, n, doffs, ww, SCORING)
        tb_ref, pms = timed_ms(lambda: K.align_wave_ref(q, r, m, n, doffs, ww, SCORING))
        if not torch.equal(tb, tb_ref):
            fail(f'dp_wave differs from align_wave_ref at B={B} {mm}x{nn} w{width}')
        ms, how = kt['dp_wave'][i][4], kt['dp_wave'][i][6]
        bms, by = wave_bound(B, mm, nn, ww)
        extra = ''
        if B < 132:
            ibm = item_bound((mm + nn) * ww, OPS_WAVE_CELL)
            extra = f'; one-item-per-SM bound {ibm:.4f} ms ({100 * ibm / ms:.1f}%)'
        log(f'kernel dp_wave B={B} {mm}x{nn} width {width} ({ww} lanes): '
            f'bit-identical, {ms:.4f} ms device ({how}; plain {pms:.1f} ms, one run); bound '
            f'{bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound{extra}')
        if i == 0:
            stats['dp_wave'].update(ms=ms, ms_by=how, plain_ms=pms, bound_ms=bms, bound_by=by)
        tapes.append((f'wave B={B} {mm}x{nn} w{width}', tb, doffs, q, r, m, n, True))
    phase_band(dev, stats, kt)
    tapes += edge_tapes(dev)
    for i, (label, tb, offs, q, r, m, n, wave) in enumerate(tapes):
        out = K.traceback(tb, offs, q, r, m, n, wave)
        ref, pms = timed_ms(lambda: K.traceback_ref(tb, offs, q, r, m, n, wave))
        if not torch.equal(out, ref):
            fail(f'traceback differs from traceback_ref on the {label} tape')
        errs = int(ref[:, -1].sum().item())
        if label.startswith('band exit') and errs != ref.shape[0]:
            fail(f'only {errs} of {ref.shape[0]} walks left the band on the {label} tape')
        stats['traceback']['err'] = max(stats['traceback']['err'], max_abs_err(out, ref))
        ms, how = kt['traceback'][i][1], kt['traceback'][i][3]
        bms, by = trace_bound(out)
        longest = int(path_lengths(out).max())
        ibm = item_bound(longest, OPS_TRACE_STEP)
        log(f'kernel traceback on {label}: bit-identical, {ms:.4f} ms device '
            f'({how}; plain {pms:.1f} ms, one run); bound {bms:.5f} ms ({by}), '
            f'{100 * bms / ms:.1f}% of bound; longest path {longest} steps, '
            f'{1e6 * ms / max(longest, 1):.1f} ns per step; one-item-per-SM bound (the '
            f'longest path) {ibm:.5f} ms ({100 * ibm / ms:.2f}%); err on {errs} items')
        if i == 0:
            stats['traceback'].update(ms=ms, ms_by=how, plain_ms=pms, bound_ms=bms, bound_by=by)
    return stats


def band_cases(B, mm, nn, seed):
    """The row-band inputs of phase 3 at one class: random and related
    pairs (ragged m and n, some items shorter than the class)."""
    return (('random', dp_inputs(B, mm, nn, seed)),
            ('related', related_inputs(B, mm, nn, seed + 1)))


def phase_band(dev, stats, kt):
    """dp_band against align_band_ref at every BAND_SHAPES class, on
    random and related inputs: score, tape and offsets bit for bit; the
    plain version runs on CPU copies of the inputs (it is CPU only)."""
    import torch
    from pav_tpu_torch.ops import dp_kernels as K
    for i, (B, mm, nn, width) in enumerate(BAND_SHAPES):
        plain = []
        for kind, arrays in band_cases(B, mm, nn, 400 + 2 * i):
            host = [torch.from_numpy(a) for a in arrays]
            got = K.align_band(*(t.to(dev) for t in host), width, SCORING)
            t0 = time.perf_counter()
            want = K.align_band_ref(*host, width, SCORING, with_score=True)
            plain.append(1e3 * (time.perf_counter() - t0))
            for name, g, w in zip(('score', 'tape', 'offsets'), got, want):
                if not torch.equal(g.cpu(), w):
                    fail(f'dp_band {name} differs from align_band_ref at B={B} '
                         f'{mm}x{nn} width {width} ({kind} inputs)')
            stats['dp_band']['err'] = max(stats['dp_band']['err'],
                                          max_abs_err(got[1].cpu(), want[1]))
        ms, how = kt['dp_band'][i][4], kt['dp_band'][i][6]
        bms, by = band_bound(B, mm, nn, width)
        extra = ''
        if B < 132:
            ibm = item_bound(mm * width, OPS_BAND_CELL)
            extra = f'; one-item-per-SM bound {ibm:.4f} ms ({100 * ibm / ms:.1f}%)'
        log(f'kernel dp_band B={B} {mm}x{nn} width {width}: bit-identical (score, tape, '
            f'offsets; random and related), {ms:.4f} ms device ({how}); plain '
            f'{plain[0]:.1f} / {plain[1]:.1f} ms on the CPU (one run each); bound '
            f'{bms:.5f} ms ({by}), {100 * bms / ms:.1f}% of bound{extra}')
        if i == 0:
            stats['dp_band'].update(ms=ms, ms_by=how, plain_ms=plain[0], bound_ms=bms,
                                    bound_by=by)


def phase_chain_scan(dev, stats, kt):
    """The chain scan kernel against its plain version (bit for bit) at
    CHAIN_SHAPE, and at one CHAIN_LONG slab against native.chain_dp (bit
    for bit); device ms, the host kernel's ms and the bounds from ``kt``."""
    import torch
    from pav_tpu_torch import native
    from pav_tpu_torch.ops import chain_scan as C
    B, n = CHAIN_SHAPE
    q, r, g = (torch.from_numpy(a).to(dev) for a in chain_inputs(B, n, 700))
    f, p = C._chain_scan_batch(q, r, g, *CHAIN_ARGS)
    C._chain_scan_ref(q[:1, :64], r[:1, :64], g[:1, :64], *CHAIN_ARGS)   # warm-up
    (f_ref, p_ref), pms = timed_ms(lambda: C._chain_scan_ref(q, r, g, *CHAIN_ARGS))
    if not (torch.equal(f, f_ref) and torch.equal(p, p_ref)):
        fail(f'chain_scan differs from _chain_scan_ref at B={B} n={n}')
    if not bool((p >= 0).any()):
        fail('chain_scan chained no anchor')
    err = float((f - f_ref).abs().max().item())
    ql, rl, gl = chain_inputs(1, CHAIN_LONG, 701)
    f_long, p_long = C._chain_scan_batch(*(torch.from_numpy(a).to(dev) for a in (ql, rl, gl)),
                                         *CHAIN_ARGS)
    f_nat, p_nat = native.chain_dp(ql[0], rl[0], gl[0], CHAIN_ARGS[1], CHAIN_ARGS[0],
                                   *CHAIN_ARGS[2:])
    if not (np.array_equal(f_long[0].cpu().numpy(), f_nat)
            and np.array_equal(p_long[0].cpu().numpy().astype(np.int64), p_nat)):
        fail(f'chain_scan differs from native.chain_dp on one slab of {CHAIN_LONG} anchors')
    f2, p2 = C._chain_scan_batch(q, r, g, *CHAIN_ARGS_I2F)
    f2_ref, p2_ref = C._chain_scan_ref(q, r, g, *CHAIN_ARGS_I2F)
    if not (torch.equal(f2, f2_ref) and torch.equal(p2, p2_ref)):
        fail(f'chain_scan differs from _chain_scan_ref at B={B} n={n}, limits 2^31')
    checked = ('_chain_scan_ref', 'native.chain_dp', '_chain_scan_ref')
    for i, (label, b, nn, ms, how, bms, dep, host_ms) in enumerate(kt['chain_scan']):
        dep_note = ('no probe' if dep is None else
                    f'{dep:.4f} ms, {100 * dep / ms:.1f}% of it')
        log(f'kernel chain_scan at {label} (slabs x anchors): bit-identical ({checked[i]}), '
            f'{ms:.4f} ms '
            f'device ({how}); native.chain_dp on the host {host_ms:.2f} ms (median of 3); '
            f'bound over the card {bms:.4f} ms ({100 * bms / ms:.1f}%); dependency '
            f'bound {dep_note}')
        if i == 0:
            stats['chain_scan'].update(err=err, ms=ms, ms_by=how, plain_ms=pms,
                                       bound_ms=bms, bound_by=chain_bound(b, nn)[1],
                                       dependency_bound_ms=dep)
    log(f'kernel chain_scan {B} x {n}: plain version {pms:.1f} ms on the card, one run')


def check_states(label, regions, sigmas, got, want, dev):
    """smoothed_states_batch's CUDA states ``got`` against its CPU states
    ``want``: densities within rtol 1e-3 + 1e-5 of the largest, states
    equal wherever the CPU's top two densities differ by more than 1e-4
    relative. Returns (undecided positions, max density difference)."""
    import torch
    from pav_tpu_torch.ops import kde
    pad = kde._next_pow2(max(max(len(x) for x in regions), 16))
    batch = np.full((len(regions), pad), -1, dtype=np.int8)
    for i, x in enumerate(regions):
        batch[i, :len(x)] = x
    sig = torch.from_numpy(np.asarray(sigmas, dtype=np.float32).reshape(len(regions), 3))
    _, d_cpu = kde._density_state_kernel_batch(torch.from_numpy(batch), sig, pad, 3)
    _, d_dev = kde._density_state_kernel_batch(torch.from_numpy(batch).to(dev),
                                               sig.to(dev), pad, 3)
    d_cpu = d_cpu.numpy()
    d_dev = d_dev.cpu().numpy()
    if not np.all(np.abs(d_dev - d_cpu) <= 1e-3 * np.abs(d_cpu) + 1e-5 * np.abs(d_cpu).max()):
        fail(f'density {label}: CUDA densities outside the float32 tolerance')
    undecided = 0
    for i, (a, b) in enumerate(zip(got, want)):
        top2 = np.sort(d_cpu[i, :, :len(a)], axis=0)[-2:]
        decided = (top2[1] - top2[0]) > 1e-4 * np.maximum(np.abs(top2[1]), 1e-30)
        undecided += int((~decided).sum())
        if not np.array_equal(a[decided], b[decided]):
            fail(f'density {label}: CUDA and CPU states differ at decided positions')
    return undecided, float(np.abs(d_dev - d_cpu).max())


def phase_density(dev):
    """smoothed_states_batch on CUDA against the same call on the CPU, at
    the 16 regions of test_mesh_sharding.py and at DENSITY_LONG. States must
    agree wherever the CPU's top two densities differ by more than 1e-4
    relative; densities within rtol 1e-3 + 1e-5 of the largest (two float32
    FFTs, cuFFT and pocketfft, round differently)."""
    import torch
    from pav_tpu_torch.ops import kde
    cpu = torch.device('cpu')
    cases = [('16 regions of 500-3000', *density_regions(16, 500, 3000, 31))]
    count, n_pad = DENSITY_LONG
    cases.append((f'{count} regions at n_pad {n_pad}',
                  *density_regions(count, n_pad // 2 + 1, n_pad, 32)))
    for label, regions, sigmas in cases:
        kde.smoothed_states_batch(regions, sigmas, device=dev)   # cuFFT plans
        got, ms = timed_ms(lambda: kde.smoothed_states_batch(regions, sigmas, device=dev))
        t0 = time.perf_counter()
        want = kde.smoothed_states_batch(regions, sigmas, device=cpu)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        undecided, diff = check_states(label, regions, sigmas, got, want, dev)
        bms, by = density_bound(len(regions), kde._next_pow2(max(len(x) for x in regions)))
        log(f'density {label}: decisions equal ({undecided} undecided positions), '
            f'max |dens diff| {diff:.3g}; '
            f'{ms:.2f} ms on the card (one call after a warm-up, host copies '
            f'included), {cpu_ms:.1f} ms on the CPU; bound {bms:.4f} ms ({by}: '
            f'FFT float32 operations over 67 TFLOP/s)')


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


def write_sample(d, name, refs, haps):
    """Write the reference {chrom: codes} as d/ref.fa, each haplotype's
    {contig: codes} as d/<hap>.fa and sample ``name``'s assembly table as
    d/asm.tsv; returns the CLI's --ref and --assemblies arguments."""
    os.makedirs(d, exist_ok=True)
    write_fasta(os.path.join(d, 'ref.fa'), refs)
    cols, paths = [], []
    for hap, tigs in haps.items():
        path = os.path.join(d, f'{hap}.fa')
        write_fasta(path, tigs)
        cols.append(f'HAP_{hap}')
        paths.append(path)
    with open(os.path.join(d, 'asm.tsv'), 'w') as fh:
        fh.write('NAME\t' + '\t'.join(cols) + '\n' + name + '\t' + '\t'.join(paths) + '\n')
    return ['--ref', os.path.join(d, 'ref.fa'), '--assemblies', os.path.join(d, 'asm.tsv')]


def run_sample(work, name, ref, haps, device, extra=()):
    """Write FASTAs + assembly table under work/name (ref on chr1, one
    contig a haplotype: {hap: (contig, codes)}) and run the CLI."""
    d = os.path.join(work, name)
    argv = write_sample(d, name, {'chr1': ref}, {hap: dict([tig]) for hap, tig in haps.items()})
    run_dir = os.path.join(d, f'run_{device}')
    wall = run_cli([*argv, '--run-dir', run_dir, '--device', device, *extra])
    return run_dir, wall


def smi_memory_used():
    """The card's memory.used in MiB now (nvidia-smi)."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=memory.used', '--format=csv,noheader,nounits',
                          '-i', '0'], capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        fail(f'nvidia-smi gave no memory.used: {out.stdout!r} {out.stderr!r}')


@contextlib.contextmanager
def gpu_samples(path):
    """nvidia-smi samples SMI_QUERY every SMI_PERIOD_MS into ``path`` while
    the body runs, then stops; the yielded dict gets, per field, the
    samples' max and median, and 'samples' (their count). Fails when fewer
    than two samples or any unreadable value came back."""
    out = {}
    with open(path, 'w') as fh:
        proc = subprocess.Popen(['nvidia-smi', f'--query-gpu={SMI_QUERY}',
                                 '--format=csv,noheader,nounits', '-i', '0',
                                 '-lms', str(SMI_PERIOD_MS)],
                                stdout=fh, stderr=subprocess.DEVNULL)
        try:
            yield out
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    with open(path) as fh:
        lines = [line for line in fh.read().splitlines() if line.strip()]
    try:
        rows = np.array([[float(x) for x in line.split(',')] for line in lines])
    except ValueError:
        fail(f'nvidia-smi gave an unreadable sample in {path}: {lines[:3]}')
    if rows.ndim != 2 or rows.shape[0] < 2:
        fail(f'nvidia-smi gave {len(lines)} samples in {path}')
    out['samples'] = rows.shape[0]
    for i, key in enumerate(SMI_QUERY.split(',')):
        out[key] = (float(rows[:, i].max()), float(np.median(rows[:, i])))


def smi_note(s, before_mib):
    """One line of gpu_samples' results; ``before_mib``: memory.used before
    the run."""
    peak = s['memory.used'][0]
    return (f'nvidia-smi every {SMI_PERIOD_MS} ms, {s["samples"]} samples: peak memory.used '
            f'{peak:.0f} MiB ({peak - before_mib:.0f} MiB above the {before_mib:.0f} MiB '
            f'before the run); power.draw max {s["power.draw"][0]:.2f} W, median '
            f'{s["power.draw"][1]:.2f} W; clocks.sm max {s["clocks.sm"][0]:.0f} MHz, median '
            f'{s["clocks.sm"][1]:.0f} MHz; clocks.mem max {s["clocks.mem"][0]:.0f} MHz, median '
            f'{s["clocks.mem"][1]:.0f} MHz; utilization.gpu max {s["utilization.gpu"][0]:.0f}%, '
            f'median {s["utilization.gpu"][1]:.0f}%')


def cli_child(stats_path, argv):
    """--cli-child: the port's CLI (``pav_tpu_torch.__main__.main``, what
    ``python -m pav_tpu_torch`` runs) on ``argv`` in this process; then its
    wall, kernel launches, DP class table, density paths and the aligner's
    host seconds as JSON at ``stats_path``. The density paths are counted
    by wrapping kde's host and batch functions: calls and largest grid;
    torch's peak device allocation and reservation of the run, where CUDA
    was initialised. With ``--time-walks`` first in ``argv`` (a run that is
    not measured: it adds CUDA events, device-to-host copies and pinned
    host memory to the run), each walker launch (``dp_kernels.traceback``
    on a CUDA tape) on the run's own tapes: 'walk_ms' the time between CUDA
    events recorded on its stream around the call (the stream is mostly
    idle, so the host's time between the start event and the launch is
    inside), 'walk_device_ms' the kernel's device time (device_ms) when its
    inputs, copied to pinned host memory during the run, are walked again
    after it; one entry a launch."""
    import threading
    sys.path.insert(0, ROOT)
    from pav_tpu_torch.__main__ import main as cli_main
    from pav_tpu_torch.align.aligner import core
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels, kde
    density = {}
    lock = threading.Lock()

    def counted(fn, key_of):
        def wrapper(*args):
            key, grid = key_of(*args)
            with lock:
                calls, largest = density.get(key, (0, 0))
                density[key] = (calls + 1, max(largest, grid))
            return fn(*args)
        return wrapper
    kde._host_density_states = counted(kde._host_density_states,
                                       lambda s, *_: ('host float64', len(s)))
    kde._density_state_kernel_batch = counted(
        kde._density_state_kernel_batch,
        lambda s, sig, n_pad, *_: (f'torch.fft on {sig.device.type}', int(n_pad)))
    import torch
    time_walks = argv[:1] == ['--time-walks']
    argv = argv[1:] if time_walks else argv
    walks = []
    walk = dp_kernels.traceback

    def host_copy(t):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def timed_walk(tb, offs, q, r, m, n, wave):
        if not tb.is_cuda:
            return walk(tb, offs, q, r, m, n, wave)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = walk(tb, offs, q, r, m, n, wave)
        end.record()
        kept = [host_copy(t) for t in (tb, offs, q, r, m, n)]
        with lock:
            walks.append((start, end, kept, wave))
        return out
    if time_walks:
        dp_kernels.traceback = timed_walk
    t0 = time.time()
    rc = cli_main(argv)
    wall = time.time() - t0
    stats = {'rc': rc, 'wall': wall, 'torch_memory': None,
             'launches': launches_read(),
             'classes': [[list(k), list(v)] for k, v in affine_dp.STATS['classes'].items()],
             'density': density, 'align_stats_by_hap': core.ALIGN_STATS_BY_HAP,
             'gather_flags': affine_dp.STATS['gather_flags'],
             'walk_ms': [], 'walk_device_ms': []}
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        stats['torch_memory'] = [torch.cuda.max_memory_allocated(),
                                 torch.cuda.max_memory_reserved()]
        dev = torch.device('cuda', torch.cuda.current_device())
        for start, end, kept, wave in walks:
            stats['walk_ms'].append(start.elapsed_time(end))
            args = [t.to(dev) for t in kept]
            stats['walk_device_ms'].append(
                device_ms(lambda: walk(*args, wave), 3, NEEDLES['traceback'])[0])
    with open(stats_path, 'w') as fh:
        json.dump(stats, fh)
    return rc


def log_align_stats(by_hap):
    """Log the aligner's host seconds (core.ALIGN_STATS_BY_HAP, or a CLI
    child's copy), summed over the haplotypes and by haplotype."""
    total = {}
    for secs in by_hap.values():
        for k, v in secs.items():
            total[k] = total.get(k, 0.0) + v
    log('aligner host seconds (ALIGN_STATS_BY_HAP summed): ' + json.dumps(
        {k: round(v, 3) for k, v in sorted(total.items())}))
    log('aligner host seconds by haplotype (ALIGN_STATS_BY_HAP; the planning of a '
        'haplotype\'s contigs on the pool\'s threads summed): ' + json.dumps(
            {hap: {k: round(v, 3) for k, v in sorted(secs.items())}
             for hap, secs in sorted(by_hap.items())}))


def run_cli_child(d, argv, label, timeout, time_walks=False):
    """``chip_smoke.py --cli-child`` (the CLI on ``argv``; ``time_walks``:
    with --time-walks) as a child process; its output goes to
    ``d/label.log``. Returns (stats, process wall, peak RSS in bytes of
    that child alone, from os.wait4)."""
    stats_path = os.path.join(d, f'{label}_stats.json')
    log_path = os.path.join(d, f'{label}.log')
    with open(log_path, 'w') as fh:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), '--cli-child',
                                 stats_path, *(['--time-walks'] if time_walks else []), *argv],
                                stdout=fh, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=ROOT))
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        try:
            _, status, usage = os.wait4(proc.pid, 0)
        finally:
            timer.cancel()
        proc.returncode = os.waitstatus_to_exitcode(status)
        wall = time.time() - t0
    if proc.returncode != 0:
        with open(log_path) as fh:
            tail = fh.read()[-4000:]
        fail(f'{label}: the CLI child exited {proc.returncode} after {wall:.0f} s:\n{tail}')
    with open(stats_path) as fh:
        stats = json.load(fh)
    stats['classes'] = {tuple(k): tuple(v) for k, v in stats['classes']}
    return stats, wall, usage.ru_maxrss * 1024


def kernel_times(card, dev, dp_full_only=False):
    """--kernel-times (--dp-full-times: dp_full_only): device ms of this
    checkout's align_full at every FULL_SHAPES entry, align_wave at every
    WAVE_SHAPES entry and the walker on every phase-3 tape, on phase 3's
    inputs, beside the bounds, as one JSON line."""
    import torch
    from pav_tpu_torch import _build
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K
    rows = {'dp_full': [], 'dp_wave': [], 'dp_band': [], 'traceback': []}
    tapes = []
    for i, (B, mm, nn) in enumerate(FULL_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(B, mm, nn, 100 + i))
        ms, how = device_ms(lambda: K.align_full(q, r, m, n, SCORING),
                            5 if mm * nn >= 1 << 22 else 20, NEEDLES['dp_full'])
        rows['dp_full'].append([B, mm, nn, ms, full_bound(B, mm, nn)[0], how])
        if i < TRACED_FULL:
            tapes.append((f'full B={B} {mm}x{nn + 1}', *K.align_full(q, r, m, n, SCORING),
                          q, r, m, n, False))
    if dp_full_only:
        print(json.dumps({'root': ROOT, 'card': card, 'shapes': rows['dp_full']}), flush=True)
        return 0
    for i, (B, mm, nn, width) in enumerate(WAVE_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(B, mm, nn, 200 + i))
        ww = affine_dp._wave_width(width)
        doffs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)

        ms, how = device_ms(lambda: K.align_wave(q, r, m, n, doffs, ww, SCORING), 3,
                            NEEDLES['dp_wave'])
        rows['dp_wave'].append([B, mm, nn, width, ms, wave_bound(B, mm, nn, ww)[0], how])
        tapes.append((f'wave B={B} {mm}x{nn} w{width}', K.align_wave(q, r, m, n, doffs, ww, SCORING),
                      doffs, q, r, m, n, True))
    for i, (B, mm, nn, width) in enumerate(BAND_SHAPES):
        q, r, m, n = (torch.from_numpy(a).to(dev)
                      for a in band_cases(B, mm, nn, 400 + 2 * i)[0][1])
        ms, how = device_ms(lambda: K.align_band(q, r, m, n, width, SCORING),
                            3 if mm * width >= 1 << 22 else 10, NEEDLES['dp_band'])
        rows['dp_band'].append([B, mm, nn, width, ms, band_bound(B, mm, nn, width)[0], how])
    tapes += edge_tapes(dev)
    # Where the library can force it, the walker's windowed design at every
    # tape too (the default stages small tapes whole).
    whole_max = getattr(_build.lib(), 'pav_traceback_whole_max', None)
    for label, tb, offs, q, r, m, n, wave in tapes:
        def walk():
            return K.traceback(tb, offs, q, r, m, n, wave)
        out = walk()
        ms, how = device_ms(walk, 5, NEEDLES['traceback'])
        row = [label, ms, trace_bound(out)[0], how, int(path_lengths(out).max())]
        if whole_max is not None:
            old = whole_max(0)
            row += list(device_ms(walk, 5, NEEDLES['traceback']))
            whole_max(old)
        rows['traceback'].append(row)
    rows['chain_scan'], step_ns = chain_times(dev)
    print(json.dumps({'root': ROOT, 'card': card, 'chain_step_ns': step_ns,
                      'kernels': rows}), flush=True)
    return 0


def chain_times(dev):
    """The chain scan of this checkout (``_chain_scan_batch`` only) at
    CHAIN_SHAPE, at one CHAIN_LONG slab, and at CHAIN_SHAPE again with the
    limits of CHAIN_ARGS_I2F, on phase 3's inputs: ([[label, B, n, ms, how,
    bound_ms, dependency_bound_ms, host_ms], ...], ns of one dependent
    step). host_ms: native.chain_dp on the same slabs and limits, one call
    a slab, median of 3."""
    import torch
    from pav_tpu_torch import native
    from pav_tpu_torch.ops import chain_scan as C
    step_ns, _ = chain_step_ns(dev)
    rows = []
    for (B, n), seed, args, note in ((CHAIN_SHAPE, 700, CHAIN_ARGS, ''),
                                     ((1, CHAIN_LONG), 701, CHAIN_ARGS, ''),
                                     (CHAIN_SHAPE, 700, CHAIN_ARGS_I2F, ', limits 2^31')):
        arrays = chain_inputs(B, n, seed)
        q, r, g = (torch.from_numpy(a).to(dev) for a in arrays)

        def scan():
            return C._chain_scan_batch(q, r, g, *args)
        reps = 10 if n <= CHAIN_SHAPE[1] else 3
        ms, how = device_ms(scan, reps, NEEDLES['chain_scan'])
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            for b in range(B):
                native.chain_dp(arrays[0][b], arrays[1][b], arrays[2][b], args[1], args[0],
                                *args[2:])
            host.append(1e3 * (time.perf_counter() - t0))
        dep = None if step_ns is None else 1e-6 * step_ns * n
        rows.append([f'{B} x {n}{note}', B, n, ms, how, chain_bound(B, n)[0], dep,
                     float(np.median(host))])
    return rows, step_ns


SEED_REF_LEN = 46_709_983      # GRCh38 chr21
SEED_KERNELS = ('sketch_kernel', 'scan_kernel', 'runs_kernel', 'probe_kernel', 'fill_kernel')


def _kernel_ms(fn):
    """{kernel group: device ms} of one call of ``fn`` from a CUDA-activity
    trace: the seeding kernels by name, every other kernel (the sorts and
    gathers) as ``torch``, and the copies as ``memcpy``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix='.json') as fh:
        prof.export_chrome_trace(fh.name)
        with open(fh.name) as trace:
            events = json.load(trace).get('traceEvents', [])
    out = {}
    for ev in events:
        name = ev.get('name', '')
        if ev.get('cat') == 'kernel':
            group = next((k for k in SEED_KERNELS if k in name), 'torch')
        elif ev.get('cat') == 'gpu_memcpy':
            group = 'memcpy'
        else:
            continue
        out[group] = out.get(group, 0.0) + ev['dur'] / 1e3
    return out


def seed_index_tables(index):
    """A DeviceMinimizerIndex's tables on the host, named and typed as
    MinimizerIndex holds them."""
    from pav_tpu_torch.ops import seed
    starts = index.uniq_starts.cpu().numpy()
    uniq = seed.to_hash(index.uniq_keys.cpu().numpy())
    return {'hashes': np.repeat(uniq, np.diff(starts)),
            'chrom_ids': index.chrom_ids.cpu().numpy(),
            'positions': index.positions.cpu().numpy().astype(np.int64),
            'strands': index.strands.cpu().numpy(),
            'uniq_hashes': uniq, 'uniq_starts': starts[:-1], 'uniq_counts': np.diff(starts)}


def seed_times(card, dev):
    """--seed-times, and phase 3's seeding part: the reference index and one
    contig's sorted anchors at chr21's length (uniform bases, seed 21; the
    contig 1-31 Mbp forward, then 31-46 Mbp reverse-complemented, an SNV
    every kilobase), on the host (MinimizerIndex and its sorted_anchors)
    and on the card (DeviceMinimizerIndex and its sorted_anchors). Fails
    unless the device index's tables equal the host's, the device anchors
    the host's, and each wrapper on the card (``seed.sketch``, ``seed.runs``,
    ``seed.anchors``) its plain version on the same CUDA inputs, all bit
    for bit. Returns, and prints as one JSON line, the wall of each path
    (the card's warm, median of 3), the plain versions' ms, the device ms by
    kernel of one traced call, the bytes each seeding kernel must move and
    its bound at HBM_BYTES_S, and the run pass against
    ``torch.unique_consecutive`` on the same sorted keys (median of 5)."""
    import torch
    from pav_tpu_torch import seqcodec
    from pav_tpu_torch.align.aligner.index import (DeviceMinimizerIndex, MinimizerIndex,
                                                   minimizers)
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.ops import seed
    rng = np.random.default_rng(21)
    chrom = rng.integers(0, 4, SEED_REF_LEN).astype(np.uint8)
    contig = np.concatenate([chrom[1_000_000:31_000_000],
                             seqcodec.revcomp(chrom[31_000_000:46_000_000])])
    contig[::1000] = (contig[::1000] + 1) % 4
    ref = SeqStore({'chr21': chrom})

    def walls(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return res, out

    host, host_index_s = walls(lambda: MinimizerIndex(ref, 19, 10), 1)
    want, host_anchor_s = walls(lambda: host.sorted_anchors(contig, 64), 1)
    DeviceMinimizerIndex(ref, 19, 10, device=dev)           # warm-up
    index, dev_index_s = walls(lambda: DeviceMinimizerIndex(ref, 19, 10, device=dev), 3)
    for name, got in seed_index_tables(index).items():
        if not (got.dtype == getattr(host, name).dtype
                and np.array_equal(got, getattr(host, name))):
            fail(f'seed times: the device index\'s {name} differ from MinimizerIndex\'s')
    if (index.max_pos, index.n_minimizers()) != (host.max_pos, host.n_minimizers()):
        fail('seed times: the device index\'s max_pos or size differ from MinimizerIndex\'s')
    got, dev_anchor_s = walls(lambda: index.sorted_anchors(contig, 64), 3)
    if not all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)):
        fail('seed times: device anchors differ from the host path')

    # Each wrapper against its plain version, on the same CUDA inputs.
    codes = torch.from_numpy(chrom).to(dev)
    sk = seed.sketch(codes, 19, 10)
    sk_ref, sketch_pms = timed_ms(lambda: seed._sketch_ref(codes, 19, 10))
    keys = torch.sort(sk[1], stable=True)[0]
    rn = seed.runs(keys)
    rn_ref, runs_pms = timed_ms(lambda: seed._runs_ref(keys))
    qpos, qkey, qstrand = seed.sketch(torch.from_numpy(contig).to(dev), 19, 10)
    an = seed.anchors(qpos, qkey, qstrand, len(contig), 19, 64, index.table())
    an_ref, anchors_pms = timed_ms(lambda: seed._anchors_ref(qpos, qkey, qstrand, len(contig),
                                                             19, 64, index.table()))
    for name, g, w in (('sketch', sk, sk_ref), ('runs', rn, rn_ref), ('anchors', an, an_ref)):
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            fail(f'seed times: seed.{name} on the card differs from its plain version')
    del sk_ref, rn_ref, an_ref

    def unique_runs():
        uniq, counts = torch.unique_consecutive(keys, return_counts=True)
        return uniq, torch.cumsum(counts, 0)
    uniq, ends = unique_runs()
    if not (torch.equal(uniq, rn[0]) and torch.equal(ends, rn[1][1:])):
        fail('seed times: torch.unique_consecutive gives other runs')
    runs_call_ms = median_ms(lambda: seed.runs(keys), 5)
    unique_call_ms = median_ms(unique_runs, 5)
    del codes, sk, keys, rn, an, uniq, ends

    k_index = _kernel_ms(lambda: DeviceMinimizerIndex(ref, 19, 10, device=dev))
    k_anchor = _kernel_ms(lambda: index.sorted_anchors(contig, 64))
    m, u, a = index.n_minimizers(), index.uniq_keys.numel(), len(want[0])
    qhash = minimizers(contig, 19, 10)[1]
    qm, found = len(qhash), int(np.isin(qhash, host.uniq_hashes).sum())
    # Bytes each kernel must move (inputs read once, outputs written once):
    # the sketch the bases and 13 bytes a minimizer; the runs the sorted keys
    # and 16 bytes a run; the probe the query keys and 12 bytes a query
    # (count, start) plus the runs it lands on; the fill the probe's output,
    # the query positions and strands, 9 table bytes and 12 written an anchor.
    nbytes = {'sketch (index)': SEED_REF_LEN + 13 * m,
              'runs': 8 * m + 16 * u,
              'sketch (contig)': len(contig) + 13 * qm,
              'probe': 20 * qm + 16 * found,
              'fill': 17 * qm + 21 * a}
    out = {
        'root': ROOT, 'card': card, 'ref_bases': SEED_REF_LEN, 'contig_bases': len(contig),
        'minimizers': m, 'runs': u, 'contig_minimizers': qm, 'anchors': a,
        'checked': 'tables, anchors, sketch, runs and anchors against their plain versions',
        'host_s': {'index': host_index_s, 'anchors': host_anchor_s},
        'card_s': {'index': dev_index_s, 'anchors': dev_anchor_s},
        'plain_ms': {'sketch': sketch_pms, 'runs': runs_pms, 'anchors': anchors_pms},
        'runs_call_ms': {'seed.runs': runs_call_ms, 'unique_consecutive': unique_call_ms},
        'kernel_ms': {'index': k_index, 'anchors': k_anchor},
        'bytes': nbytes,
        'bound_ms': {k: 1e3 * v / HBM_BYTES_S for k, v in nbytes.items()}}
    print(json.dumps(out), flush=True)
    return out


def phase_seed(card, dev, stats):
    """Phase 3's seeding part: seed_times (which fails on any difference),
    its times into ``stats`` for the kernels line (the sketch at the
    index's shape, the probe and fill at the contig's)."""
    st = seed_times(card, dev)
    for name, trace, kernel, key, plain in (
            ('seed_sketch', 'index', 'sketch_kernel', 'sketch (index)', 'sketch'),
            ('seed_runs', 'index', 'runs_kernel', 'runs', 'runs'),
            ('seed_probe', 'anchors', 'probe_kernel', 'probe', 'anchors'),
            ('seed_fill', 'anchors', 'fill_kernel', 'fill', 'anchors')):
        stats[name].update(err=0, ms=st['kernel_ms'][trace].get(kernel), ms_by='trace',
                           plain_ms=st['plain_ms'][plain], bound_ms=st['bound_ms'][key],
                           bound_by='bytes')
        log(f'kernel {name}: bit-identical at chr21\'s length; {stats[name]["ms"]} ms device '
            f'(trace), bound {st["bound_ms"][key]:.4f} ms (bytes)')


def main():
    import argparse
    if sys.argv[1:2] == ['--cli-child']:
        return cli_child(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kernel-times', action='store_true',
                    help="only time this checkout's DP kernels and walker at phase 3's shapes")
    ap.add_argument('--dp-full-times', action='store_true',
                    help="only time this checkout's full-width DP kernel at FULL_SHAPES")
    ap.add_argument('--seed-times', action='store_true',
                    help="only time this checkout's minimizer seeding at chr21's length")
    ap.add_argument('--chrom', action='store_true',
                    help='run phases 1, 2 and 11 only (the chromosome-scale sample)')
    ap.add_argument('--wide', action='store_true',
                    help='run phases 1, 2 and 13 only (the kilobase-SV samples)')
    ap.add_argument('--asm', action='store_true',
                    help='run phases 1, 2 and 14 only (the assembly-shaped samples)')
    args = ap.parse_args()
    if not os.path.isfile(os.path.join(ROOT, 'pav_tpu_torch', 'ops', 'dp_kernels.py')):
        fail(f'no pav_tpu_torch package beside {__file__}: run from a checkout of the repo')
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs one CUDA GPU')
    sys.path.insert(0, ROOT)

    # 1. environment
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device(DEVICE, 0) if DEVICE == 'cuda' else torch.device(DEVICE)
    if args.kernel_times or args.dp_full_times:
        return kernel_times(card, dev, dp_full_only=not args.kernel_times)
    if args.seed_times:
        seed_times(card, dev)
        return 0
    log(card)
    import pandas
    log(f'torch {torch.__version__} (CUDA {torch.version.cuda}), numpy {np.__version__}, '
        f'pandas {pandas.__version__}, python {sys.version.split()[0]}')
    kind = torch.cuda.get_device_name(0)
    log(f'device: {kind} (count {torch.cuda.device_count()})')

    # 2. build
    from pav_tpu_torch import _build
    t0 = time.time()
    _build.lib()
    log(f'build: {time.time() - t0:.2f} s ({"cached" if _build.BUILD_INFO["cached"] else "nvcc"}) '
        f'{_build.BUILD_INFO["path"]}')
    for line in _build.BUILD_INFO['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')

    if args.chrom or args.wide or args.asm:
        with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
            if args.chrom:
                stamp('phase 11')
                phase_chrom(work, card, dev)
            if args.wide:
                stamp('phase 13')
                phase_wide(work, card, dev)
            if args.asm:
                stamp('phase 14')
                phase_asm(work, card, dev)
        stamp('done')
        return 0

    # 3. kernels against their plain versions; times from a fresh process
    stamp('phase 3')
    kt = fresh_kernel_times()
    stats = phase_kernels(dev, kt)
    phase_chain_scan(dev, stats, kt)
    phase_seed(card, dev, stats)
    phase_density(dev)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
        main_launches, genome = drive_main_path(work, card, dev)
        for key, count in drive_scale_out(work, card, dev, genome).items():
            main_launches[key] += count
        del genome
        stamp('phase 10')
        main_launches['band'] = phase_entry(card, dev)['band']
        stamp('phase 11')
        for key, count in phase_chrom(work, card, dev).items():
            main_launches[key] += count
    stamp('phase 13')
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
        for key, count in phase_wide(work, card, dev).items():
            main_launches[key] += count
    stamp('phase 14')
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
        for key, count in phase_asm(work, card, dev).items():
            main_launches[key] += count
    stamp('done')

    if 'jax' in sys.modules:
        fail('jax was imported')
    kernels = [{'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
                'launches': main_launches[key], 'max_abs_err': stats[name]['err'],
                'ms': stats[name]['ms'], 'ms_by': stats[name]['ms_by'],
                'plain_ms': stats[name]['plain_ms'],
                'bound_ms': stats[name]['bound_ms'], 'bound_by': stats[name]['bound_by'],
                'library_ms': stats[name]['library_ms'],
                **({'dependency_bound_ms': stats[name]['dependency_bound_ms']}
                   if 'dependency_bound_ms' in stats[name] else {})}
               for name, (src, rep, key) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


def trace_kernel_ms(path):
    """{kernel name: (device ms, launches)} summed from a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh).get('traceEvents', [])
    out = {}
    for ev in events:
        if ev.get('cat') == 'kernel' and 'dur' in ev:
            ms, count = out.get(ev['name'], (0.0, 0))
            out[ev['name']] = (ms + ev['dur'] / 1e3, count + 1)
    return out


def trace_launch_shapes(path, needle):
    """{(kernel, grid, block): (device ms, launches)} of the kernels whose
    name holds ``needle``, from a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh).get('traceEvents', [])
    out = {}
    for ev in events:
        if ev.get('cat') == 'kernel' and needle in ev.get('name', ''):
            args = ev.get('args', {})
            kname = ev['name'].replace('(anonymous namespace)::', '').split('(')[0]
            key = (kname.removeprefix('void ').strip(),
                   tuple(args.get('grid', ())), tuple(args.get('block', ())))
            ms, count = out.get(key, (0.0, 0))
            out[key] = (ms + ev['dur'] / 1e3, count + 1)
    return out


def dp_classes(label, classes, dev, events=False):
    """A sample's DP classes (affine_dp.STATS['classes']): launches, items,
    padded cells and path lengths; each class's DP kernel timed alone at its
    shape (its work does not depend on the data) times its resolved
    launches, and the walker on that launch's tape (random inputs: its steps
    depend on the data) the same way: device time from a profiler trace, or
    with ``events`` CUDA events around the wrapper (no profiler); and the
    run's bounds: dp_full and dp_wave over their padded cells, the walker
    over the run's path steps, and where a launch has fewer items than the
    card has SMs, the one-item-per-SM bound (item_bound): a launch's padded
    item for the DP, each class's longest path for the walker. Returns one
    dict a class: kind, max_m, max_n, width, b_pad, launches, ms and walk_ms
    (ms a launch)."""
    import torch
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K

    def timed(fn, reps, needle):
        return median_ms(fn, reps) if events else device_ms(fn, reps, needle)[0]
    rows = []
    for (mm, nn, width, b_pad), (launches, _, items, cells, real, steps, longest) \
            in classes.items():
        q, r, m, n = (torch.from_numpy(a).to(dev) for a in dp_inputs(b_pad, mm, nn, 300))
        if width == nn + 1:
            kind, ww = 'full', width
            ms = timed(lambda: K.align_full(q, r, m, n, SCORING),
                       5 if mm * nn >= 1 << 22 else 20, NEEDLES['dp_full'])
            tb, offs = K.align_full(q, r, m, n, SCORING)
            bms = full_bound(b_pad, mm, nn)[0]
            ibm = item_bound(mm * (nn + 1), OPS_FULL_CELL)
        else:
            kind, ww = 'wave', affine_dp._wave_width(width)
            offs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)
            ms = timed(lambda: K.align_wave(q, r, m, n, offs, ww, SCORING), 3,
                       NEEDLES['dp_wave'])
            tb = K.align_wave(q, r, m, n, offs, ww, SCORING)
            bms = wave_bound(b_pad, mm, nn, ww)[0]
            ibm = item_bound((mm + nn) * ww, OPS_WAVE_CELL)
        walk_ms = timed(lambda: K.traceback(tb, offs, q, r, m, n, kind == 'wave'), 5,
                        NEEDLES['traceback'])
        del tb, offs
        rows.append((kind, b_pad, mm, nn, width, ww, launches, items, cells, real, steps,
                     longest, ms, bms, ibm if b_pad < 132 else None, walk_ms))
    rows.sort(key=lambda x: -x[6] * x[12])
    totals = {}
    for kind, b_pad, mm, nn, width, ww, launches, items, cells, real, steps, longest, ms, \
            bms, ibm, walk_ms in rows:
        totals[kind] = totals.get(kind, 0.0) + launches * ms
        totals['walk'] = totals.get('walk', 0.0) + launches * walk_ms
        extra = '' if ibm is None else f'; one-item-per-SM bound {ibm:.4f} ms a launch'
        log(f'{label} class {kind} B={b_pad} {mm}x{width} ({ww} lanes): {launches} launches, '
            f'{items} items, {cells} padded cells ({real} real), path steps {steps} '
            f'(longest {longest}); {ms:.4f} ms per launch, {launches * ms:.4f} ms in all{extra}; '
            f'walker {walk_ms:.4f} ms per launch (random inputs), {launches * walk_ms:.4f} ms '
            f'in all')
    for kind in ('full', 'wave'):
        mine = [x for x in rows if x[0] == kind]
        if not mine:
            continue
        bms = sum(x[6] * x[13] for x in mine)
        cells = sum(x[8] for x in mine)
        few = [x for x in mine if x[14] is not None]
        extra = '' if not few else (
            f'; one-item-per-SM bound of its {sum(x[6] for x in few)} launches of fewer than '
            f'132 items {sum(x[6] * x[14] for x in few):.4f} ms')
        log(f'{label} dp_{kind}: {totals[kind]:.4f} ms from the class table; bound '
            f'{bms:.4f} ms over {cells} padded cells (operations){extra}')
    steps = sum(x[10] for x in rows)
    items = sum(x[6] * x[1] for x in rows)
    out_bytes = sum(x[6] * x[1] * (K.trace_len(x[2], x[3]) // 4 + 5) for x in rows)
    bms, by = walk_bound(steps, items, out_bytes)
    ibm = sum(item_bound(x[11], OPS_TRACE_STEP) for x in rows)
    log(f'{label} traceback: {totals["walk"]:.4f} ms from the class table; bound: {steps} path '
        f'steps (longest {max(x[11] for x in rows)}) in '
        f'{sum(x[6] for x in rows)} launches, {out_bytes} output bytes: {bms:.4f} ms ({by}); '
        f'one-item-per-SM bound {ibm:.4f} ms (each class\'s longest path, walked on one SM)')
    return [dict(kind=x[0], b_pad=x[1], max_m=x[2], max_n=x[3], width=x[4], launches=x[6],
                 ms=x[12], walk_ms=x[15]) for x in rows]


def traced_run(work, name, ref, haps, want, wall_note):
    """Run a sample again under a CUDA-activity trace: its VCF records must
    equal ``want``; logs the device time by kernel and by launch grid of the
    walker and the DP kernels. Returns the traced run's launches."""
    import torch
    from pav_tpu_torch.ops import chain_scan, dp_kernels
    launches_reset()
    trace = os.path.join(work, f'{name}_trace.json')
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_dir_t, wall_t = run_sample(work, f'{name}t', ref, haps, DEVICE)
    launches = launches_read()
    prof.export_chrome_trace(trace)
    if vcf_records(os.path.join(run_dir_t, f'{name}t.vcf.gz')) != want:
        fail(f'the traced {name} run wrote other VCF records than the untraced one')
    log(f'{name} again under a CUDA-activity trace: wall {wall_t:.2f} s ({wall_note}); '
        f'launches {launches}; VCF records equal')
    by_kernel = trace_kernel_ms(trace)
    busy = sum(ms for ms, _ in by_kernel.values())
    log(f'{name} device time by kernel ({busy:.3f} ms busy over {1e3 * wall_t:.0f} ms traced '
        f'wall, {100 * busy / (1e3 * wall_t):.3f}%): ' + json.dumps(
            {k: [round(v[0], 4), v[1]] for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][0])[:25]}))
    for kname, needle in (*NEEDLES.items(), ('density (cuFFT)', 'fft')):
        hits = [v for k, v in by_kernel.items() if needle in k]
        log(f'{name} {kname}: {sum(c for _, c in hits)} device launches, '
            f'{sum(ms for ms, _ in hits):.4f} ms device time (trace)')
    for needle in ('dp_full', 'dp_wave', 'traceback'):
        for (kname, grid, block), (ms, count) in sorted(
                trace_launch_shapes(trace, needle).items(), key=lambda kv: -kv[1][0]):
            log(f'{name} trace {kname} grid {list(grid)} block {list(block)}: '
                f'{count} launches, {ms:.4f} ms')
    return launches


def measured_run(work, name, ref, haps, card):
    """One CLI run of a sample on DEVICE without a profiler (phases 4 and
    13b): its wall and contig Mbp/s, launches (read from 0 just before the
    run to just after it), stage seconds, ALIGN_STATS_BY_HAP, torch's peak
    device memory and nvidia-smi samples beside it; the full-width,
    traceback and seeding kernels must run (require_main_path), and the text
    codec read and wrote every file natively (require_native_text), and the
    aligner planned and emitted natively (require_native_aligner). Returns
    (run dir, VCF records, launches, DP class table)."""
    import torch
    from pav_tpu_torch.align.aligner import core
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = smi_memory_used()
    launches_reset()
    affine_dp.stats_reset()
    core.align_stats_reset()
    with gpu_samples(os.path.join(work, f'{name}_smi.csv')) as smi:
        run_dir, wall = run_sample(work, name, ref, haps, DEVICE)
    launches = launches_read()
    # A copy of the counters: a later traced run adds to the same lists.
    classes = {k: tuple(v) for k, v in affine_dp.STATS['classes'].items()}
    recs = vcf_records(os.path.join(run_dir, f'{name}.vcf.gz'))
    rate = sum(len(codes) for _, codes in haps.values()) / 1e6 / wall
    log(f'{name}, {len(ref) / 1e6:g} Mbp diploid: {len(recs)} VCF records, wall {wall:.2f} s '
        f'(no profiler), {rate:.3f} contig Mbp/s on {card}; launches {launches}; resident '
        f'gather windows by flag 0-3 {affine_dp.STATS["gather_flags"]}')
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, name)))
    log_align_stats(core.ALIGN_STATS_BY_HAP)
    log(f'{name} device memory: torch max_memory_allocated '
        f'{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, max_memory_reserved '
        f'{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB; {smi_note(smi, before)}; on {card}')
    if not recs:
        fail(f'the {name} VCF has no records')
    require_main_path(name, launches)
    require_native_text(run_dir, name)
    require_native_aligner(run_dir, name)
    return run_dir, recs, launches, classes


def drive_main_path(work, card, dev):
    """Phases 4-6; returns the kernel launches of phases 4 and 5 (each read
    from 0 just before its run to just after it) and phase 4's genome (ref,
    h1, h2)."""
    from pav_tpu_torch import synth
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels

    # 4. main path, 16 Mbp diploid
    stamp('phase 4')
    t0 = time.time()
    ref, h1, h2, t1, t2 = synth.bench_genome(BENCH_REF_LEN, 11)
    genome = (ref, h1, h2)
    log(f'genome: {len(ref) / 1e6:g} Mbp reference, haps {len(h1)} + {len(h2)} bp '
        f'({time.time() - t0:.1f} s)')
    haps = {'h1': ('tig_h1', h1), 'h2': ('tig_h2', h2)}
    run_dir, recs, main_launches, classes = measured_run(work, 'bench16', ref, haps, card)
    synth.hold_to_truth('bench16 VCF', os.path.join(run_dir, 'bench16.vcf.gz'), t1 + t2)

    # The same sample again under a CUDA-activity trace: device time by kernel.
    traced_run(work, 'bench16', ref, haps, recs, 'a second run')

    # 5. repeat-rich sample: the wavefront band kernel
    stamp('phase 5')
    rref, rhap = synth.repeat_genome(REPEAT_REF_LEN, 18)
    rhaps = {'h1': ('rtig1', rhap)}
    launches_reset()
    affine_dp.stats_reset()
    run_dir, wall = run_sample(work, 'rep2', rref, rhaps, DEVICE)
    rep_launches = launches_read()
    rep_classes = {k: tuple(v) for k, v in affine_dp.STATS['classes'].items()}
    for k in main_launches:
        main_launches[k] += rep_launches[k]
    rep_recs = vcf_records(os.path.join(run_dir, 'rep2.vcf.gz'))
    log(f'repeat-rich {len(rref) / 1e6:g} Mbp: {len(rep_recs)} VCF records, wall {wall:.2f} s '
        f'(no profiler), {len(rhap) / 1e6 / wall:.3f} contig Mbp/s on {card}; launches '
        f'{rep_launches}')
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, 'rep2')))
    if rep_launches['wave'] <= 0:
        fail(f'the repeat-rich sample did not launch the wave kernel: {rep_launches}')
    traced_run(work, 'rep2', rref, rhaps, rep_recs, 'a second run')
    dp_classes('bench16', classes, dev)
    dp_classes('rep2', rep_classes, dev)

    # 6. cuda vs cpu on the e2e genome, the CPU on the CUDA path's classes
    # (ladder='accel', the plain kernel versions; the CLI's --device cpu
    # takes the CPU ladder, which tier-1 holds against pav_tpu).
    stamp('phase 6')
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline
    ref, h1, h2 = synth.e2e_genome()
    haps = {'h1': ('tig1_1', h1), 'h2': ('tig2_1', h2)}
    run_gpu, _ = run_sample(work, 'samp1', ref, haps, DEVICE,
                            ('--set', 'aligner_min_chain_score=500'))
    cpu = Pipeline(SeqStore({'chr1': ref}), {'aligner_min_chain_score': 500},
                   run_dir=os.path.join(work, 'samp1', 'run_cpu_accel'), device='cpu',
                   ladder='accel').run_sample('samp1', {h: SeqStore(dict([tig]))
                                                        for h, tig in haps.items()})
    gpu_recs = vcf_records(os.path.join(run_gpu, 'samp1.vcf.gz'))
    cpu_recs = vcf_records(cpu['vcf'])
    if not gpu_recs or gpu_recs != cpu_recs:
        fail(f'cuda and cpu (ladder=accel) VCFs differ ({len(gpu_recs)} vs '
             f'{len(cpu_recs)} records)')
    log(f'parity: cuda and cpu (ladder=accel) VCFs of the e2e genome identical '
        f'({len(gpu_recs)} records)')
    return main_launches, genome


def drive_scale_out(work, card, dev, genome):
    """Phases 7-9 on phase 4's genome; returns the chain scan launches of
    phase 8."""
    import torch
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.align.aligner import Aligner
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels

    # 7. mesh: the DP of one haplotype split over [cuda:0, cuda:0]
    stamp('phase 7')
    ref, h1, _ = genome
    ref_store = SeqStore({'chr1': ref})
    qry = SeqStore({'tig_h1': h1})
    al = Aligner(ref_store, {}, device=dev)
    t0 = time.time()
    plain = al.align_store(qry, 'h1')
    wall_plain = time.time() - t0
    unsharded_dp = al.dp
    al.dp = affine_dp.BandedAligner(al.dp.scoring, device=dev, mesh=[dev, dev])
    affine_dp.stats_reset()
    dp_kernels.launches_reset()
    t0 = time.time()
    sharded = al.align_store(qry, 'h1')
    wall_mesh = time.time() - t0
    mesh_launches = dict(dp_kernels.LAUNCHES)
    st = dict(affine_dp.STATS)
    al.dp = unsharded_dp
    if not sharded.equals(plain):
        fail('mesh: the sharded alignment table differs from the unsharded one')
    rows, cells = st['shard_rows'], st['shard_cells']
    if st['sharded_puts'] <= 0 or len(rows) != 2 or max(rows) - min(rows) > 1:
        fail(f'mesh: DP launches were not split evenly: {st["sharded_puts"]} puts, rows {rows}')
    if mesh_launches['full'] <= 0 or mesh_launches['traceback'] <= 0:
        fail(f'mesh: the sharded DP launched no kernel: {mesh_launches}')
    log(f'mesh [cuda:0, cuda:0]: {plain.shape[0]} alignment records, tables equal; '
        f'{st["sharded_puts"]} sharded puts, shard_rows {rows}, shard_cells {cells} '
        f'(max/min {max(cells) / min(cells):.4f}); align_store wall {wall_plain:.2f} s '
        f'unsharded, {wall_mesh:.2f} s sharded; launches {mesh_launches} on {card}')

    # 8. chain fallback: no native chain kernel, so the scan runs on the card
    stamp('phase 8')
    from pav_tpu_torch import native
    orig = native.chain_dp
    native.chain_dp = lambda *a, **k: None
    chain_scan.launches_reset()
    try:
        t0 = time.time()
        fallback = al.align_store(qry, 'h1')
        wall_fb = time.time() - t0
    finally:
        native.chain_dp = orig
    launches = {'chain_scan': chain_scan.LAUNCHES['chain_scan']}
    pieces = dict(chain_scan.PIECES)
    if launches['chain_scan'] <= 0:
        fail('chain fallback: the chain scan kernel was not launched')
    if not fallback.equals(plain):
        fail('chain fallback: the alignment table differs from the native run')
    log(f'chain fallback: tables equal; {launches["chain_scan"]} chain_scan launches for '
        f'{pieces["calls"]} chain_scores calls, {pieces["pieces"]} pieces in '
        f'{pieces["rows"]} rows; align_store wall {wall_fb:.2f} s (native chaining '
        f'{wall_plain:.2f} s) on {card}')
    torch.cuda.synchronize()

    # 9. cohort
    stamp('phase 9')
    phase_cohort(work, card, genome)
    return launches


def phase_entry(card, dev):
    """10. The entry points on the card: entry()'s fn against the plain
    version (bit for bit), then dryrun_multichip(2) over the mesh [cuda:0,
    cuda:0] against the same dry run on the CPU. Returns the launches of
    the two card runs (read from 0 just before to just after them)."""
    import torch
    from pav_tpu_torch import entry
    from pav_tpu_torch.ops import chain_scan, dp_kernels as K
    from pav_tpu_torch.ops import kde
    launches_reset()
    t0 = time.time()
    fn, args = entry.entry(device=dev)
    got = fn(*args)
    torch.cuda.synchronize()
    dry = entry.dryrun_multichip(2, mesh=[dev, dev])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launches_read()
    for key in ('band', 'full', 'traceback', 'chain_scan'):
        if launches[key] <= 0:
            fail(f'entry points: no {key} launch on the card: {launches}')
    if any(a.device.type != 'cuda' for a in args):
        fail('entry(): the example arrays are not on the card')
    want = K.align_band_ref(*(a.cpu() for a in args), 65, entry.SCORING, with_score=True)
    for name, g, w in zip(('score', 'tape', 'offsets'), got, want):
        if not torch.equal(g.cpu(), w):
            fail(f'entry(): the {name} on the card differs from align_band_ref')
    cpu = entry.dryrun_multichip(2, device='cpu')
    for (gl, go), (wl, wo) in zip(dry['cigars'], cpu['cigars']):
        if not (np.array_equal(gl, wl) and np.array_equal(go, wo)):
            fail('dryrun_multichip: the sharded aligner\'s CIGARs differ from the CPU run')
    for name in ('score', 'tb', 'offs'):
        if not torch.equal(dry[name], cpu[name]):
            fail(f'dryrun_multichip: the device step\'s {name} differs from the CPU run')
    d_dev, d_cpu = dry['dens'].numpy(), cpu['dens'].numpy()
    if not np.all(np.abs(d_dev - d_cpu) <= 1e-3 * np.abs(d_cpu) + 1e-5 * np.abs(d_cpu).max()):
        fail('dryrun_multichip: the density convolution outside the float32 tolerance')
    if abs(dry['total'] - cpu['total']) > 1e-5 * abs(cpu['total']):
        fail(f'dryrun_multichip: total {dry["total"]} against {cpu["total"]} on the CPU')
    chains = [dry['chain']] + dry['chain_batch']
    for (gf, gp), (wf, wp) in zip(chains, [cpu['chain']] + cpu['chain_batch']):
        if not (np.array_equal(gf, wf) and np.array_equal(gp, wp)):
            fail('dryrun_multichip: the chain scores differ from the CPU run')
    regions = dry['regions']
    sigmas = [kde.scott_sigmas(x, 0.25) for x in regions]
    undecided, _ = check_states('dryrun_multichip', regions, sigmas, dry['states'],
                                cpu['states'], dev)
    for key in (('svindel_ins', 'pass'), ('svindel_del', 'pass'), ('snv_snv', 'pass')):
        if list(dry['merged_mesh'][key]['ID']) != list(cpu['merged_mesh'][key]['ID']):
            fail(f'dryrun_multichip: the sharded pipeline\'s {key} calls differ from the CPU run')
    log(f'entry points: entry() on the card bit-identical to align_band_ref (score, tape, '
        f'offsets); dryrun_multichip(2) over [cuda:0, cuda:0] equal to the CPU dry run '
        f'(CIGARs, DP, chains exact; density within float32, {undecided} undecided states; '
        f'pipeline calls equal), total {dry["total"]:.4f}; {wall:.2f} s for both card runs; '
        f'launches {launches} on {card}')
    # The run's dp_band classes: entry()'s one launch, and the dry run's
    # device step in one launch a mesh device (rows split evenly, max_n =
    # max_m there).
    B, mm, width = dry['tb'].shape
    classes = [(args[0].shape[0], args[0].shape[1], args[1].shape[1], got[1].shape[2]),
               (B // 2, mm, mm, width), (B // 2, mm, mm, width)]
    if launches['band'] != len(classes):
        fail(f'entry points: {launches["band"]} dp_band launches, expected {classes}')
    bms = sum(band_bound(*c)[0] for c in classes)
    ibm = sum(item_bound(c[1] * c[3], OPS_BAND_CELL) for c in classes)
    log(f'entry points dp_band per-run bound: {bms:.6f} ms over {len(classes)} launches '
        f'{classes} (operations); one-item-per-SM bound {ibm:.5f} ms')
    # The two card runs again under a CUDA-activity trace, for dp_band's
    # device time (the launches above are the untraced runs').
    with tempfile.TemporaryDirectory(prefix='pav_entry_trace_') as tdir:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(*args)
            entry.dryrun_multichip(2, mesh=[dev, dev])
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(tdir, 'trace.json'))
        shapes = trace_launch_shapes(os.path.join(tdir, 'trace.json'), NEEDLES['dp_band'])
    for (kname, grid, block), (ms, count) in sorted(shapes.items()):
        log(f'entry points trace {kname} grid {list(grid)} block {list(block)}: {count} '
            f'launches, {ms:.4f} ms')
    log(f'entry points dp_band under a CUDA-activity trace: '
        f'{sum(c for _, c in shapes.values())} device launches, '
        f'{sum(ms for ms, _ in shapes.values()):.4f} ms device time (bound {bms:.6f} ms)')
    return launches


def phase_chrom(work, card, dev):
    """11. bench.py's chromosome-scale sample (CHROM_REF_LEN, CHROM_SEED)
    from FASTA through the port's CLI on the card, in a child process
    (run_cli_child), twice: the first run warms up and times each walker
    launch on the run's own tapes (--time-walks), the second is measured
    without a profiler or that instrumentation (wall, stage seconds,
    launches, DP class table, density paths, the child's peak RSS,
    nvidia-smi samples beside it). Both runs write equal VCF records, so
    the warm-up's tapes are the measured run's; the measured run's VCF is
    held to planted truth. Returns the measured run's launches."""
    import torch
    from pav_tpu_torch import synth
    d = os.path.join(work, 'chrom')
    t0 = time.time()
    ref, h1, h2, t1, t2 = synth.bench_genome(CHROM_REF_LEN, CHROM_SEED)
    t_gen = time.time() - t0
    t0 = time.time()
    name = f'chrom{CHROM_REF_LEN // 1_000_000}'
    inputs = write_sample(d, name, {'chr1': ref}, {'h1': {'tig_h1': h1}, 'h2': {'tig_h2': h2}})
    mbp = (len(h1) + len(h2)) / 1e6
    log(f'{name}: {len(ref) / 1e6:g} Mbp reference (seed {CHROM_SEED}), haps {len(h1)} + '
        f'{len(h2)} bp = {mbp:.3f} contig Mbp, {len(t1)} + {len(t2)} planted events; generated '
        f'in {t_gen:.1f} s, FASTAs written in {time.time() - t0:.1f} s (outside the walls)')
    del ref, h1, h2

    def argv(run_dir):
        return [*inputs, '--run-dir', os.path.join(d, run_dir), '--device', DEVICE]
    torch.cuda.empty_cache()
    warm, warm_wall, warm_rss = run_cli_child(d, argv('run_warm'), f'{name}_warm', 900,
                                              time_walks=True)
    log(f'{name} warm-up run (walker launches timed): CLI wall {warm["wall"]:.2f} s '
        f'({warm_wall:.2f} s with the process start), peak RSS {warm_rss / 2**30:.2f} GiB')
    before = smi_memory_used()
    with gpu_samples(os.path.join(d, 'smi.csv')) as smi:
        st, proc_wall, rss = run_cli_child(d, argv('run'), name, 900)
    vcf = os.path.join(d, 'run', f'{name}.vcf.gz')
    recs = vcf_records(vcf)
    if not recs:
        fail(f'the {name} VCF has no records')
    if recs != vcf_records(os.path.join(d, 'run_warm', f'{name}.vcf.gz')):
        fail(f'the two {name} runs wrote other VCF records')
    launches = st['launches']
    log(f'{name} diploid: {len(recs)} VCF records, equal in both runs; wall {st["wall"]:.2f} s '
        f'(the CLI\'s main, no profiler; {proc_wall:.2f} s with the process start), '
        f'{mbp / st["wall"]:.3f} contig Mbp/s on {card}; launches {launches}; resident gather '
        f'windows by flag 0-3 {st["gather_flags"]}')
    require_main_path(name, launches)
    log('stage seconds: ' + json.dumps(stage_seconds(os.path.join(d, 'run'), name)))
    log_align_stats(st['align_stats_by_hap'])
    log(f'{name} density paths (calls, largest grid): {st["density"]}')
    wide = sorted(k for k in st['classes'] if k[2] == k[1] + 1 and k[2] > 4097)
    log(f'{name} dp_wave launches: {launches["wave"]}; dp_full classes wider than 4097: '
        f'{[(k, st["classes"][k][0]) for k in wide] or "none"}')
    log(f'{name} CLI child: peak RSS {rss / 2**30:.2f} GiB (os.wait4 ru_maxrss); '
        f'{smi_note(smi, before)}; on {card}')
    if st['torch_memory'] is None:
        fail(f'{name}: the CLI child never initialised CUDA')
    log(f'{name} CLI child: torch max_memory_allocated {st["torch_memory"][0] / 2**20:.1f} MiB, '
        f'max_memory_reserved {st["torch_memory"][1] / 2**20:.1f} MiB (the whole CLI run)')
    walks, walks_dev = warm['walk_ms'], warm['walk_device_ms']
    if len(walks_dev) != warm['launches']['traceback'] or not walks_dev:
        fail(f'{name}: {len(walks_dev)} timed walker calls for '
             f'{warm["launches"]["traceback"]} launches in the warm-up run')
    log(f'{name} walker on the run\'s own tapes (the warm-up run\'s, whose records equal the '
        f'measured run\'s): {len(walks_dev)} launches, {sum(walks_dev):.4f} ms device time '
        f'(each launch\'s tape walked again after the run, profiler; longest '
        f'{max(walks_dev):.4f} ms); {sum(walks):.4f} ms between CUDA events around the '
        f'launches in the run (longest {max(walks):.4f} ms: the host\'s time between the start '
        f'event and the launch included); the class table below walks random tapes')
    dp_classes(name, st['classes'], dev, events=True)
    synth.hold_to_truth(f'{name} VCF', vcf, t1 + t2)
    return launches


def launched_widths(label, classes):
    """Fail unless the DP class table (affine_dp.STATS['classes'], keyed
    (max_m, max_n, width, B_pad)) launched a full-width class at each of
    synth.WIDE_WIDTHS; logs those classes."""
    from pav_tpu_torch import synth
    wide = {k: v[0] for k, v in classes.items() if k[2] == k[1] + 1 and k[2] > 4097}
    log(f'{label} dp_full classes wider than 4097 (max_m, max_n, width, B_pad: launches): '
        f'{sorted(wide.items())}')
    missing = [w for w in synth.WIDE_WIDTHS
               if not any(k[2] == w and n > 0 for k, n in wide.items())]
    if missing:
        fail(f'{label} launched no dp_full class of width {missing}: {sorted(classes)}')


def size_bin(label, vcf, truth):
    """Log the INS and DEL of >= synth.WIDE_MIN bp against planted truth
    beside their floors; fail where the bin misses them."""
    from pav_tpu_torch import synth
    rep, misses = synth.truth_report(vcf, truth, min_len=synth.WIDE_MIN)
    log(f'{label} SVs of >= {synth.WIDE_MIN} bp against planted truth (floors: recall 0.97, '
        f'precision 0.95):\n{rep.to_string()}')
    if misses:
        fail(f'{label} misses the floors in its >= {synth.WIDE_MIN} bp bin: {"; ".join(misses)}')


HOLD_WORKERS = 6   # hold_classes: processes for the plain versions


def _plain_class(arrays, offs, ww, wave, tb, out):
    """hold_classes' plain side, in a worker process on the CPU: the plain
    DP (align_full_ref, or align_wave_ref on the band offsets ``offs``) on
    ``arrays`` (q, r, m, n) and traceback_ref on its tape, against the
    card's tape ``tb`` and walk ``out`` (numpy copies). Returns (tape equal,
    walk equal, longest path, seconds)."""
    import torch
    from pav_tpu_torch.ops import dp_kernels as K
    torch.set_num_threads(1)
    t0 = time.time()
    q, r, m, n = (torch.from_numpy(a) for a in arrays)
    if wave:
        offs = torch.from_numpy(offs)
        tb_c = K.align_wave_ref(q, r, m, n, offs, ww, SCORING)
    else:
        tb_c, offs = K.align_full_ref(q, r, m, n, SCORING)
    out_c = K.traceback_ref(tb_c, offs, q, r, m, n, wave)
    return (torch.equal(torch.from_numpy(tb), tb_c), torch.equal(torch.from_numpy(out), out_c),
            int(path_lengths(out_c).max()), time.time() - t0)


def hold_classes(label, classes, dev):
    """Each DP class of a sample's table (affine_dp.STATS['classes'], keyed
    (max_m, max_n, width, B_pad)) at its own shape and batch: random inputs
    (dp_inputs) through the class's kernel on the card (align_full, or
    align_wave on the class's band geometry) and the walker on that tape,
    each against its plain version on CPU copies of the same inputs, bit
    for bit; the plain versions run in HOLD_WORKERS processes, one class a
    task. Fails on any difference."""
    import concurrent.futures
    import multiprocessing
    import torch
    from pav_tpu_torch.ops import affine_dp, dp_kernels as K
    t_all = time.time()
    pool = concurrent.futures.ProcessPoolExecutor(
        HOLD_WORKERS, mp_context=multiprocessing.get_context('spawn'))
    tasks = []
    with pool:
        for i, (mm, nn, width, b_pad) in enumerate(sorted(classes)):
            arrays = dp_inputs(b_pad, mm, nn, 1300 + i)
            q, r, m, n = (torch.from_numpy(a).to(dev) for a in arrays)
            wave = width != nn + 1
            if wave:
                ww = affine_dp._wave_width(width)
                offs = affine_dp._wave_geometry(m, n, mm, nn, mm + nn, ww)
                tb = K.align_wave(q, r, m, n, offs, ww, SCORING)
                what = (f'dp_wave B={b_pad} {mm}x{nn} width {width} ({ww} lanes, '
                        f'{mm + nn} diagonals)')
            else:
                ww = None
                tb, offs = K.align_full(q, r, m, n, SCORING)
                what = f'dp_full B={b_pad} {mm}x{width}'
            out = K.traceback(tb, offs, q, r, m, n, wave)
            tasks.append((what, pool.submit(_plain_class, arrays, offs.cpu().numpy(), ww, wave,
                                            tb.cpu().numpy(), out.cpu().numpy())))
            del tb, offs, out
        for what, task in tasks:
            tape_ok, walk_ok, longest, secs = task.result()
            if not tape_ok:
                fail(f'{label}: {what} differs from its plain version')
            if not walk_ok:
                fail(f'{label}: the walker differs from traceback_ref on the {what} tape')
            log(f'{label} class {what}: tape and walk bit-identical to the plain versions '
                f'(longest path {longest} steps; plain {secs:.1f} s in a worker)')
    log(f'{label}: {len(classes)} DP classes held to their plain versions at their own '
        f'shapes ({time.time() - t_all:.1f} s, {HOLD_WORKERS} worker processes)')


def phase_wide(work, card, dev):
    """13. Kilobase SVs, whose DP segments take dp_full's wide path. 13a:
    synth.WIDE_SMALL through the CLI on the card and through
    Pipeline(device='cpu', ladder='accel') (the plain versions on the CUDA
    path's classes): identical VCF records, both synth.WIDE_WIDTHS launched
    on the card. 13b: wide16 (synth.WIDE16) measured as phase 4 is; both
    widths and the walker must launch, its VCF records must equal pav_tpu's
    (synth.WIDE16_REFERENCE), meet RECALL_FLOORS and, in the >= 2 kb bin,
    the INS and DEL floors (13a's bin too); then again under a trace (equal
    records; dp_full by launch grid, the walker on the run's own tapes),
    its class table (dp_classes), and each of its classes held to the
    plain versions at its own shape (hold_classes). Returns the launches of
    the 13a and 13b card runs (each read from 0 just before to just after
    it)."""
    from pav_tpu_torch import synth
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels
    from pav_tpu_torch.pipeline import Pipeline

    ref, h1, h2, t1, t2 = synth.wide_genome(*synth.WIDE_SMALL)
    haps = {'h1': ('wtig1', h1), 'h2': ('wtig2', h2)}
    launches_reset()
    affine_dp.stats_reset()
    run_gpu, wall = run_sample(work, 'wide13a', ref, haps, DEVICE)
    launches = launches_read()
    launched_widths('wide13a', affine_dp.STATS['classes'])
    t0 = time.time()
    cpu = Pipeline(SeqStore({'chr1': ref}), {}, run_dir=os.path.join(work, 'wide13a', 'run_cpu'),
                   device='cpu', ladder='accel').run_sample(
        'wide13a', {h: SeqStore(dict([tig])) for h, tig in haps.items()})
    cpu_s = time.time() - t0
    vcf = os.path.join(run_gpu, 'wide13a.vcf.gz')
    gpu_recs = vcf_records(vcf)
    cpu_recs = vcf_records(cpu['vcf'])
    if not gpu_recs or gpu_recs != cpu_recs:
        fail(f'wide13a: cuda and cpu (ladder=accel) VCFs differ ({len(gpu_recs)} vs '
             f'{len(cpu_recs)} records)')
    log(f'wide13a ({synth.WIDE_SMALL[0] / 1e3:g} kb reference, seed {synth.WIDE_SMALL[1]}): '
        f'cuda and cpu (ladder=accel) VCFs identical ({len(gpu_recs)} records); CLI wall '
        f'{wall:.2f} s on {card}, the CPU run {cpu_s:.1f} s; launches {launches}')
    size_bin('wide13a', vcf, t1 + t2)

    t0 = time.time()
    ref, h1, h2, t1, t2 = synth.wide_genome(*synth.WIDE16)
    svs = [t['len'] for t in t1 + t2 if t['type'] in ('INS', 'DEL') and t['len'] >= 50]
    log(f'wide16: {len(ref) / 1e6:g} Mbp reference (seed {synth.WIDE16[1]}), haps {len(h1)} + '
        f'{len(h2)} bp, {len(svs)} SVs, {sum(x >= synth.WIDE_MIN for x in svs)} of 2-10 kb, '
        f'{sum(x > 8192 for x in svs)} above 8192 bp ({time.time() - t0:.1f} s)')
    haps = {'h1': ('wtig_h1', h1), 'h2': ('wtig_h2', h2)}
    run_dir, recs, wide_launches, classes = measured_run(work, 'wide16', ref, haps, card)
    launched_widths('wide16', classes)
    vcf = os.path.join(run_dir, 'wide16.vcf.gz')
    count, digest = synth.records_digest(vcf)
    want = synth.WIDE16_REFERENCE
    log(f'wide16 VCF records: {count}, sha256 {digest}; pav_tpu\'s on its accelerator '
        f'branch (synth.WIDE16_REFERENCE): {want[0]}, sha256 {want[1]}')
    if (count, digest) != want:
        fail('wide16: the VCF records differ from pav_tpu\'s on its accelerator branch')
    synth.hold_to_truth('wide16 VCF', vcf, t1 + t2)
    size_bin('wide16', vcf, t1 + t2)
    traced_run(work, 'wide16', ref, haps, recs, 'a second run')
    dp_classes('wide16', classes, dev)
    hold_classes('wide16', classes, dev)
    return {k: launches[k] + wide_launches[k] for k in launches}


class _Tee:
    """A text stream that writes to ``stream`` and keeps a copy
    (getvalue)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def getvalue(self):
        return ''.join(self.parts)


def asm_card_run(work, name, sample):
    """An asm_genome sample (synth) through the CLI on DEVICE in this
    process, the pipeline's log (stderr) kept and its merge jobs on a
    chromosome subset (the sharded branch) counted. Returns (run dir, wall,
    launches, gather flags, log text, sharded merge jobs), the counts read
    from 0 just before the run to just after it."""
    from pav_tpu_torch import pipeline as port_pipeline
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels
    ref, h1, h2 = sample[:3]
    d = os.path.join(work, name)
    argv = write_sample(d, name, ref, {'h1': h1, 'h2': h2})
    run_dir = os.path.join(d, f'run_{DEVICE}')
    sharded = []
    merge = port_pipeline.merge_haplotypes

    def counted(*args, subset_chrom=None, **kwargs):
        if subset_chrom is not None:
            sharded.append(tuple(sorted(subset_chrom)))
        return merge(*args, subset_chrom=subset_chrom, **kwargs)
    launches_reset()
    affine_dp.stats_reset()
    tee = _Tee(sys.stderr)
    port_pipeline.merge_haplotypes = counted
    try:
        with contextlib.redirect_stderr(tee):
            wall = run_cli([*argv, '--run-dir', run_dir, '--device', DEVICE])
    finally:
        port_pipeline.merge_haplotypes = merge
    launches = launches_read()
    return run_dir, wall, launches, affine_dp.STATS['gather_flags'], tee.getvalue(), sharded


def asm_paths(label, run_dir, name, flags, log_text, sharded=None):
    """Fail unless an asm_genome sample's run took the paths no earlier
    sample reaches: the resident gather read reverse-strand windows (gather
    flags 2 and 3), every haplotype planned more than one contig (the
    aligner's planning pool), the merge ran over 2 chromosome batches and
    took its sharded branch (``sharded``: the merge jobs counted on a
    chromosome subset; None: inferred from calls on both chromosomes), and
    trimming in reference space removed bases (the contigs' overlaps).
    Logs each, with the bases trimmed in query space."""
    import re
    import pandas as pd
    planned = dict(re.findall(r'\] (h[12]): aligning (\d+) contigs', log_text))
    batches = re.findall(r'\((\d+) chromosome batches\)', log_text)
    chroms = sorted({rec.split('\t')[0]
                     for rec in vcf_records(os.path.join(run_dir, f'{name}.vcf.gz'))})
    trims = {}
    for hap in ('h1', 'h2'):
        tier = {t: pd.read_csv(os.path.join(run_dir, name, hap, f'align_trim-{t}.tsv.gz'),
                               sep='\t') for t in ('none', 'qry', 'qryref')}

        def bases(t, lo, hi):
            return int((tier[t][hi] - tier[t][lo]).sum())
        trims[hap] = dict(records=[tier[t].shape[0] for t in ('none', 'qry', 'qryref')],
                          contigs=int(tier['none']['QRY_ID'].nunique()),
                          tig_bp=bases('none', 'QRY_POS', 'QRY_END') - bases('qry', 'QRY_POS',
                                                                             'QRY_END'),
                          ref_bp=bases('qry', 'POS', 'END') - bases('qryref', 'POS', 'END'))
    how = (f'{len(sharded)} merge jobs on one chromosome batch' if sharded is not None
           else f'calls on {chroms}, so each merge job with calls on both shards')
    log(f'{label} paths: resident gather windows by flag 0-3 {tuple(flags)}; contigs planned '
        f'{planned}; merge over {batches} chromosome batches, sharded ({how}); trimming '
        f'(records none/qry/qryref, contigs aligned, query bp trimmed in tig mode, reference '
        f'bp trimmed in ref mode): {trims}')
    if not (flags[2] > 0 and flags[3] > 0):
        fail(f'{label}: the resident gather read no reverse-strand window (flags 0-3 {flags})')
    if sorted(planned) != ['h1', 'h2'] or min(int(n) for n in planned.values()) < 2:
        fail(f'{label}: a haplotype planned fewer than 2 contigs: {planned}')
    if batches != ['2']:
        fail(f'{label}: the merge logged {batches} chromosome batches, not 2')
    if (len(chroms) < 2) if sharded is None else not sharded:
        fail(f'{label}: the merge never took its sharded branch ({how})')
    if min(t['ref_bp'] for t in trims.values()) <= 0:
        fail(f'{label}: trimming removed no overlap in reference space: {trims}')


def phase_asm(work, card, dev):
    """14. Assemblies shaped like users' (synth.asm_genome: GRCh38's chr21
    and chr22 lengths, each haplotype in contigs on both strands, some
    overlapping, in shuffled FASTA order). 14a: asm_tiny through the CLI on
    the card and through Pipeline(device='cpu', ladder='accel'): identical
    VCF records; asm10 through the CLI on the card: its records' digest
    equal to pav_tpu's (synth.ASM10_REFERENCE), its VCF held to the floors;
    both must take asm_paths' paths. 14b: asm97 (phase_asm97). Returns the
    launches of the three card runs (each read from 0 just before to just
    after it)."""
    from pav_tpu_torch import synth
    from pav_tpu_torch.io.fasta import SeqStore
    from pav_tpu_torch.pipeline import Pipeline

    stamp('phase 14a')
    tiny = synth.asm_genome(*synth.ASM_TINY)
    run_dir, wall, total, flags, text, sharded = asm_card_run(work, 'asm_tiny', tiny)
    asm_paths('asm_tiny', run_dir, 'asm_tiny', flags, text, sharded)
    t0 = time.time()
    cpu = Pipeline(SeqStore(tiny[0]), {}, run_dir=os.path.join(work, 'asm_tiny', 'run_cpu'),
                   device='cpu', ladder='accel').run_sample(
        'asm_tiny', {'h1': SeqStore(tiny[1]), 'h2': SeqStore(tiny[2])})
    cpu_s = time.time() - t0
    gpu_recs = vcf_records(os.path.join(run_dir, 'asm_tiny.vcf.gz'))
    cpu_recs = vcf_records(cpu['vcf'])
    if not gpu_recs or gpu_recs != cpu_recs:
        fail(f'asm_tiny: cuda and cpu (ladder=accel) VCFs differ ({len(gpu_recs)} vs '
             f'{len(cpu_recs)} records)')
    log(f'asm_tiny ({sum(len(c) for c in tiny[0].values())} bp reference, {len(tiny[1])} + '
        f'{len(tiny[2])} contigs): cuda and cpu (ladder=accel) VCFs identical ({len(gpu_recs)} '
        f'records); CLI wall {wall:.2f} s on {card}, the CPU run {cpu_s:.1f} s; launches {total}')

    asm10 = synth.asm_genome(*synth.ASM10)
    run_dir, wall, launches, flags, text, sharded = asm_card_run(work, 'asm10', asm10)
    vcf = os.path.join(run_dir, 'asm10.vcf.gz')
    count, digest = synth.records_digest(vcf)
    want = synth.ASM10_REFERENCE
    mbp = sum(len(c) for hap in asm10[1:3] for c in hap.values()) / 1e6
    log(f'asm10 ({sum(len(c) for c in asm10[0].values())} bp reference, {len(asm10[1])} + '
        f'{len(asm10[2])} contigs, {mbp:.3f} contig Mbp): CLI wall {wall:.2f} s '
        f'({mbp / wall:.3f} contig Mbp/s) on {card}; launches {launches}; VCF records {count}, '
        f'sha256 {digest}; pav_tpu\'s on its accelerator branch (synth.ASM10_REFERENCE): '
        f'{want[0]}, sha256 {want[1]}')
    if (count, digest) != want:
        fail('asm10: the VCF records differ from pav_tpu\'s on its accelerator branch')
    asm_paths('asm10', run_dir, 'asm10', flags, text, sharded)
    synth.hold_to_truth('asm10 VCF', vcf, asm10[3] + asm10[4])
    require_main_path('asm10', launches)
    del tiny, asm10
    stamp('phase 14b')
    launches97 = phase_asm97(work, card, dev)
    return {k: total[k] + launches[k] + launches97[k] for k in total}


def phase_asm97(work, card, dev):
    """14b. asm97 (synth.ASM97: GRCh38's chr21 and chr22 at full length)
    from FASTA through the CLI on the card in a child process
    (run_cli_child, no instrumentation), measured as phase 11's run is:
    wall, stage seconds, ALIGN_STATS_BY_HAP summed and by haplotype,
    launches, the DP class table with each class timed alone, gather flags,
    density paths, the child's peak RSS, torch's peak allocation, nvidia-smi
    samples; the sample's contig count and NG50. The full-width, traceback
    and seeding kernels must launch, the run must take asm_paths' paths and
    its VCF meet the floors. Returns its launches."""
    import torch
    from pav_tpu_torch import asmstat, synth
    d = os.path.join(work, 'asm97')
    t0 = time.time()
    ref, h1, h2, t1, t2, layout = synth.asm_genome(*synth.ASM97)
    t_gen = time.time() - t0
    t0 = time.time()
    argv = write_sample(d, 'asm97', ref, {'h1': h1, 'h2': h2})
    genome = sum(len(c) for c in ref.values())
    mbp = sum(len(c) for hap in (h1, h2) for c in hap.values()) / 1e6
    ng50 = {hap: asmstat.n50([len(c) for c in tigs.values()], genome)
            for hap, tigs in (('h1', h1), ('h2', h2))}
    shape = {hap: dict(contigs=len(tigs), reverse=sum(layout[t]['strand'] == '-' for t in tigs))
             for hap, tigs in (('h1', h1), ('h2', h2))}
    log(f'asm97: {genome} bp reference ({", ".join(f"{c} {len(s)}" for c, s in ref.items())}; '
        f'seed {synth.ASM97[1]}), {mbp:.3f} contig Mbp in {len(h1)} + {len(h2)} contigs '
        f'{shape}, contig NG50 (genome size the reference) {ng50}, {len(t1)} + {len(t2)} '
        f'planted events; generated in {t_gen:.1f} s, FASTAs written in {time.time() - t0:.1f} s '
        f'(outside the wall)')
    del ref, h1, h2
    torch.cuda.empty_cache()
    run_dir = os.path.join(d, 'run')
    before = smi_memory_used()
    with gpu_samples(os.path.join(d, 'smi.csv')) as smi:
        st, proc_wall, rss = run_cli_child(
            d, [*argv, '--run-dir', run_dir, '--device', DEVICE], 'asm97', ASM_TIMEOUT)
    vcf = os.path.join(run_dir, 'asm97.vcf.gz')
    recs = vcf_records(vcf)
    launches = st['launches']
    log(f'asm97 diploid: {len(recs)} VCF records; wall {st["wall"]:.2f} s (the CLI\'s main, no '
        f'profiler; {proc_wall:.2f} s with the process start), {mbp / st["wall"]:.3f} contig '
        f'Mbp/s on {card}; launches {launches}; resident gather windows by flag 0-3 '
        f'{st["gather_flags"]}')
    if not recs:
        fail('the asm97 VCF has no records')
    require_main_path('asm97', launches)
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, 'asm97')))
    log_align_stats(st['align_stats_by_hap'])
    log(f'asm97 density paths (calls, largest grid): {st["density"]}')
    wide = sorted(k for k in st['classes'] if k[2] == k[1] + 1 and k[2] > 4097)
    log(f'asm97 dp_wave launches: {launches["wave"]}; dp_full classes wider than 4097: '
        f'{[(k, st["classes"][k][0]) for k in wide] or "none"}')
    log(f'asm97 CLI child: peak RSS {rss / 2**30:.2f} GiB (os.wait4 ru_maxrss); '
        f'{smi_note(smi, before)}; on {card}')
    if st['torch_memory'] is None:
        fail('asm97: the CLI child never initialised CUDA')
    log(f'asm97 CLI child: torch max_memory_allocated {st["torch_memory"][0] / 2**20:.1f} MiB, '
        f'max_memory_reserved {st["torch_memory"][1] / 2**20:.1f} MiB (the whole CLI run)')
    with open(os.path.join(d, 'asm97.log')) as fh:
        asm_paths('asm97', run_dir, 'asm97', st['gather_flags'], fh.read())
    dp_classes('asm97', st['classes'], dev, events=True)
    synth.hold_to_truth('asm97 VCF', vcf, t1 + t2)
    return launches


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _wait_all(procs, timeout):
    """Wait for every process; kill the rest and fail on a nonzero exit."""
    outs = []
    try:
        for proc, label in procs:
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                fail(f'{label} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}')
            outs.append(out)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def phase_cohort(work, card, genome):
    """Two 16 Mbp diploid samples on one reference: (a) one CLI process,
    (b) a 2-process cohort on the one card, both without a profiler (the
    walls and the samples-per-hour ratio), then (c) the cohort again with
    per-process run and profile
    directories, whose traces must hold the kernels."""
    from pav_tpu_torch import synth
    d = os.path.join(work, 'cohort')
    os.makedirs(d)
    ref, a1, a2 = genome
    _, b1, b2, _, _ = synth.bench_genome(len(ref), 11, hap_seeds=(14, 15))
    write_fasta(os.path.join(d, 'ref.fa'), {'chr1': ref})
    rows = ['NAME\tHAP_h1\tHAP_h2']
    for name, (x1, x2) in (('cohA', (a1, a2)), ('cohB', (b1, b2))):
        for hap, codes in (('h1', x1), ('h2', x2)):
            write_fasta(os.path.join(d, f'{name}_{hap}.fa'), {f'{name}_{hap}': codes})
        rows.append(f'{name}\t{name}_h1.fa\t{name}_h2.fa')
    with open(os.path.join(d, 'asm.tsv'), 'w') as fh:
        fh.write('\n'.join(rows) + '\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, '-m', 'pav_tpu_torch', '--ref', 'ref.fa',
            '--assemblies', 'asm.tsv', '--device', DEVICE]

    t0 = time.time()
    (out_a,) = _wait_all([(subprocess.Popen(
        base + ['--run-dir', 'run_single'], cwd=d,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        'single CLI process')], 900)
    wall_a = time.time() - t0

    def cohort(tag, extra):
        port = _free_port()
        return _wait_all([(subprocess.Popen(
            base + ['--run-dir', f'{tag}{pid}', *extra(pid),
                    '--coordinator', f'localhost:{port}', '--num-processes', '2',
                    '--process-id', str(pid), '--ship-artifacts'], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            f'cohort process {pid}') for pid in (0, 1)], 900)

    t0 = time.time()
    outs = cohort('run', lambda pid: [])
    wall_b = time.time() - t0
    outs_p = cohort('prun', lambda pid: ['--profile-dir', f'prof{pid}'])

    for name in ('cohA', 'cohB'):
        if f'{name}:' not in out_a:
            fail(f'single CLI process printed no line for {name}')
        want = vcf_records(os.path.join(d, 'run_single', f'{name}.vcf.gz'))
        if not want:
            fail(f'cohort: the single-process VCF of {name} has no records')
        for tag, runs in (('run', outs), ('prun', outs_p)):
            for pid, out in enumerate(runs):
                if f'{name}:' not in out or 'ERROR' in out:
                    fail(f'cohort process {pid} did not print the full manifest:\n{out}')
                got = vcf_records(os.path.join(d, f'{tag}{pid}', f'{name}.vcf.gz'))
                if got != want:
                    fail(f'cohort: {tag}{pid}/{name} VCF differs from the single-process run')
    for pid in (0, 1):
        with open(os.path.join(d, f'prof{pid}', 'trace.json')) as fh:
            if TRACE_KERNEL not in fh.read():
                fail(f'cohort process {pid}: {TRACE_KERNEL} not in its profiler trace')
    log(f'cohort: 2 x 16 Mbp diploid samples, no profiler; one process {wall_a:.2f} s, '
        f'2-process cohort on one card {wall_b:.2f} s: samples/hour ratio '
        f'{wall_a / wall_b:.3f}; VCFs equal in every run dir; {TRACE_KERNEL} '
        f'in both traces of the profiled cohort; on {card}')


if __name__ == '__main__':
    sys.exit(main())
