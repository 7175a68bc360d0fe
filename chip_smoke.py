#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, parity, main path.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --dp-full-times
    python3 chip_smoke.py --chrom

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
"shapes": [...]}. ``--chrom`` runs phases 1, 2 and 11 alone and prints no
result line. A copy of this file placed in another checkout (``git
archive`` of a parent commit) times that checkout's kernels: run the two in
one call, in turns (A, B, B, A), to compare two versions on one card.

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
     bound (n steps of the probe's dependent chain). Then the batched
     density on CUDA against the same call on the CPU (decision level),
     with its bound at DENSITY_LONG;
  4. main path: a 16 Mbp reference and a diploid sample (the generator of
     bench.py, seed 11) from FASTA through ``python -m pav_tpu_torch
     --device cuda`` to a VCF; the full-width and traceback kernels must run.
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
     records in both, the full-width and traceback kernels must run, and the
     VCF must meet the recall floors against the planted truth;
 12. bench: ``bench_torch.py`` (the port of bench.py) in a subprocess on the
     card with BENCH_ENV (a 10 Mbp chromosome child, at most two headline
     iterations): its last JSON line must carry backend cuda, 0 < mfu <= 1
     and the repeat-rich and chromosome keys, and its repeat-rich child must
     launch dp_wave; its lines are relayed, and its headline set beside
     phase 4's CLI rate on the same genome.
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
# Phase 11: bench.py's chromosome-scale sample (PAV_BENCH_CHROM_MBP's
# default, seed SEED + 17).
CHROM_REF_LEN = 100_000_000
CHROM_SEED = 28
# Phase 12: bench_torch.py at its defaults but these, within its own budget
# and a timeout (phase 11 already runs the 100 Mbp sample).
BENCH_ENV = {'PAV_BENCH_CHROM_MBP': '10', 'PAV_BENCH_MAX_ITERS': '2',
             'PAV_BENCH_TOTAL_S': '420'}
BENCH_TIMEOUT = 480
# tests/test_recall.py's floors against planted truth: (class, column, least).
# INV also needs at least one INV in the truth.
RECALL_FLOORS = (('SNV', 'RECALL', 0.99), ('SNV', 'PRECISION', 0.99),
                 ('INS', 'RECALL', 0.97), ('DEL', 'RECALL', 0.97),
                 ('INS', 'PRECISION', 0.95), ('DEL', 'PRECISION', 0.95),
                 ('INV', 'RECALL', 1.0))
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
}


def log(msg):
    print(msg, flush=True)


def stamp(label):
    log(f'[{time.time() - T0:.0f} s] {label}')


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------- synthetic genomes
# The generators of tests/helpers.py (random background, planted
# mutations with truth, repeat-rich references), here on the port's own
# seqcodec so that this script imports nothing of the JAX package.

BASES = 'ACGT'


def _codec():
    """The port's seqcodec, imported at first use: the checkout is on the
    path by then (main puts it there; an importer has it already)."""
    from pav_tpu_torch import seqcodec
    return seqcodec


def random_seq(n, rng, gc=0.5):
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


class Mutator:
    """Applies mutations to a code-array sequence, tracking truth records.

    Mutations are specified at original (reference) coordinates and must be
    non-overlapping and applied in ascending position order.
    """

    def __init__(self, ref_codes):
        self.ref = np.asarray(ref_codes, dtype=np.uint8)
        self.pieces = []   # list of code arrays composing the mutant
        self.cursor = 0    # position in ref consumed so far
        self.truth = []    # list of dicts: type, ref_pos, len, seq

    def _advance(self, pos):
        if pos < self.cursor:
            raise ValueError('Mutations must be applied in ascending order')
        self.pieces.append(self.ref[self.cursor:pos])
        self.cursor = pos

    def snv(self, pos, alt=None, rng=None):
        self._advance(pos)
        ref_base = int(self.ref[pos])
        if alt is None:
            choices = [b for b in range(4) if b != ref_base]
            alt = int((rng or np.random.default_rng(pos)).choice(choices))
        self.pieces.append(np.array([alt], dtype=np.uint8))
        self.cursor = pos + 1
        self.truth.append({'type': 'SNV', 'pos': pos, 'ref': BASES[ref_base], 'alt': BASES[alt]})

    def ins(self, pos, seq_codes):
        self._advance(pos)
        seq_codes = np.asarray(seq_codes, dtype=np.uint8)
        self.pieces.append(seq_codes)
        self.truth.append({'type': 'INS', 'pos': pos, 'len': len(seq_codes),
                           'seq': _codec().decode(seq_codes)})

    def dele(self, pos, length):
        self._advance(pos)
        self.cursor = pos + length
        self.truth.append({'type': 'DEL', 'pos': pos, 'len': length,
                           'seq': _codec().decode(self.ref[pos:pos + length])})

    def inv(self, pos, length):
        self._advance(pos)
        self.pieces.append(_codec().revcomp(self.ref[pos:pos + length]))
        self.cursor = pos + length
        self.truth.append({'type': 'INV', 'pos': pos, 'len': length})

    def finish(self):
        self._advance(len(self.ref))
        return np.concatenate(self.pieces) if self.pieces else np.zeros(0, dtype=np.uint8)


def repeat_rich_ref(length, rng, n_gap_prop=0.005):
    """A reference with realistic repeat structure: tandem arrays, diverged
    segmental duplications, inverted duplications, an interspersed repeat
    family, and N-gap runs over a random background.

    These are the inputs that actually break aligners (VERDICT r1 weak #6;
    reference stressors: pavlib/inv.py:457-561 inverted dups,
    scripts/density.py:47 low-complexity bail). Returns (codes, annotations)
    where annotations is a list of (kind, pos, end) for the planted features.
    """
    seg = []
    ann = []
    cur = 0

    # An ALU-like 300bp family consensus reused genome-wide with divergence.
    family = random_seq(300, rng)

    def diverge(codes, rate):
        out = codes.copy()
        n_mut = rng.binomial(len(codes), rate)
        if n_mut:
            idx = rng.choice(len(codes), n_mut, replace=False)
            out[idx] = (out[idx] + 1 + rng.integers(0, 3, n_mut)) % 4
        return out

    segdup_bank = []
    while cur < length:
        r = rng.random()
        if r < 0.42:                                  # unique background
            n = int(rng.integers(3000, 12000))
            seg.append(random_seq(n, rng))
        elif r < 0.62:                                # tandem array
            unit = random_seq(int(rng.integers(2, 200)), rng)
            copies = int(rng.integers(5, max(6, 2000 // max(len(unit), 1))))
            arr = diverge(np.tile(unit, copies), 0.01)
            ann.append(('tandem', cur, cur + len(arr)))
            seg.append(arr)
        elif r < 0.74:                                # interspersed family
            seg.append(diverge(family, 0.08))
            ann.append(('family', cur, cur + 300))
        elif r < 0.86 and segdup_bank:                # segdup copy (1-5% div)
            src = segdup_bank[rng.integers(0, len(segdup_bank))]
            dup = diverge(src, rng.uniform(0.01, 0.05))
            if rng.random() < 0.3:                    # inverted duplication
                dup = _codec().revcomp(dup)
                ann.append(('inv_dup', cur, cur + len(dup)))
            else:
                ann.append(('segdup', cur, cur + len(dup)))
            seg.append(dup)
        elif r < 0.86:                                # seed a segdup source
            n = int(rng.integers(5000, 20000))
            block = random_seq(n, rng)
            segdup_bank.append(block)
            ann.append(('segdup_src', cur, cur + n))
            seg.append(block)
        elif r < 0.86 + n_gap_prop * 10:              # N-gap
            n = int(rng.integers(100, 5000))
            ann.append(('n_gap', cur, cur + n))
            seg.append(np.full(n, _codec().AMBIG, dtype=np.uint8))
        else:                                         # low-complexity run
            unit = random_seq(int(rng.integers(1, 4)), rng)
            n = int(rng.integers(200, 1500))
            arr = np.tile(unit, n // len(unit) + 1)[:n]
            ann.append(('low_complexity', cur, cur + n))
            seg.append(arr)
        cur += len(seg[-1])

    codes = np.concatenate(seg)[:length]
    ann = [(k, p, min(e, length)) for k, p, e in ann if p < length]
    return codes, ann


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


def bench_genome(ref_len, seed, hap_seeds=None):
    """The diploid sample of bench.py's build_genome (no cache): (ref, h1,
    h2, truth of h1, truth of h2), the truths as Mutator.truth lists;
    haplotype seeds default to bench.py's (seed + 1, seed + 2)."""
    rng = np.random.default_rng(seed)
    ref = random_seq(ref_len, rng)
    s1, s2 = hap_seeds or (seed + 1, seed + 2)

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
        return mut.finish(), mut.truth

    (h1, t1), (h2, t2) = make_hap(s1, False), make_hap(s2, True)
    return ref, h1, h2, t1, t2


def repeat_genome(ref_len, seed):
    """The repeat-rich sample of bench.py (repeat_rich_ref + its mutator)."""
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


# ------------------------------------------------------ planted truth

def truth_to_df(truth, chrom='chr1'):
    """Mutator truth records as a call table (tests/test_recall.py's)."""
    import pandas as pd
    rows = []
    for t in truth:
        if t['type'] == 'SNV':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'SNV', 1, t['ref'], t['alt']))
        elif t['type'] == 'INS':
            rows.append((chrom, t['pos'], t['pos'] + 1, 'INS', t['len'], 'N', 'N'))
        elif t['type'] == 'DEL':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'DEL', t['len'], 'N', 'N'))
        elif t['type'] == 'INV':
            rows.append((chrom, t['pos'], t['pos'] + t['len'], 'INV', t['len'], 'N', 'N'))
    df = pd.DataFrame(rows, columns=['#CHROM', 'POS', 'END', 'SVTYPE', 'SVLEN', 'REF', 'ALT'])
    df['ID'] = [f'truth{i}' for i in range(df.shape[0])]
    df['FILTER'] = 'PASS'
    df['GT'] = '1'
    return df


def truth_report(vcf_path, truth):
    """(report, misses): the concordance of a VCF with planted truth by
    class (pav_tpu_torch.eval, the matching of tests/test_recall.py, the
    truth deduplicated as there) and the RECALL_FLOORS it misses."""
    from pav_tpu_torch import eval as ev
    want = truth_to_df(truth).drop_duplicates(subset=['POS', 'SVTYPE', 'SVLEN', 'ALT'])
    rep = ev.concordance(want, ev.read_vcf(vcf_path)).set_index('SVTYPE')
    misses = [f'{cls} {col} {rep.loc[cls, col]:.4f} < {floor}'
              for cls, col, floor in RECALL_FLOORS if not rep.loc[cls, col] >= floor]
    if not rep.loc['INV', 'N_TRUTH'] >= 1:
        misses.append('no INV in the truth')
    return rep, misses


def hold_to_truth(label, vcf_path, truth):
    """Fail unless the VCF meets RECALL_FLOORS against planted truth; logs
    the concordance table either way."""
    t0 = time.time()
    rep, misses = truth_report(vcf_path, truth)
    log(f'{label} against planted truth ({time.time() - t0:.1f} s):\n{rep.to_string()}')
    if misses:
        fail(f'{label} misses the recall floors: {"; ".join(misses)}')
    log(f'{label}: every recall floor met')


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
    was initialised."""
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
    t0 = time.time()
    rc = cli_main(argv)
    wall = time.time() - t0
    memory = ([torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()]
              if torch.cuda.is_initialized() else None)
    with open(stats_path, 'w') as fh:
        json.dump({'rc': rc, 'wall': wall, 'torch_memory': memory,
                   'launches': dict(dp_kernels.LAUNCHES,
                                    chain_scan=chain_scan.LAUNCHES['chain_scan']),
                   'classes': [[list(k), list(v)] for k, v in affine_dp.STATS['classes'].items()],
                   'density': density, 'align_stats': dict(core.ALIGN_STATS)}, fh)
    return rc


def run_cli_child(d, argv, label, timeout):
    """``chip_smoke.py --cli-child`` (the CLI on ``argv``) as a child
    process; its output goes to ``d/label.log``. Returns (stats, process
    wall, peak RSS in bytes of that child alone, from os.wait4)."""
    stats_path = os.path.join(d, f'{label}_stats.json')
    log_path = os.path.join(d, f'{label}.log')
    with open(log_path, 'w') as fh:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), '--cli-child',
                                 stats_path, *argv], stdout=fh, stderr=subprocess.STDOUT,
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


def main():
    import argparse
    if sys.argv[1:2] == ['--cli-child']:
        return cli_child(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kernel-times', action='store_true',
                    help="only time this checkout's DP kernels and walker at phase 3's shapes")
    ap.add_argument('--dp-full-times', action='store_true',
                    help="only time this checkout's full-width DP kernel at FULL_SHAPES")
    ap.add_argument('--chrom', action='store_true',
                    help='run phases 1, 2 and 11 only (the chromosome-scale sample)')
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

    if args.chrom:
        with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
            stamp('phase 11')
            phase_chrom(work, card, dev)
        stamp('done')
        return 0

    # 3. kernels against their plain versions; times from a fresh process
    stamp('phase 3')
    kt = fresh_kernel_times()
    stats = phase_kernels(dev, kt)
    phase_chain_scan(dev, stats, kt)
    phase_density(dev)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix='pav_chip_smoke_') as work:
        main_launches, genome, bench16_rate = drive_main_path(work, card, dev)
        for key, count in drive_scale_out(work, card, dev, genome).items():
            main_launches[key] += count
        del genome
        stamp('phase 10')
        main_launches['band'] = phase_entry(card, dev)['band']
        stamp('phase 11')
        for key, count in phase_chrom(work, card, dev).items():
            main_launches[key] += count
    stamp('phase 12')
    torch.cuda.empty_cache()
    phase_bench(card, bench16_rate)
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
            key = (ev['name'].split('(')[0].split('::')[-1],
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
    dp_kernels.launches_reset()
    chain_scan.launches_reset()
    trace = os.path.join(work, f'{name}_trace.json')
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_dir_t, wall_t = run_sample(work, f'{name}t', ref, haps, DEVICE)
    launches = dict(dp_kernels.LAUNCHES, chain_scan=chain_scan.LAUNCHES['chain_scan'])
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


def drive_main_path(work, card, dev):
    """Phases 4-6; returns the kernel launches of phases 4 and 5 (each read
    from 0 just before its run to just after it), phase 4's genome (ref,
    h1, h2) and its contig Mbp/s (the CLI's wall)."""
    import torch
    from pav_tpu_torch.align.aligner import core
    from pav_tpu_torch.ops import affine_dp, chain_scan, dp_kernels

    # 4. main path, 16 Mbp diploid
    stamp('phase 4')
    t0 = time.time()
    ref, h1, h2, t1, t2 = bench_genome(BENCH_REF_LEN, 11)
    genome = (ref, h1, h2)
    log(f'genome: {len(ref) / 1e6:g} Mbp reference, haps {len(h1)} + {len(h2)} bp '
        f'({time.time() - t0:.1f} s)')
    haps = {'h1': ('tig_h1', h1), 'h2': ('tig_h2', h2)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = smi_memory_used()
    dp_kernels.launches_reset()
    chain_scan.launches_reset()
    affine_dp.stats_reset()
    core.align_stats_reset()
    with gpu_samples(os.path.join(work, 'bench16_smi.csv')) as smi:
        run_dir, wall = run_sample(work, 'bench16', ref, haps, DEVICE)
    main_launches = dict(dp_kernels.LAUNCHES, chain_scan=chain_scan.LAUNCHES['chain_scan'])
    # A copy of the counters: the traced run below adds to the same lists.
    classes = {k: tuple(v) for k, v in affine_dp.STATS['classes'].items()}
    recs = vcf_records(os.path.join(run_dir, 'bench16.vcf.gz'))
    rate = (len(h1) + len(h2)) / 1e6 / wall
    log(f'main path {len(ref) / 1e6:g} Mbp diploid: {len(recs)} VCF records, wall {wall:.2f} s '
        f'(no profiler), {rate:.3f} contig Mbp/s on {card}; launches {main_launches}')
    log('stage seconds: ' + json.dumps(stage_seconds(run_dir, 'bench16')))
    log('aligner host seconds (ALIGN_STATS): ' + json.dumps(
        {k: round(v, 3) for k, v in core.ALIGN_STATS.items()}))
    log(f'bench16 device memory: torch max_memory_allocated '
        f'{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, max_memory_reserved '
        f'{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB; {smi_note(smi, before)}; on {card}')
    if not recs:
        fail('the 16 Mbp VCF has no records')
    if main_launches['full'] <= 0 or main_launches['traceback'] <= 0:
        fail(f'the main path did not launch the full/traceback kernels: {main_launches}')
    hold_to_truth('bench16 VCF', os.path.join(run_dir, 'bench16.vcf.gz'), t1 + t2)

    # The same sample again under a CUDA-activity trace: device time by kernel.
    traced_run(work, 'bench16', ref, haps, recs, 'a second run')

    # 5. repeat-rich sample: the wavefront band kernel
    stamp('phase 5')
    rref, rhap = repeat_genome(REPEAT_REF_LEN, 18)
    rhaps = {'h1': ('rtig1', rhap)}
    dp_kernels.launches_reset()
    chain_scan.launches_reset()
    affine_dp.stats_reset()
    run_dir, wall = run_sample(work, 'rep2', rref, rhaps, DEVICE)
    rep_launches = dict(dp_kernels.LAUNCHES, chain_scan=chain_scan.LAUNCHES['chain_scan'])
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
    ref, h1, h2 = e2e_genome()
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
    return main_launches, genome, rate


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
    K.launches_reset()
    chain_scan.launches_reset()
    t0 = time.time()
    fn, args = entry.entry(device=dev)
    got = fn(*args)
    torch.cuda.synchronize()
    dry = entry.dryrun_multichip(2, mesh=[dev, dev])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(K.LAUNCHES, chain_scan=chain_scan.LAUNCHES['chain_scan'])
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
    return launches


def phase_chrom(work, card, dev):
    """11. bench.py's chromosome-scale sample (CHROM_REF_LEN, CHROM_SEED)
    from FASTA through the port's CLI on the card, in a child process
    (run_cli_child), twice: the first run warms up, the second is measured
    without a profiler (wall, stage seconds, launches, DP class table,
    density paths, the child's peak RSS, nvidia-smi samples beside it). Both
    runs write equal VCF records; the measured run's VCF is held to planted
    truth. Returns the measured run's launches."""
    import torch
    d = os.path.join(work, 'chrom')
    os.makedirs(d)
    t0 = time.time()
    ref, h1, h2, t1, t2 = bench_genome(CHROM_REF_LEN, CHROM_SEED)
    t_gen = time.time() - t0
    t0 = time.time()
    name = f'chrom{CHROM_REF_LEN // 1_000_000}'
    write_fasta(os.path.join(d, 'ref.fa'), {'chr1': ref})
    write_fasta(os.path.join(d, 'h1.fa'), {'tig_h1': h1})
    write_fasta(os.path.join(d, 'h2.fa'), {'tig_h2': h2})
    with open(os.path.join(d, 'asm.tsv'), 'w') as fh:
        fh.write(f'NAME\tHAP_h1\tHAP_h2\n{name}\t{os.path.join(d, "h1.fa")}\t'
                 f'{os.path.join(d, "h2.fa")}\n')
    mbp = (len(h1) + len(h2)) / 1e6
    log(f'{name}: {len(ref) / 1e6:g} Mbp reference (seed {CHROM_SEED}), haps {len(h1)} + '
        f'{len(h2)} bp = {mbp:.3f} contig Mbp, {len(t1)} + {len(t2)} planted events; generated '
        f'in {t_gen:.1f} s, FASTAs written in {time.time() - t0:.1f} s (outside the walls)')
    del ref, h1, h2

    def argv(run_dir):
        return ['--ref', os.path.join(d, 'ref.fa'), '--assemblies', os.path.join(d, 'asm.tsv'),
                '--run-dir', os.path.join(d, run_dir), '--device', DEVICE]
    torch.cuda.empty_cache()
    warm, warm_wall, warm_rss = run_cli_child(d, argv('run_warm'), f'{name}_warm', 900)
    log(f'{name} warm-up run: CLI wall {warm["wall"]:.2f} s ({warm_wall:.2f} s with the '
        f'process start), peak RSS {warm_rss / 2**30:.2f} GiB')
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
        f'{mbp / st["wall"]:.3f} contig Mbp/s on {card}; launches {launches}')
    if launches['full'] <= 0 or launches['traceback'] <= 0:
        fail(f'{name} did not launch the full/traceback kernels: {launches}')
    log('stage seconds: ' + json.dumps(stage_seconds(os.path.join(d, 'run'), name)))
    log('aligner host seconds (ALIGN_STATS): ' + json.dumps(
        {k: round(v, 3) for k, v in st['align_stats'].items()}))
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
    dp_classes(name, st['classes'], dev, events=True)
    hold_to_truth(f'{name} VCF', vcf, t1 + t2)
    return launches


def phase_bench(card, bench16_rate):
    """12. ``bench_torch.py --device DEVICE`` with BENCH_ENV in a subprocess
    (its own process group, killed whole at BENCH_TIMEOUT); its lines are
    relayed. Its last JSON line must carry backend DEVICE, 0 < mfu <= 1 and
    the three secondary keys, and its repeat-rich child must launch
    dp_wave."""
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, 'bench_torch.py'),
                             '--device', DEVICE], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=ROOT, **BENCH_ENV))
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, 9)
    wall = time.time() - t0
    for line in err.splitlines():
        log(f'  bench_torch stderr: {line}')
    for line in out.splitlines():
        log(f'  bench_torch stdout: {line}')
    if proc.returncode != 0:
        fail(f'bench_torch.py exited {proc.returncode} after {wall:.0f} s')
    lines = [json.loads(line) for line in out.splitlines() if line.startswith('{')]
    if not lines:
        fail('bench_torch.py printed no JSON line')
    last = lines[-1]
    missing = [k for k in ('metric', 'value', 'unit', 'vs_baseline', 'mfu', 'peak_rss_gb',
                           'backend', 'repeat_rich_mbp_s', 'chrom_scale_mbp_s',
                           'chrom_peak_rss_gb') if k not in last]
    if missing or last['backend'] != DEVICE:
        fail(f'bench_torch.py: last JSON line lacks {missing} or has backend '
             f'{last.get("backend")}: {last}')
    if not (isinstance(last['mfu'], float) and 0 < last['mfu'] <= 1):
        fail(f'bench_torch.py: mfu {last["mfu"]} is not in (0, 1]')
    rep = [line.split('repeat launches ', 1)[1] for line in err.splitlines()
           if 'repeat launches ' in line]
    if not rep or json.loads(rep[-1])['wave'] <= 0:
        fail(f'bench_torch.py: the repeat-rich child launched no dp_wave: {rep}')
    log(f'bench_torch.py ({json.dumps(BENCH_ENV)}): exit 0 in {wall:.1f} s; headline '
        f'{last["value"]} contig Mbp/s (best in-process Pipeline.run_sample) against phase '
        f'4\'s {bench16_rate:.4f} (one CLI run in this process, the same genome): ratio '
        f'{last["value"] / bench16_rate:.3f}; mfu {last["mfu"]}; repeat-rich '
        f'{last["repeat_rich_mbp_s"]} Mbp/s, dp_wave launches {json.loads(rep[-1])["wave"]}; '
        f'chrom {last["chrom_scale_mbp_s"]} Mbp/s; on {card}')


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
    walls and the samples-per-hour ratio; a profiled run runs its pools
    inline), then (c) the cohort again with per-process run and profile
    directories, whose traces must hold the kernels."""
    d = os.path.join(work, 'cohort')
    os.makedirs(d)
    ref, a1, a2 = genome
    _, b1, b2, _, _ = bench_genome(len(ref), 11, hap_seeds=(14, 15))
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
