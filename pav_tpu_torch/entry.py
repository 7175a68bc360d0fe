"""Entry points: the flagship device computation, and the engine's device
step over a mesh (port of the repository's ``__graft_entry__.py``).

``entry()`` returns the batched row-banded affine-gap DP (the
``dp_band`` kernel, ``ops/dp_kernels.align_band``) with example inputs.
``dryrun_multichip(n)`` runs the engine's device work data-parallel over an
n-device mesh (``parallel.mesh``) on tiny shapes: the mesh-sharded aligner,
the DP and the density convolution on each shard, the chain scan, the
batched density, and a 60 kb pipeline sharded against unsharded. Both run
on ``cuda`` unless the caller asks for the CPU; a mesh of n CUDA devices
needs n cards (``make_mesh`` raises), or an explicit device list.
"""

import numpy as np
import torch

from .device import resolve_device
from .io.fasta import SeqStore
from .ops import affine_dp, chain_scan, dp_kernels, kde
from .parallel.mesh import make_mesh, on_device, place_batch
from .pipeline import Pipeline

SCORING = affine_dp._scoring_tuple(affine_dp.DEFAULT_SCORING)


def _example_dp_args(batch=4, max_m=64, device=None):
    """q int8 [batch, max_m], r int8 [batch, max_m + 8], m, n int32 [batch]:
    the draws of ``__graft_entry__._example_dp_args`` (seed 0) on
    ``device``."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (batch, max_m)).astype(np.int8)
    r = rng.integers(0, 4, (batch, max_m + 8)).astype(np.int8)
    m = np.full(batch, max_m, dtype=np.int32)
    n = np.full(batch, max_m + 8, dtype=np.int32)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, r, m, n))


def entry(device=None):
    """(fn, example_args): ``fn(q, r, m, n)`` is the row-banded DP at a band
    of 65 columns, returning (score [B, 65], tb [B, max_m, 65], offs [B,
    max_m]); the example is 4 items of 64 x 72 on ``device``."""
    max_m, width = 64, 65

    def fn(q, r, m, n):
        return dp_kernels.align_band(q, r, m, n, width, SCORING)

    return fn, _example_dp_args(batch=4, max_m=max_m, device=device)


def _device_step(mesh, arrays, max_m, width):
    """The row-banded DP and the density convolution on each shard of the
    batch; per-shard totals summed on the first device. Returns (score, tb,
    offs, dens) on the CPU, rows in order, and the total."""
    outs, partial = [], []
    for dev, (q, r, m, n, hist, kern) in place_batch(
            [torch.from_numpy(a) for a in arrays], mesh):
        with on_device(dev):
            score, tb, offs = dp_kernels.align_band(q, r, m, n, width, SCORING)
            dens = kde._conv_batch(hist, kern, 512)
            outs.append((score, tb, offs, dens))
            partial.append(score.to(torch.float32).sum() + dens.sum())
    total = torch.stack([p.to(mesh[0]) for p in partial]).sum()
    return [torch.cat([o[k].cpu() for o in outs]) for k in range(4)], float(total)


def dryrun_multichip(n_devices, device=None, mesh=None):
    """The engine's sharded device step on an ``n_devices`` mesh.

    :param device: the mesh's device type when ``mesh`` is not given:
        ``make_mesh(n_devices, device)`` (``cuda`` by default).
    :param mesh: an explicit list of ``n_devices`` devices (a device may
        repeat, e.g. ``[cuda:0] * n`` on one card).
    :return: dict of the results: ``cigars`` (the sharded aligner's), the
        device step's ``score``, ``tb``, ``offs``, ``dens`` and ``total``,
        ``chain`` and ``chain_batch`` (chain scan), ``regions`` and their
        ``states`` (batched density), and the mini pipeline's
        ``merged_mesh`` and ``merged_single`` tables.
    :raises RuntimeError: a result is missing or the sharded pipeline's
        calls differ from the unsharded one's.
    """
    n = int(n_devices)
    if mesh is None:
        mesh = make_mesh(n, resolve_device(device))
    else:
        mesh = [resolve_device(d) for d in mesh]
        if len(mesh) != n:
            raise ValueError(f'mesh has {len(mesh)} devices, expected {n}')
    dev0 = mesh[0]

    # The engine's mesh-sharded DP path (the pipeline's with mesh_devices=n).
    rng0 = np.random.default_rng(3)
    pairs = []
    for _ in range(2 * n):
        qq = rng0.integers(0, 4, 24).astype(np.uint8)
        pairs.append((qq, qq.copy()))
    cigars = affine_dp.BandedAligner(device=dev0, mesh=mesh).align_batch(
        pairs, width=33, pad_to=32)
    if len(cigars) != 2 * n:
        raise RuntimeError(f'{len(cigars)} CIGARs for {2 * n} pairs')

    # Device step: row-banded DP at 32 x 32 (width 33) and the density
    # convolution, two rows a shard.
    B, max_m, width = 2 * n, 32, 33
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, (B, max_m)).astype(np.int8)
    r = rng.integers(0, 4, (B, max_m)).astype(np.int8)
    lens = np.full(B, max_m, dtype=np.int32)
    hist = rng.integers(0, 2, (B, 256)).astype(np.float32)
    kern = np.tile(np.exp(-0.5 * np.linspace(-3, 3, 31) ** 2).astype(np.float32), (B, 1))
    (score, tb, offs, dens), total = _device_step(
        mesh, (q, r, lens, lens.copy(), hist, kern), max_m, width)
    if not np.isfinite(total):
        raise RuntimeError(f'device step total {total} is not finite')

    # Chain scan: one slab (native host kernel, or the scan on dev0 without
    # it), then n slabs sharded over the mesh.
    qpos = np.arange(64, dtype=np.int32) * 7
    chain = chain_scan.chain_scores(qpos, qpos.copy(), np.zeros(64), k=19, device=dev0)
    slabs = [(qpos.astype(np.int64), qpos.astype(np.int64) + 3,
              np.zeros(64, dtype=np.int64)) for _ in range(n)]
    chain_batch = chain_scan.chain_scores_batch(slabs, 19, mesh=mesh)
    regions = [rng.integers(0, 3, 800).astype(np.int8) for _ in range(n)]
    sig = [kde.scott_sigmas(s, 0.25) for s in regions]
    states = kde.smoothed_states_batch(regions, sig, mesh=mesh)
    if len(chain_batch) != n or len(states) != n or any(len(s) != 800 for s in states):
        raise RuntimeError('the chain scan or the density lost a shard')

    # Whole-engine mini pipeline with its DP sharded over the mesh, against
    # the unsharded run.
    rng2 = np.random.default_rng(7)
    ref_seq = rng2.integers(0, 4, 60000).astype(np.uint8)
    hap = np.concatenate([
        ref_seq[:20000],
        rng2.integers(0, 4, 150).astype(np.uint8),   # 150 bp INS
        ref_seq[20000:40000], ref_seq[40200:]])      # 200 bp DEL

    def run_engine(sharded):
        pipe = Pipeline(SeqStore({'c1': ref_seq}), {'aligner_min_chain_score': 500},
                        device=dev0, mesh=mesh if sharded else None)
        return pipe.run_sample('dry', {'h1': SeqStore({'t1': hap})},
                               write_vcf=False)['merged']

    merged_mesh = run_engine(True)
    merged_single = run_engine(False)
    for key in (('svindel_ins', 'pass'), ('svindel_del', 'pass')):
        a, b = merged_mesh[key], merged_single[key]
        if not (a.shape[0] == b.shape[0] >= 1 and list(a['ID']) == list(b['ID'])):
            raise RuntimeError(f'{key}: sharded {a.shape} vs unsharded {b.shape}')
    return {'cigars': cigars, 'score': score, 'tb': tb, 'offs': offs, 'dens': dens,
            'total': total, 'chain': chain, 'chain_batch': chain_batch,
            'regions': regions, 'states': states,
            'merged_mesh': merged_mesh, 'merged_single': merged_single}
