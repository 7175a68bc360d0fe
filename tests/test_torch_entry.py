"""The port's entry points, assembly statistics and callset evaluation
against pav_tpu's, on the CPU.

* ``pav_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()``
  under ``jax.jit``: the same example arrays, and a bit-identical score,
  tape and offsets;
* ``align_band_ref`` with its score against ``affine_dp._align_batch`` at
  the dry run's shape, at a band exit and at a CPU-ladder band class;
* ``dryrun_multichip(8, device='cpu')`` against the JAX functions it
  mirrors (``_align_batch``, ``kde._conv_batch``, the chain scans), and
  its sharded pipeline against the unsharded one;
* ``asmstat`` and ``eval`` against pav_tpu's on test_graft_eval.py's VCFs
  and on the VCFs both packages write for the verify recipe's sample, and
  ``python -m pav_tpu_torch.eval`` printing ``python -m pav_tpu.eval``'s
  report.

The dry run's density is a float32 FFT in both packages (pocketfft in
torch, XLA's FFT in JAX), which round differently: it and the total that
sums it are compared to a relative 1e-5; every integer output exactly.
"""

import gzip
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import __graft_entry__ as graft
from pav_tpu import asmstat as ref_asmstat
from pav_tpu import eval as ref_eval
from pav_tpu.__main__ import main as ref_main
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.ops import affine_dp as ref_affine_dp
from pav_tpu.ops import chain_scan as ref_chain_scan
from pav_tpu.ops import kde as ref_kde
from pav_tpu_torch import asmstat, entry
from pav_tpu_torch import eval as port_eval
from pav_tpu_torch import seqcodec
from pav_tpu_torch.__main__ import main as port_main
from pav_tpu_torch.io.fasta import SeqStore, write_fasta
from pav_tpu_torch.ops import dp_kernels

from helpers import random_seq
from test_torch_ladder import BAND_CASES, _padded, skill_genome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SC = (1, -5, 5, 56, 4, 1)


# ------------------------------------------------------------------ entry

def test_entry_matches_graft_entry():
    """The example arrays are __graft_entry__'s, and fn's score, tape and
    offsets equal the jitted JAX fn's bit for bit; the band is real
    (offsets 0-8 of 73 columns)."""
    fn, args = entry.entry(device='cpu')
    jfn, jargs = graft.entry()
    for a, b in zip(args, jargs):
        assert a.device.type == 'cpu'
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = jax.jit(jfn)(*jargs)
    assert [tuple(t.shape) for t in got] == [(4, 65), (4, 64, 65), (4, 64)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].min()) == 0 and int(got[2].max()) == 8


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device resolves')
    with pytest.raises(RuntimeError, match='cuda'):
        entry.entry()
    with pytest.raises(RuntimeError, match='cuda'):
        entry.dryrun_multichip(2)


# --------------------------------------------------- the row band's score

def _band_score_cases():
    """(arrays, max_m, width): the dry run's 16 x 32 x 32 at width 33, the
    band exit of test_torch_ladder.py, and the CPU ladder's 256 x 256 class
    at width 33 with ragged items."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, (16, 32)).astype(np.int8)
    r = rng.integers(0, 4, (16, 32)).astype(np.int8)
    lens = np.full(16, 32, dtype=np.int32)
    q2, r2, mm, nn, w = BAND_CASES['band exit']
    return {'dry run': ((q, r, lens, lens.copy()), 32, 33),
            'band exit': (_padded(q2, r2, mm, nn), mm, w),
            'cpu class 256': (_padded(random_seq(250, rng), random_seq(256, rng), 256, 256,
                                      B=8, seed=5), 256, 33)}


BAND_SCORE_CASES = _band_score_cases()


@pytest.mark.parametrize('case', sorted(BAND_SCORE_CASES))
def test_align_band_score_matches_align_batch(case):
    arrays, max_m, width = BAND_SCORE_CASES[case]
    want = ref_affine_dp._align_batch(*arrays, max_m, width, *SC)
    t = [torch.from_numpy(a) for a in arrays]
    got = dp_kernels.align_band_ref(*t, width, SC, with_score=True)
    assert got[0].shape == (arrays[0].shape[0], width)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(dp_kernels.align_band(*t, width, SC), got):
        assert torch.equal(g, w)
    # Row max_m is masked: all NEG for an item shorter than the class.
    short = arrays[2] < max_m
    assert (got[0][torch.from_numpy(short)] == dp_kernels.NEG).all()
    assert (got[0][torch.from_numpy(~short)].max(dim=1).values > dp_kernels.NEG).all()


# --------------------------------------------------------------- dry run

@pytest.fixture(scope='module')
def dryrun():
    return entry.dryrun_multichip(8, device='cpu')


def _dry_inputs():
    """The draws of the dry run's device step (seed 1) and of its density
    regions, as __graft_entry__.dryrun_multichip makes them."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, (16, 32)).astype(np.int8)
    r = rng.integers(0, 4, (16, 32)).astype(np.int8)
    lens = np.full(16, 32, dtype=np.int32)
    hist = rng.integers(0, 2, (16, 256)).astype(np.float32)
    kern = np.tile(np.exp(-0.5 * np.linspace(-3, 3, 31) ** 2).astype(np.float32), (16, 1))
    regions = [rng.integers(0, 3, 800).astype(np.int8) for _ in range(8)]
    return q, r, lens, hist, kern, regions


def test_dryrun_device_step_matches_jax(dryrun):
    q, r, lens, hist, kern, _ = _dry_inputs()
    score, tb, offs = ref_affine_dp._align_batch(q, r, lens, lens, 32, 33, *SC)
    dens = np.asarray(ref_kde._conv_batch(jnp.asarray(hist), jnp.asarray(kern), 512))
    for name, want in (('score', score), ('tb', tb), ('offs', offs)):
        assert np.array_equal(dryrun[name].numpy(), np.asarray(want)), name
    np.testing.assert_allclose(dryrun['dens'].numpy(), dens, rtol=1e-5, atol=1e-5)
    total = float(jnp.sum(jnp.asarray(score).astype(jnp.float32)) + jnp.sum(dens))
    assert dryrun['total'] == pytest.approx(total, rel=1e-5)


def test_dryrun_aligner_and_chains_match_jax(dryrun):
    """The sharded aligner's CIGARs are the reference aligner's; the chain
    scans equal pav_tpu's chain_scores and chain_scores_batch."""
    rng0 = np.random.default_rng(3)
    pairs = []
    for _ in range(16):
        qq = rng0.integers(0, 4, 24).astype(np.uint8)
        pairs.append((qq, qq.copy()))
    want = ref_affine_dp.BandedAligner().align_batch(pairs, width=33, pad_to=32)
    for (gl, go), (wl, wo) in zip(dryrun['cigars'], want):
        assert np.array_equal(gl, wl) and np.array_equal(go, wo)
    qpos = np.arange(64, dtype=np.int32) * 7
    f, parents = ref_chain_scan.chain_scores(qpos, qpos.copy(), np.zeros(64), k=19)
    assert np.array_equal(dryrun['chain'][0], f)
    assert np.array_equal(dryrun['chain'][1], parents)
    slabs = [(qpos.astype(np.int64), qpos.astype(np.int64) + 3,
              np.zeros(64, dtype=np.int64)) for _ in range(8)]
    for (gf, gp), (wf, wp) in zip(dryrun['chain_batch'],
                                  ref_chain_scan.chain_scores_batch(slabs, 19)):
        assert np.array_equal(gf, wf) and np.array_equal(gp, wp)


def test_dryrun_states_match_jax(dryrun):
    """The batched density's states equal pav_tpu's smoothed_states_batch on
    the same regions wherever the reference's top two densities differ by
    more than 1e-4 relative (test_torch_kde_batch.py's decision level)."""
    regions = _dry_inputs()[5]
    for got, want in zip(dryrun['regions'], regions):
        assert np.array_equal(got, want)
    sigmas = [ref_kde.scott_sigmas(x, 0.25) for x in regions]
    want = ref_kde.smoothed_states_batch(regions, sigmas, mesh=None)
    n_pad = ref_kde._next_pow2(800)
    batch = np.full((8, n_pad), -1, dtype=np.int8)
    batch[:, :800] = np.stack(regions)
    sig = np.asarray(sigmas, dtype=np.float32)
    _, ref_dens = ref_kde._density_state_kernel_batch(
        jnp.asarray(batch), jnp.asarray(sig), n_pad, 3)
    ref_dens = np.asarray(ref_dens)
    assert len(dryrun['states']) == len(want) == 8
    decided_total = 0
    for i, (g, w) in enumerate(zip(dryrun['states'], want)):
        assert g.dtype == np.int8 and g.shape == w.shape == (800,)
        top2 = np.sort(ref_dens[i, :, :800], axis=0)[-2:]
        decided = (top2[1] - top2[0]) > 1e-4 * np.maximum(np.abs(top2[1]), 1e-30)
        decided_total += decided.mean()
        assert np.array_equal(g[decided], w[decided])
    assert decided_total / 8 > 0.99


def test_dryrun_sharded_pipeline_matches_unsharded(dryrun):
    for key in (('svindel_ins', 'pass'), ('svindel_del', 'pass')):
        a, b = dryrun['merged_mesh'][key], dryrun['merged_single'][key]
        assert a.shape[0] == b.shape[0] >= 1
        assert list(a['ID']) == list(b['ID'])
    assert set(dryrun['merged_mesh']) == set(dryrun['merged_single'])
    for key, df in dryrun['merged_single'].items():
        pd.testing.assert_frame_equal(dryrun['merged_mesh'][key], df, obj=str(key))


# ------------------------------------------------------- asmstat and eval

def test_asmstat_matches_reference():
    rng = np.random.default_rng(5)
    lengths = [100, 300, 50, 1200, 7, 640]
    seqs = {f't{i}': random_seq(n, rng) for i, n in enumerate(lengths)}
    for genome_size in (None, 5000):
        want = ref_asmstat.asm_stats(RefSeqStore(seqs), genome_size)
        got = asmstat.asm_stats(SeqStore(seqs), genome_size)
        pd.testing.assert_series_equal(got, want)
    for lens, gs in (([], None), ([5], None), (lengths, 10 ** 6), (lengths, 900)):
        assert asmstat.n50(lens, gs) == ref_asmstat.n50(lens, gs)


def _write_vcf(path, rows):
    with gzip.open(path, 'wt') as fh:
        fh.write('##fileformat=VCFv4.2\n')
        fh.write('#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n')
        for r in rows:
            fh.write('\t'.join(str(v) for v in r) + '\n')


def _graft_eval_vcfs(tmp_path):
    """test_graft_eval.py's two callsets."""
    a = str(tmp_path / 'a.vcf.gz')
    b = str(tmp_path / 'b.vcf.gz')
    _write_vcf(a, [
        ('c1', 101, 's1', 'A', 'G', '.', 'PASS', 'SVTYPE=SNV', 'GT', '1|0'),
        ('c1', 5001, 'i1', 'A', 'A' + 'T' * 100, '.', 'PASS', 'SVTYPE=INS;SVLEN=100', 'GT', '1|0'),
        ('c1', 9001, 'd1', 'A' + 'C' * 60, 'A', '.', 'PASS', 'SVTYPE=DEL;SVLEN=-60', 'GT', '1|0'),
    ])
    _write_vcf(b, [
        ('c1', 101, 'x1', 'A', 'G', '.', 'PASS', 'SVTYPE=SNV', 'GT', '1|0'),
        ('c1', 5020, 'x2', 'A', 'A' + 'T' * 98, '.', 'PASS', 'SVTYPE=INS;SVLEN=98', 'GT', '1|0'),
        ('c1', 20000, 'x3', 'A', 'C', '.', 'PASS', 'SVTYPE=SNV', 'GT', '1|0'),
    ])
    return a, b


def _assert_concordance_equal(a, b):
    for pass_only in (True, False):
        for x, y in ((a, b), (b, a), (a, a)):
            want = ref_eval.concordance(x, y, pass_only=pass_only)
            got = port_eval.concordance(x, y, pass_only=pass_only)
            pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(port_eval.read_vcf(a), ref_eval.read_vcf(a))


def test_eval_matches_reference_on_graft_vcfs(tmp_path):
    a, b = _graft_eval_vcfs(tmp_path)
    _assert_concordance_equal(a, b)
    rep = port_eval.concordance(a, b).set_index('SVTYPE')
    assert rep.loc['SNV', 'PRECISION'] == 0.5 and rep.loc['INS', 'RECALL'] == 1.0


def test_eval_matches_reference_on_verify_sample(tmp_path):
    """The verify recipe's sample through both CLIs on the CPU: the port's
    concordance report equals the reference's on the two VCFs, both ways,
    and on a truth VCF of the planted variants."""
    ref, h1, h2 = skill_genome()
    write_fasta({'chr1': seqcodec.decode(ref)}, str(tmp_path / 'ref.fa'))
    write_fasta({'tig1': seqcodec.decode(h1)}, str(tmp_path / 'h1.fa'))
    write_fasta({'tig2': seqcodec.decode(h2)}, str(tmp_path / 'h2.fa'))
    (tmp_path / 'asm.tsv').write_text(
        f'NAME\tHAP_h1\tHAP_h2\nS1\t{tmp_path / "h1.fa"}\t{tmp_path / "h2.fa"}\n')
    common = ['--ref', str(tmp_path / 'ref.fa'), '--assemblies', str(tmp_path / 'asm.tsv')]
    assert ref_main(common + ['--run-dir', str(tmp_path / 'ref')]) == 0
    assert port_main(common + ['--run-dir', str(tmp_path / 'port'), '--device', 'cpu']) == 0
    ref_vcf = str(tmp_path / 'ref' / 'S1.vcf.gz')
    port_vcf = str(tmp_path / 'port' / 'S1.vcf.gz')
    truth = str(tmp_path / 'truth.vcf.gz')
    _write_vcf(truth, [
        ('chr1', 5001, 't1', 'A', 'G', '.', 'PASS', 'SVTYPE=SNV', 'GT', '1|1'),
        ('chr1', 50000, 't2', 'A' + 'C' * 300, 'A', '.', 'PASS', 'SVTYPE=DEL;SVLEN=-300',
         'GT', '1|1'),
        ('chr1', 120001, 't3', 'A', 'C', '.', 'PASS', 'SVTYPE=SNV', 'GT', '1|1'),
    ])
    _assert_concordance_equal(port_vcf, ref_vcf)
    _assert_concordance_equal(truth, port_vcf)
    rep = port_eval.concordance(port_vcf, ref_vcf).set_index('SVTYPE')
    assert rep.loc['SNV', 'RECALL'] == 1.0 and rep.loc['DEL', 'RECALL'] == 1.0
    want = ref_asmstat.asm_stats(RefSeqStore({'tig1': h1, 'tig2': h2}), len(ref))
    got = asmstat.asm_stats(SeqStore({'tig1': h1, 'tig2': h2}), len(ref))
    pd.testing.assert_series_equal(got, want)

    # The two eval CLIs print the same report.
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    outs = [subprocess.run([sys.executable, '-m', mod, port_vcf, ref_vcf],
                           capture_output=True, text=True, env=env, timeout=300)
            for mod in ('pav_tpu.eval', 'pav_tpu_torch.eval')]
    assert outs[0].returncode == 0 and outs[1].returncode == 0, outs[1].stderr
    assert outs[1].stdout == outs[0].stdout
    assert 'RECALL' in outs[1].stdout
