"""The port's mesh-sharded DP (``parallel.mesh``, ``BandedAligner(mesh=...)``,
``mesh_devices``) on 8 logical CPU shards, against its unsharded runs and
the JAX reference (tests/test_mesh_sharding.py is the model).

Sharding splits each padded DP batch into equal row shards; items are
independent, so every CIGAR, alignment table and VCF record must equal the
unsharded run's exactly. The port runs the accelerator ladder
(``ladder='accel'``), the classes of its CUDA path, against the reference
forced onto its accelerator branch.
"""

import gzip

import numpy as np
import pytest
import torch

from pav_tpu.align import cigar as ref_cg
from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.ops import affine_dp as ref_affine_dp
from pav_tpu.parallel import mesh as ref_mesh
from pav_tpu.pipeline import Pipeline as RefPipeline
from pav_tpu_torch.align import cigar as cg
from pav_tpu_torch.align.aligner import Aligner
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.ops import affine_dp
from pav_tpu_torch.parallel import mesh
from pav_tpu_torch.pipeline import Pipeline

from helpers import Mutator, random_seq
from test_torch_pipeline import reference_accel_branch

CPU = torch.device('cpu')


def test_make_mesh_cpu_shards():
    assert mesh.make_mesh(8, 'cpu') == [CPU] * 8
    with pytest.raises(ValueError):
        mesh.make_mesh(0, 'cpu')


def test_make_mesh_cuda_raises_without_the_devices(monkeypatch):
    """The reference stays on one device when the mesh is short of devices;
    the port raises instead of hiding the missing device."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='2 CUDA devices'):
        mesh.make_mesh(2, 'cuda')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert mesh.make_mesh(2, 'cuda') == [torch.device('cuda', 0),
                                          torch.device('cuda', 1)]


def test_shard_batch_and_pad_match_reference_layout():
    arr = np.arange(7 * 3, dtype=np.int32).reshape(7, 3)
    want, n = ref_mesh.pad_to_multiple(arr, 4, fill=-1)
    got, n2 = mesh.pad_to_multiple(arr, 4, fill=-1)
    assert n == n2 == 7 and np.array_equal(got, want)
    parts = mesh.shard_batch(mesh.make_mesh(4, 'cpu'), torch.from_numpy(got))
    assert [p.shape[0] for p in parts] == [2, 2, 2, 2]
    assert np.array_equal(torch.cat(parts).numpy(), want)
    with pytest.raises(ValueError, match='equal shards'):
        mesh.shard_batch(mesh.make_mesh(3, 'cpu'), torch.from_numpy(got))


def _pairs():
    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(64):
        m = int(rng.integers(8, 60))
        q = random_seq(m, rng)
        r = q.copy()
        if m > 12:
            r = np.delete(r, slice(3, 6))
        pairs.append((q, r))
    return pairs


@pytest.mark.parametrize('n_pairs', [64, 61])
def test_sharded_dp_matches_single_device(n_pairs):
    """64 pairs: B_pad divides by 8 and every launch shards; 61 pairs: the
    padding rows land in the last shard and are dropped."""
    pairs = _pairs()[:n_pairs]
    want = [ref_cg.to_string(*x) for x in
            ref_affine_dp.BandedAligner().align_batch(pairs, width=65, pad_to=64)]
    single = affine_dp.BandedAligner(device='cpu')
    sharded = affine_dp.BandedAligner(device='cpu', mesh=mesh.make_mesh(8, 'cpu'))
    affine_dp.stats_reset()
    got_single = [cg.to_string(*x) for x in single.align_batch(pairs, width=65, pad_to=64)]
    assert affine_dp.STATS['sharded_puts'] == 0
    got_sharded = [cg.to_string(*x) for x in sharded.align_batch(pairs, width=65, pad_to=64)]
    assert affine_dp.STATS['sharded_puts'] == 4      # q, r, m, n
    assert affine_dp.STATS['mesh_devices'] == 8
    assert got_single == got_sharded == want


def test_unsharded_when_mesh_does_not_divide_the_batch():
    pairs = _pairs()[:8]
    dp = affine_dp.BandedAligner(device='cpu', mesh=mesh.make_mesh(3, 'cpu'))
    affine_dp.stats_reset()
    got = [cg.to_string(*x) for x in dp.align_batch(pairs, width=65, pad_to=64)]
    assert affine_dp.STATS['sharded_puts'] == 0
    want = [cg.to_string(*x) for x in
            affine_dp.BandedAligner(device='cpu').align_batch(pairs, width=65, pad_to=64)]
    assert got == want


def test_sharded_aligner_end_to_end():
    from pav_tpu_torch.align.table import check_table

    rng = np.random.default_rng(18)
    ref = random_seq(60000, rng)
    contig = ref[5000:55000].copy()
    contig[1000] = (contig[1000] + 1) % 4
    contig = np.concatenate([contig[:20000], random_seq(300, rng), contig[20000:]])
    ref_store = SeqStore({'c': ref})
    qry = SeqStore({'t': contig})
    cfg = {'aligner_min_chain_score': 500}
    plain = Aligner(ref_store, cfg, device='cpu', ladder='accel').align_store(qry, 'h1')
    al = Aligner(ref_store, cfg, device='cpu', ladder='accel')
    al.dp = affine_dp.BandedAligner(al.dp.scoring, device='cpu',
                                    mesh=mesh.make_mesh(8, 'cpu'))
    affine_dp.stats_reset()
    df = al.align_store(qry, 'h1')
    assert affine_dp.STATS['sharded_puts'] > 0
    check_table(df, qry.fai())
    assert df.shape[0] == 1
    assert df.equals(plain)


def _vcf_records(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh if not line.startswith('##')]


def test_pipeline_under_mesh_vcf_identical(tmp_path):
    """mesh_devices=8 on the CPU writes the VCF records of the port's
    unsharded run and of pav_tpu's run (on its accelerator branch, the
    ladder='accel' of the port) on the genome of test_mesh_sharding.py."""
    rng = np.random.default_rng(23)
    ref = random_seq(120000, rng)

    def mk(seed, with_inv):
        r = np.random.default_rng(seed)
        m = Mutator(ref)
        m.snv(8000, rng=r)
        m.ins(20000, random_seq(180, r))
        m.dele(40000, 230)
        m.snv(60000, rng=r)
        if with_inv:
            m.inv(80000, 3500)
        return m.finish()

    tigs = {'h1': ('t1', mk(1, False)), 'h2': ('t2', mk(2, True))}
    haps = {hap: SeqStore(dict([tig])) for hap, tig in tigs.items()}
    cfg = {'aligner_min_chain_score': 500}

    def run(mesh_devices, sub):
        c = dict(cfg, mesh_devices=mesh_devices) if mesh_devices else dict(cfg)
        pipe = Pipeline(SeqStore({'chr1': ref}), c, run_dir=str(tmp_path / sub),
                        device='cpu', ladder='accel')
        return _vcf_records(pipe.run_sample('S', haps)['vcf'])

    ref_haps = {hap: RefSeqStore(dict([tig])) for hap, tig in tigs.items()}
    with reference_accel_branch():
        want = _vcf_records(RefPipeline(RefSeqStore({'chr1': ref}), dict(cfg),
                                        run_dir=str(tmp_path / 'ref'))
                            .run_sample('S', ref_haps)['vcf'])
    single = run(0, 'single')
    affine_dp.stats_reset()
    sharded = run(8, 'mesh')
    assert affine_dp.STATS['mesh_devices'] == 8
    assert len(single) > 6
    assert sharded == single == want


def test_dp_work_splits_across_shards(tmp_path):
    """Under mesh_devices=8 every sharded launch puts 1/8 of its rows on each
    shard, and the accumulated padded cells balance (the checks of
    test_mesh_sharding.py)."""
    rng = np.random.default_rng(29)
    ref = random_seq(150000, rng)
    m = Mutator(ref)
    for pos in range(5000, 140000, 2500):
        m.snv(pos, rng=rng)
        if pos == 60000:
            m.ins(61000, random_seq(200, rng))
        elif pos == 90000:
            m.dele(91000, 250)
    hap = m.finish()

    affine_dp.stats_reset()
    pipe = Pipeline(SeqStore({'chr1': ref}),
                    {'aligner_min_chain_score': 500, 'mesh_devices': 8},
                    run_dir=str(tmp_path / 'mesh8'), device='cpu', ladder='accel')
    assert pipe.mesh == [CPU] * 8
    pipe.run_sample('S', {'h1': SeqStore({'t1': hap})}, write_vcf=False)

    st = affine_dp.STATS
    assert st['sharded_puts'] > 0, 'no DP input was mesh-sharded'
    assert st['mesh_devices'] == 8
    rows = st['shard_rows']
    assert len(rows) == 8
    assert max(rows) - min(rows) <= 1
    assert sum(rows) >= 8
    cells = st['shard_cells']
    assert len(cells) == 8 and min(cells) > 0
    assert max(cells) / min(cells) <= 1.5, f'unbalanced mesh work: {cells}'


def test_pipeline_takes_one_mesh_setting():
    """Pipeline's mesh is named by mesh= (a device may repeat) or counted by
    config mesh_devices, never both: giving both raises."""
    store = SeqStore({'c1': np.zeros(100, dtype=np.uint8)})
    assert Pipeline(store, device='cpu', mesh=['cpu', 'cpu']).mesh == [CPU, CPU]
    assert Pipeline(store, {'mesh_devices': 2}, device='cpu').mesh == [CPU, CPU]
    assert Pipeline(store, device='cpu').mesh is None
    with pytest.raises(ValueError, match='not both'):
        Pipeline(store, {'mesh_devices': 2}, device='cpu', mesh=['cpu', 'cpu'])
