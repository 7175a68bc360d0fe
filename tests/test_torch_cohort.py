"""Cohort runs of the port: ``python -m pav_tpu_torch --device cpu`` processes
sharing a torch.distributed TCPStore (process 0 hosts it), samples sharded
round-robin, the manifest gathered on every process, keep-going on a dead
member (tests/test_multihost.py is the model).
"""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pav_tpu.io.fasta import SeqStore as RefSeqStore
from pav_tpu.parallel.multihost import shard_samples as ref_shard_samples
from pav_tpu_torch import seqcodec
from pav_tpu_torch.io.fasta import SeqStore
from pav_tpu_torch.parallel import multihost

from helpers import Mutator, random_seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('n_names,n_procs', [(7, 3), (2, 2), (1, 4), (12, 5)])
def test_shard_samples_matches_reference(n_names, n_procs):
    names = [f'S{i}' for i in range(n_names)][::-1]
    shards = [multihost.shard_samples(names, p, n_procs) for p in range(n_procs)]
    assert shards == [ref_shard_samples(names, p, n_procs) for p in range(n_procs)]
    assert sorted(sum(shards, [])) == sorted(names)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_cohort_store_exchange_in_one_process():
    """A one-member cohort on its own store: publish/fetch, chunked bytes,
    gather, fences and a timed-out fetch with and without a default."""
    cohort = multihost.init(f'localhost:{_free_port()}', 1, 0, timeout_s=5)
    cohort.publish('x', {'a': [1, 2]})
    assert cohort.fetch('x') == {'a': [1, 2]}
    data = bytes(range(256)) * 5000            # > 1 MiB of base64: 2 chunks
    cohort.publish_bytes('blob', data)
    assert cohort.fetch('bytes/blob/n') == 2
    assert cohort.fetch_bytes('blob') == data
    assert cohort.allgather_obj('g', 7) == [7]
    assert cohort.fence('f') == {0}
    cohort.barrier('b')
    assert cohort.fetch('missing', timeout_s=0.2, default='gone') == 'gone'
    with pytest.raises(TimeoutError):
        cohort.fetch_bytes('missing', timeout_s=0.2)
    with pytest.raises(RuntimeError):
        cohort.fetch('missing', timeout_s=0.2)
    multihost.finalize(cohort, {})
    assert cohort.store is None


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2')
    env.pop('XLA_FLAGS', None)
    return env


def _launch(tmp_path, port, pid, n_procs, run_dir, extra=()):
    return subprocess.Popen(
        [sys.executable, '-m', 'pav_tpu_torch', '--device', 'cpu',
         '--ref', 'ref.fa', '--assemblies', 'asm.tsv', '--run-dir', run_dir,
         '--coordinator', f'localhost:{port}',
         '--num-processes', str(n_procs), '--process-id', str(pid),
         '--set', 'aligner_min_chain_score=500', *extra],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _write_cohort(tmp_path, seed, samples, dele=True):
    """Reference + one diploid sample per (name, snv position); every
    haplotype carries the sample's SNV (and a 120 bp DEL)."""
    rng = np.random.default_rng(seed)
    ref = random_seq(60000, rng)
    (tmp_path / 'ref.fa').write_text('>chr1\n' + seqcodec.decode(ref) + '\n')
    rows = ['NAME\tHAP_h1\tHAP_h2']
    for si, (name, snv_at) in enumerate(samples, start=1):
        for hi in (1, 2):
            mut = Mutator(ref)
            mut.snv(snv_at, rng=np.random.default_rng(10 * si + hi))
            if dele:
                mut.dele(40000, 120)
            (tmp_path / f's{si}h{hi}.fa').write_text(
                f'>tig{si}{hi}\n' + seqcodec.decode(mut.finish()) + '\n')
        rows.append(f'{name}\ts{si}h1.fa\ts{si}h2.fa')
    (tmp_path / 'asm.tsv').write_text('\n'.join(rows) + '\n')


def _positions(vcf):
    with gzip.open(vcf, 'rt') as fh:
        return {int(ln.split('\t')[1]) for ln in fh if not ln.startswith('#')}


def _vcf_records(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh if not line.startswith('##')]


def _assemblies(tmp_path, n_samples, store=SeqStore):
    """The written cohort as run_cohort takes it: {sample: {hap: store}},
    each haplotype read by ``store.from_file`` (the port's SeqStore, or the
    reference's for the reference's run)."""
    names = [ln.split('\t')[0] for ln in
             (tmp_path / 'asm.tsv').read_text().splitlines()[1:]]
    return {name: {f'h{hi}': store.from_file(str(tmp_path / f's{si}h{hi}.fa'))
                   for hi in (1, 2)}
            for si, name in enumerate(names[:n_samples], start=1)}


COHORT2 = (21, [('SampA', 5000), ('SampB', 9000)])


@pytest.fixture(scope='module')
def cohort2_reference(tmp_path_factory):
    """pav_tpu's VCF records of each COHORT2 sample, on its own CPU branch
    (unforced): the ladder ``--device cpu`` takes in the port."""
    from pav_tpu.pipeline import Pipeline as RefPipeline

    d = tmp_path_factory.mktemp('cohort2_ref')
    _write_cohort(d, *COHORT2)
    pipe = RefPipeline(RefSeqStore.from_file(str(d / 'ref.fa')),
                       {'aligner_min_chain_score': 500}, run_dir=str(d / 'run'))
    return {name: _vcf_records(pipe.run_sample(name, haps)['vcf'])
            for name, haps in _assemblies(d, 2, RefSeqStore).items()}


def test_run_cohort_in_process_matches_reference(tmp_path, cohort2_reference):
    """``run_cohort`` on a one-member cohort runs every sample, records its
    VCF and call counts, and writes pav_tpu's VCF records."""
    _write_cohort(tmp_path, *COHORT2)
    cohort = multihost.init(f'localhost:{_free_port()}', 1, 0, timeout_s=30)
    manifest = multihost.run_cohort(
        cohort, SeqStore.from_file(str(tmp_path / 'ref.fa')),
        _assemblies(tmp_path, 2), str(tmp_path / 'run'),
        config={'aligner_min_chain_score': 500}, device='cpu')
    multihost.finalize(cohort, manifest)
    assert sorted(manifest) == ['SampA', 'SampB']
    for name, entry in manifest.items():
        assert entry['process'] == 0 and sum(entry['counts'].values()) > 0
        assert _vcf_records(entry['vcf']) == cohort2_reference[name], name


def test_cohort_two_processes(tmp_path, cohort2_reference):
    """Per-process run dirs + --ship-artifacts: a cohort with no shared
    filesystem; every process ends with every VCF, each holding pav_tpu's
    records for its sample."""
    _write_cohort(tmp_path, *COHORT2)
    port = _free_port()
    procs = [_launch(tmp_path, port, pid, 2, f'run{pid}', ('--ship-artifacts',))
             for pid in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f'rc={p.returncode}\n{out}\n{err}'
        outs.append(out)

    procs_of = {}
    for out in outs:
        assert 'SampA:' in out and 'SampB:' in out
        for line in out.splitlines():
            if line.startswith('Samp'):
                procs_of[line.split(':')[0]] = line.rsplit('process ', 1)[1].rstrip(')')
    assert procs_of == {'SampA': '0', 'SampB': '1'}
    for run_dir in ('run0', 'run1'):
        for sample, pos in (('SampA', 5001), ('SampB', 9001)):
            vcf = tmp_path / run_dir / f'{sample}.vcf.gz'
            assert vcf.exists(), f'{run_dir}/{sample} VCF missing'
            assert pos in _positions(vcf), f'{sample}: planted SNV {pos} not called'
            assert _vcf_records(vcf) == cohort2_reference[sample], f'{run_dir}/{sample}'


def test_cohort_keep_going_dead_member(tmp_path):
    """A member that connects to the store and dies without publishing does
    not abort the others: the survivors mark its sample unreachable, still
    print the full manifest, and exit 1 (a sample failed)."""
    _write_cohort(tmp_path, 31, [('SampA', 5000), ('SampB', 9000), ('SampC', 15000)],
                  dele=False)
    port = _free_port()
    procs = [_launch(tmp_path, port, pid, 3, 'run', ('--cohort-timeout', '20'))
             for pid in (0, 1)]
    dead = subprocess.Popen(
        [sys.executable, '-c',
         'import os; from pav_tpu_torch.parallel.multihost import init; '
         f'init("localhost:{port}", 3, 2, timeout_s=60); os._exit(1)'],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dead.communicate(timeout=120)
    assert dead.returncode == 1
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 1, f'rc={p.returncode}\n{out}\n{err}'
        outs.append(out)
    for out in outs:
        assert 'SampC: ERROR process unreachable' in out, out
        assert 'SampA: run' in out and 'SampB: run' in out
    for sample, pos in (('SampA', 5001), ('SampB', 9001)):
        vcf = tmp_path / 'run' / f'{sample}.vcf.gz'
        assert vcf.exists(), f'{sample} VCF missing'
        assert pos in _positions(vcf), f'{sample}: planted SNV {pos} not called'
