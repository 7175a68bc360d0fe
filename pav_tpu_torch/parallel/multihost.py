"""Cohort runs: share-nothing sample fan-out across processes, coordinated
through a ``torch.distributed.TCPStore`` (port of pav_tpu.parallel.multihost).

Each process owns a deterministic round-robin shard of the sample table and
runs the full engine on its own device (``--device``; one ``cuda:<i>`` per
process on a multi-GPU host). Process 0 hosts the key-value store; the
others connect to it as clients. The store carries artifact exchange,
manifests and fences under the ``pav/`` key namespace, as the reference's
jax.distributed key-value service does.

Failure semantics follow the reference's keep-going default: one failed
sample, or one member that dies, does not abort the cohort. A failed sample
is recorded in the manifest with an ``error`` field; a member that never
publishes its shard is marked ``unreachable`` after a bounded wait
(``PAV_COHORT_TIMEOUT_S`` / ``timeout_s``, one shared deadline per fence or
gather), and the survivors still return the full manifest. Process 0 stays
fatal: it hosts the store. The store never waits for its members
(``wait_for_workers=False``), so a member that dies before connecting does
not stall the leader either.

Artifacts: each VCF is written on the disk of the process that ran its
sample; ``ship_artifacts=True`` also publishes its bytes (base64, 1 MiB
chunks) so every process materializes the whole cohort's VCFs.
"""

import base64
import datetime
import json
import os
import time

import torch.distributed as dist

_RAISE = object()

# Store values travel as base64 text in bounded chunks, so a large VCF never
# becomes a single huge value.
_CHUNK = 1 << 20


def _timeout(timeout_s):
    if timeout_s is None:
        return float(os.environ.get('PAV_COHORT_TIMEOUT_S', 600))
    return float(timeout_s)


def init(coordinator, num_processes, process_id, timeout_s=None):
    """Join the cohort's key-value store; process 0 hosts it.

    :param coordinator: 'host:port' of process 0.
    :param timeout_s: default bound of every wait, connecting included (see
        :class:`Cohort`).
    """
    host, _, port = str(coordinator).rpartition(':')
    if not host or not port.isdigit():
        raise ValueError(f'coordinator must be host:port, got {coordinator!r}')
    timeout_s = _timeout(timeout_s)
    store = dist.TCPStore(
        host, int(port), int(num_processes), is_master=int(process_id) == 0,
        timeout=datetime.timedelta(seconds=timeout_s), wait_for_workers=False)
    return Cohort(store, num_processes, process_id, timeout_s)


def shard_samples(sample_names, process_id, num_processes):
    """Deterministic round-robin shard of the sample table (one job per
    sample, as the reference's cluster fan-out runs them)."""
    return [s for i, s in enumerate(sorted(sample_names))
            if i % num_processes == process_id]


class Cohort:
    """Cross-process coordination for a sharded cohort run.

    :param store: a ``torch.distributed.Store`` shared by the cohort.
    :param timeout_s: default bound of every blocking wait (barriers,
        fetches, fences). ``None`` reads ``PAV_COHORT_TIMEOUT_S`` (default
        600 s). Per-call ``timeout_s`` arguments override it.
    """

    def __init__(self, store, num_processes, process_id, timeout_s=None):
        self.store = store
        self.num_processes = int(num_processes)
        self.process_id = int(process_id)
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f'process id {process_id} outside 0..{num_processes - 1}')
        self.timeout_s = _timeout(timeout_s)

    def _wait(self, key, timeout_s):
        """Block until ``key`` exists; raises DistStoreError on timeout."""
        secs = self.timeout_s if timeout_s is None else float(timeout_s)
        self.store.wait([key], datetime.timedelta(seconds=secs))

    # -------------------------------------------------------------- barriers

    def barrier(self, name, timeout_s=None):
        """All processes wait at a named fence (stage edge). Raises on
        timeout; use :meth:`fence` when dead members must be tolerated."""
        key = f'pav/barrier/{name}'
        if self.store.add(key, 1) == self.num_processes:
            self.store.set(f'{key}/done', '1')
        self._wait(f'{key}/done', timeout_s)

    def fence(self, name, timeout_s=None):
        """Dead-member-tolerant barrier: publish arrival, then wait for each
        peer up to one shared deadline. Returns the set of process ids that
        arrived; a member that died before the fence is simply absent."""
        self.publish(f'fence/{name}/{self.process_id}', True)
        arrived = set()
        # One shared deadline: k dead members cost one timeout, not k; a
        # fetch of a published key returns at once.
        deadline = time.time() + (self.timeout_s if timeout_s is None
                                  else float(timeout_s))
        for p in range(self.num_processes):
            left = max(0.05, deadline - time.time())
            if self.fetch(f'fence/{name}/{p}', left, default=None) is not None:
                arrived.add(p)
        return arrived

    # ------------------------------------------------------------- exchange

    def publish(self, key, obj):
        """Publish a JSON-serializable object under a namespaced key."""
        self.store.set(f'pav/{key}', json.dumps(obj))

    def fetch(self, key, timeout_s=None, default=_RAISE):
        """Blocking fetch of a published object. With ``default``, a timeout
        (publisher dead or late) returns it instead of raising."""
        try:
            self._wait(f'pav/{key}', timeout_s)
        except dist.DistStoreError:
            if default is _RAISE:
                raise
            return default
        return json.loads(self.store.get(f'pav/{key}'))

    def publish_bytes(self, key, data):
        """Publish an artifact's bytes (chunked base64): the transport for
        run outputs when the processes share no filesystem."""
        b64 = base64.b64encode(bytes(data)).decode('ascii')
        chunks = [b64[i:i + _CHUNK] for i in range(0, len(b64), _CHUNK)] or ['']
        for i, chunk in enumerate(chunks):
            self.store.set(f'pav/bytes/{key}/{i}', chunk)
        self.publish(f'bytes/{key}/n', len(chunks))

    def fetch_bytes(self, key, timeout_s=None, default=_RAISE):
        """Fetch bytes published with :meth:`publish_bytes`."""
        n = self.fetch(f'bytes/{key}/n', timeout_s, default=None)
        if n is None:
            if default is _RAISE:
                raise TimeoutError(f'artifact bytes never published: {key}')
            return default
        parts = [self.store.get(f'pav/bytes/{key}/{i}').decode('ascii')
                 for i in range(n)]
        return base64.b64decode(''.join(parts))

    def allgather_obj(self, name, obj, timeout_s=None, tolerate_missing=False):
        """Gather one JSON-serializable object per process, ordered by
        process id. With ``tolerate_missing``, a process that never publishes
        yields ``None`` in its slot after the (shared) timeout instead of
        aborting the gather."""
        self.publish(f'{name}/{self.process_id}', obj)
        if not tolerate_missing:
            return [self.fetch(f'{name}/{p}', timeout_s)
                    for p in range(self.num_processes)]
        deadline = time.time() + (self.timeout_s if timeout_s is None
                                  else float(timeout_s))
        return [self.fetch(f'{name}/{p}', max(0.05, deadline - time.time()),
                           default=None)
                for p in range(self.num_processes)]


def gather_manifest(cohort, local, all_samples, run_dir=None, log=None,
                    keep_going=True, ship_artifacts=False):
    """Gather per-process manifests into the cohort manifest, tolerating
    failed samples and dead members (keep-going semantics).

    :param local: this process's {sample: entry} manifest shard. Entries for
        failed samples carry an ``error`` key.
    :param all_samples: the full cohort sample list, to attribute samples
        owned by an unreachable process.
    :param ship_artifacts: fetch VCF bytes published by other processes and
        write them under ``run_dir``.
    :return: manifest for every sample; unreachable processes' samples are
        marked ``{'error': 'process unreachable', ...}``.
    """
    shards = cohort.allgather_obj('cohort_manifest', local,
                                  tolerate_missing=keep_going)
    manifest = {}
    for pid, shard in enumerate(shards):
        if shard is None:
            if log:
                log(f'[cohort] process {pid} unreachable; marking its '
                    f'samples failed (keep-going)')
            for s in shard_samples(all_samples, pid, cohort.num_processes):
                manifest[s] = {'error': 'process unreachable', 'process': pid}
            continue
        manifest.update(shard)

    if ship_artifacts and run_dir is not None:
        for sample, entry in manifest.items():
            if entry.get('error') or entry.get('process') == cohort.process_id:
                continue
            data = cohort.fetch_bytes(f'vcf/{sample}', default=None)
            if data is None:
                entry['error'] = 'artifact bytes unavailable'
                continue
            path = os.path.join(run_dir, f'{sample}.vcf.gz')
            os.makedirs(run_dir, exist_ok=True)
            with open(path, 'wb') as fh:
                fh.write(data)
            entry['vcf'] = path

    # End-of-run fence; the tolerant one never deadlocks on a dead member.
    if keep_going:
        cohort.fence('cohort_done')
    else:
        cohort.barrier('cohort_done')
    return manifest


def finalize(cohort, manifest=None):
    """Ordered teardown. Members publish a goodbye and drop their client;
    the leader, which hosts the store, waits for the goodbye of every member
    the manifest does not record as unreachable before it closes the store,
    so no member loses the store while it still reads from it."""
    if cohort.process_id != 0:
        cohort.publish(f'bye/{cohort.process_id}', True)
        cohort.store = None
        return
    unreachable = set()
    if manifest:
        unreachable = {e.get('process') for e in manifest.values()
                       if e.get('error') == 'process unreachable'}
    for p in range(1, cohort.num_processes):
        if p not in unreachable:
            cohort.fetch(f'bye/{p}', default=None)
    cohort.store = None


def run_cohort(cohort, ref_store, assemblies, run_dir, config=None, log=None,
               keep_going=True, ship_artifacts=False, device=None):
    """Run the engine on this process's sample shard; gather the cohort
    manifest (sample -> VCF path + per-type call counts) on every process.

    :param assemblies: {sample: {hap: SeqStore}} for the WHOLE cohort; each
        process runs only its shard.
    :param keep_going: record per-sample failures (and dead members) in the
        manifest instead of aborting.
    :param device: this process's torch device.
    :return: manifest dict for all samples across all processes.
    """
    from ..pipeline import Pipeline

    mine = shard_samples(list(assemblies), cohort.process_id,
                         cohort.num_processes)
    pipeline = Pipeline(ref_store, config or {}, run_dir=run_dir, log=log,
                        device=device)
    local = {}
    for sample in mine:
        try:
            result = pipeline.run_sample(sample, assemblies[sample])
        except Exception as ex:          # keep-going: independent sample jobs
            if not keep_going:
                raise
            if log:
                log(f'[cohort] sample {sample} failed: {ex!r} (keep-going)')
            local[sample] = {'error': f'{type(ex).__name__}: {ex}',
                             'process': cohort.process_id}
            continue
        counts = {f'{t}_{tier}': int(df.shape[0])
                  for (t, tier), df in result['merged'].items()}
        vcf_path = os.path.join(run_dir, f'{sample}.vcf.gz')
        local[sample] = {
            'vcf': vcf_path,
            'process': cohort.process_id,
            'counts': counts,
        }
        if ship_artifacts and os.path.exists(vcf_path):
            with open(vcf_path, 'rb') as fh:
                cohort.publish_bytes(f'vcf/{sample}', fh.read())
    return gather_manifest(cohort, local, list(assemblies), run_dir=run_dir,
                           log=log, keep_going=keep_going,
                           ship_artifacts=ship_artifacts)
