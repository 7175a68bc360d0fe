"""Host spans: the one recorder of the port's host timings.

``span(name, **counts)`` times a block. It opens
``torch.profiler.record_function(name)`` while a profiler runs, so a
profiler that records the thread shows the block, and, while a ``Recorder``
is active, appends one
``Span`` to the recorder's list under its lock. A span holds its name, the
sample label it belongs to (``<sample>`` or ``<sample>/<hap>``, empty for the
run's own spans), its parent (the innermost span open in the thread; for a
pool task, the span of the thread that submitted it: ``parallel.pools``
carries the context over), the thread, its start and end on
``time.time_ns()`` (the profiler's clock), the thread's CPU time, its minor
and major faults and involuntary switches over the block
(``getrusage(RUSAGE_THREAD)``), and the counts its caller gives (integers,
or a word such as the device a step ran on).

Nothing is written while the program runs: ``Pipeline`` writes a sample's
spans to ``<run_dir>/<sample>/spans.tsv`` (``write_tsv``), one row a span
under ``COLUMNS``. A pool's row (``PoolUse``) sums its tasks: TASKS,
THREADS, RUN_NS, WAIT_NS and MAX_WAIT_NS, with CPU_NS and the fault and
switch counts of its tasks' threads; a timed task of a pool is a span whose
WAIT_NS is its queue wait. For any other span TASKS and THREADS are 0 and
RUN_NS is its own duration.
"""

import contextlib
import contextvars
import itertools
import resource
import threading
import time

import torch

COLUMNS = ('ID', 'PARENT', 'LABEL', 'NAME', 'TID', 'START_NS', 'END_NS', 'CPU_NS',
           'MINFLT', 'MAJFLT', 'NIVCSW', 'TASKS', 'THREADS', 'RUN_NS', 'WAIT_NS',
           'MAX_WAIT_NS', 'COUNTS')

# (recorder or None, label, innermost open Span or None) of this context.
_CTX = contextvars.ContextVar('pav_tpu_torch_span', default=(None, '', None))
_IDS = itertools.count(1)


class Span:
    """One timed block (or, with ``tasks``, one use of a pool)."""

    __slots__ = ('id', 'parent', 'label', 'name', 'tid', 'start_ns', 'end_ns', 'cpu_ns',
                 'minflt', 'majflt', 'nivcsw', 'tasks', 'threads', 'run_ns', 'wait_ns',
                 'max_wait_ns', 'counts', '_cpu0', '_ru0')

    def __init__(self, name, label, parent, counts):
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else 0
        self.label = label
        self.name = name
        self.tid = threading.get_native_id()
        self.counts = counts
        self.cpu_ns = self.minflt = self.majflt = self.nivcsw = 0
        self.tasks = self.threads = self.run_ns = self.wait_ns = self.max_wait_ns = 0
        self.start_ns = self.end_ns = 0

    def begin(self):
        self._ru0 = resource.getrusage(resource.RUSAGE_THREAD)
        self._cpu0 = time.thread_time_ns()
        self.start_ns = time.time_ns()

    def finish(self):
        self.end_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self._cpu0
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        self.minflt = ru.ru_minflt - self._ru0.ru_minflt
        self.majflt = ru.ru_majflt - self._ru0.ru_majflt
        self.nivcsw = ru.ru_nivcsw - self._ru0.ru_nivcsw
        self.run_ns = self.end_ns - self.start_ns

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def row(self):
        counts = ','.join(f'{k}={v if isinstance(v, str) else int(v)}'
                          for k, v in self.counts.items())
        return (self.id, self.parent, self.label, self.name, self.tid, self.start_ns,
                self.end_ns, self.cpu_ns, self.minflt, self.majflt, self.nivcsw, self.tasks,
                self.threads, self.run_ns, self.wait_ns, self.max_wait_ns, counts)


class Recorder:
    """The spans of one ``Pipeline``, in memory."""

    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def append(self, span):
        with self._lock:
            self.records.append(span)

    @contextlib.contextmanager
    def active(self):
        """Record the spans of this thread, and of the pool tasks it starts,
        while the block runs."""
        token = _CTX.set((self, '', None))
        try:
            yield self
        finally:
            _CTX.reset(token)

    def sample(self, name):
        """The spans of sample ``name`` and the run's own, in start order."""
        with self._lock:
            out = [s for s in self.records
                   if s.label in ('', name) or s.label.startswith(name + '/')]
        return sorted(out, key=lambda s: s.start_ns)


class span:
    """Time the block as span ``name`` (see the module docstring). ``label``
    sets the sample label of this span and its children (default: the
    parent's); ``wait_ns`` is a pool task's queue wait. ``with`` yields the
    Span, whose ``counts`` the block may add to. The ``record_function`` is
    opened only while a profiler runs: it costs more than the rest of the
    span and records nothing otherwise."""

    __slots__ = ('_span', '_rec', '_token', '_annotation')

    def __init__(self, name, label=None, wait_ns=0, **counts):
        rec, outer, parent = _CTX.get()
        self._rec = rec
        self._span = Span(name, outer if label is None else label, parent, counts)
        self._span.wait_ns = self._span.max_wait_ns = wait_ns
        self._annotation = None

    def __enter__(self):
        s = self._span
        self._token = _CTX.set((self._rec, s.label, s))
        # The clock first: the annotation's own start is then the next thing
        # stamped, with no system call or first-use work of its own between.
        s.begin()
        if torch.autograd.profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(s.name)
            self._annotation.__enter__()
        return s

    def __exit__(self, *exc):
        self._span.finish()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _CTX.reset(self._token)
        if self._rec is not None:
            self._rec.append(self._span)
        return False


def add(**counts):
    """Add to the counts of this thread's innermost open span (a string
    value, such as ``on=cuda``, is set)."""
    s = _CTX.get()[2]
    if s is not None:
        for k, v in counts.items():
            s.counts[k] = v if isinstance(v, str) else s.counts.get(k, 0) + v


class PoolUse:
    """One use of a pool (a ``with`` block or one ``map``): its tasks'
    waits and runs, summed into one row when it closes."""

    def __init__(self, name):
        rec, label, parent = _CTX.get()
        self._rec = rec
        self._lock = threading.Lock()
        self._tids = set()
        self.row = Span(name, label, parent, {})
        self.row.start_ns = time.time_ns()

    def task(self, wait_ns, fn, args, kwargs):
        """Run one task on this thread, timed into the row."""
        meter = Span(self.row.name, self.row.label, None, {})
        meter.begin()
        try:
            return fn(*args, **kwargs)
        finally:
            meter.finish()
            r = self.row
            with self._lock:
                self._tids.add(meter.tid)
                r.tasks += 1
                r.run_ns += meter.run_ns
                r.wait_ns += wait_ns
                r.max_wait_ns = max(r.max_wait_ns, wait_ns)
                r.cpu_ns += meter.cpu_ns
                r.minflt += meter.minflt
                r.majflt += meter.majflt
                r.nivcsw += meter.nivcsw

    def close(self):
        self.row.end_ns = time.time_ns()
        self.row.threads = len(self._tids)
        if self._rec is not None and self.row.tasks:
            self._rec.append(self.row)


def write_tsv(records, path):
    """``records`` as ``spans.tsv``: a header of ``COLUMNS``, one row each."""
    with open(path, 'w') as fh:
        fh.write('\t'.join(COLUMNS) + '\n')
        for s in records:
            fh.write('\t'.join(str(v) for v in s.row()) + '\n')


def seconds_by_name(records):
    """{name: seconds summed over the spans of that name} (pool rows: their
    tasks' run time), largest first."""
    out = {}
    for s in records:
        out[s.name] = out.get(s.name, 0.0) + s.run_ns / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
