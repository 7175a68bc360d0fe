"""The port's thread pools, each task timed into the host spans.

``Executor(name, max_workers, task_span=None)`` has the part of
``ThreadPoolExecutor``'s interface the port uses (``submit``, ``map``, the
``with`` block). A task runs in a copy of the submitting thread's span
context (``spans``): its spans belong to the submitter's sample and name the
submitter's open span as their parent. Each task's queue wait (submit to
start) and run are recorded. With ``task_span``, each task is a span of that
name whose WAIT_NS is its wait. Otherwise each use of the pool (a ``with``
block, or one ``map`` outside a block) is one row, ``pool:<name>``, that sums
its tasks (``spans.PoolUse``), so the rows do not grow with the tasks. A pool
of one worker runs its tasks in the caller. ``map(..., caller_runs=True)``
hands the pool only as many tasks as it has idle workers, at most all but
the last, and runs the rest in the caller (with no queue wait), so a
caller never waits behind other callers' tasks for work it can do itself.

``inline()`` runs every pool's tasks in the calling thread while its block
runs: the results are the same, without the overlap of the tasks. Tests use
it to run a sample in one thread; a profiled run keeps its threads (the
profiler records them all: ``pipeline.run``).
"""

import contextlib
import contextvars
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .. import spans

_DEPTH = 0
_LOCK = threading.Lock()


@contextlib.contextmanager
def inline():
    """Run every pool's tasks in the calling thread while the block runs."""
    global _DEPTH
    with _LOCK:
        _DEPTH += 1
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH -= 1


def inlined():
    return _DEPTH > 0


class Executor:
    """A named pool of ``max_workers`` threads, started on its first task
    (see the module docstring)."""

    def __init__(self, name, max_workers, task_span=None):
        self.name = name
        self.task_span = task_span
        self._workers = max_workers
        self._pool = None
        self._use = None
        self._lock = threading.Lock()
        self._busy = 0      # tasks submitted to the threads and not yet done

    def __enter__(self):
        self._use = spans.PoolUse('pool:' + self.name)
        return self

    def __exit__(self, *exc):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._use.close()
        self._use = None
        return False

    def submit(self, fn, *args, **kwargs):
        return self._submit(self._use, fn, args, kwargs)

    def map(self, fn, *iterables, caller_runs=False):
        """The results of ``fn`` over the arguments, in order, once all are
        done (the first failure is raised, and the tasks not started are
        cancelled). ``caller_runs``: see the module docstring."""
        use = self._use or spans.PoolUse('pool:' + self.name)
        calls = list(zip(*iterables))
        n_pool = len(calls)
        if caller_runs:
            with self._lock:
                n_pool = max(0, min(len(calls) - 1, self._workers - self._busy))
        futures = [self._submit(use, fn, args, {}) for args in calls[:n_pool]]
        try:
            mine = [self._run(use, None, fn, args, {}) for args in calls[n_pool:]]
            return iter([f.result() for f in futures] + mine)
        except BaseException:
            for f in futures:
                f.cancel()
            raise
        finally:
            if use is not self._use:
                use.close()

    def _submit(self, use, fn, args, kwargs):
        call = (contextvars.copy_context().run, self._run, use, time.time_ns(),
                fn, args, kwargs)
        if self._workers > 1 and not inlined():
            with self._lock:
                self._busy += 1
            fut = self._executor().submit(*call)
            fut.add_done_callback(self._done)
            return fut
        fut = Future()
        try:
            fut.set_result(call[0](*call[1:]))
        except BaseException as ex:   # delivered by fut.result(), as a pool does
            fut.set_exception(ex)
        return fut

    def _executor(self):
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                                thread_name_prefix=f'pav-{self.name}')
            return self._pool

    def _done(self, _fut):
        with self._lock:
            self._busy -= 1

    def _run(self, use, submitted_ns, fn, args, kwargs):
        """Run one task, its queue wait the time since ``submitted_ns`` (none
        for a task the caller runs itself: ``submitted_ns`` None)."""
        wait_ns = 0 if submitted_ns is None else time.time_ns() - submitted_ns
        if self.task_span is not None:
            with spans.span(self.task_span, wait_ns=wait_ns):
                return fn(*args, **kwargs)
        if use is None:
            return fn(*args, **kwargs)
        return use.task(wait_ns, fn, args, kwargs)


def start_thread(target, args=()):
    """Start ``target(*args)`` on a daemon thread, in a copy of this
    thread's span context, and return an object whose ``join()`` waits for
    it; under ``inline()`` it runs at once and ``join`` returns."""
    run = contextvars.copy_context().run
    if inlined():
        run(target, *args)
        return _Done()
    thread = threading.Thread(target=run, args=(target, *args), daemon=True)
    thread.start()
    return thread


class _Done:
    """A thread that has already finished."""

    def join(self):
        pass
