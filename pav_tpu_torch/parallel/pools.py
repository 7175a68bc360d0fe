"""The port's thread pools, and the switch that runs them inline.

``torch.profiler`` records the host ops of the thread that opened it only:
an op run on a pool thread is missing from the trace. While a profile is
open (``inline()``, entered by ``pipeline.run`` with ``profile_dir``), every
pool of the port (haplotypes, inversion regions, merge jobs, contig
planning, sketching, large-SV scans, the artifact writer) runs its tasks one
after another in the calling thread, so the trace holds every host op. The
results are the same; what a profiled run gives up is the overlap of those
tasks on threads. Without a profile the pools keep their threads.
"""

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor

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


class InlineExecutor:
    """The part of ``ThreadPoolExecutor``'s interface the port uses, run in
    the calling thread: ``submit`` runs the task at once and returns its
    finished future; ``map`` returns the results in order."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as ex:   # delivered by fut.result(), as a pool does
            fut.set_exception(ex)
        return fut

    def map(self, fn, *iterables):
        return iter([fn(*args) for args in zip(*iterables)])


def executor(max_workers):
    """A ``ThreadPoolExecutor`` of ``max_workers``, or an ``InlineExecutor``
    under ``inline()``."""
    return InlineExecutor() if inlined() else ThreadPoolExecutor(max_workers=max_workers)


def start_thread(target, args=()):
    """Start ``target(*args)`` on a daemon thread and return an object whose
    ``join()`` waits for it; under ``inline()`` it runs at once and ``join``
    returns."""
    if inlined():
        target(*args)
        return _Done()
    thread = threading.Thread(target=target, args=args, daemon=True)
    thread.start()
    return thread


class _Done:
    """A thread that has already finished."""

    def join(self):
        pass
