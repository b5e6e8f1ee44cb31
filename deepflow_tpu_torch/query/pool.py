"""Shared morsel scan worker pool (query/engine.py, query/cache.py).

Own copy of ``deepflow_tpu/query/pool.py``. One process-wide pool, sized
from ``os.cpu_count()`` with a ``DF_QUERY_THREADS`` override re-read on
every acquisition, so the degree can change between queries and the
pool resizes in place. 1 means "no pool": callers get None and run the
serial path.

Nested-parallelism guard: work dispatched through the pool runs with a
thread-local ``in_worker`` flag set. The engine checks it before
planning a parallel scan, so a pool task that itself executes a query
(a query-cache bucket refill) degrades to the serial path instead of
deadlocking on the pool it is occupying.

The actual parallelism comes from the native kernels, which release the
interpreter lock (``native/qexec.cpp`` filter, group and aggregate), and
from numpy's large ops; pure-Python morsel work serializes on the lock,
and then the pool only adds overhead, which the engine's degree cost
model learns and avoids.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

_LOCAL = threading.local()
_LOCK = threading.Lock()
_POOL: ThreadPoolExecutor | None = None
_POOL_THREADS = 0
_BUSY = 0
_DISPATCHED = 0
_QTRACE = None


def _qtrace():
    """qtrace module, bound once (the import-inside-the-hot-loop lookup
    was measurable at one call per morsel)."""
    global _QTRACE
    if _QTRACE is None:
        from deepflow_tpu_torch.query import qtrace
        _QTRACE = qtrace
    return _QTRACE


def configured_threads() -> int:
    """Pool size: DF_QUERY_THREADS override, else os.cpu_count()."""
    env = os.environ.get("DF_QUERY_THREADS", "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return os.cpu_count() or 1


def in_worker() -> bool:
    return getattr(_LOCAL, "in_worker", False)


def get_pool() -> "ScanPool | None":
    """The shared pool at the currently-configured size, or None when
    the configuration says serial (1 thread) or the caller is already a
    pool worker (nested fan-out would deadlock)."""
    n = configured_threads()
    if n <= 1 or in_worker():
        return None
    global _POOL, _POOL_THREADS
    with _LOCK:
        if _POOL is None or _POOL_THREADS != n:
            if _POOL is not None:
                # in-flight tasks finish on the old threads; new work
                # lands on the resized pool
                _POOL.shutdown(wait=False)
            _POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="df-scan")
            _POOL_THREADS = n
    return ScanPool(_POOL, n)


def stats() -> dict:
    """Health view: configured size + live occupancy."""
    with _LOCK:
        return {"threads": _POOL_THREADS, "busy": _BUSY,
                "dispatched": _DISPATCHED}


class ScanPool:
    """Thin ordered-map facade over the shared executor."""

    __slots__ = ("_ex", "threads")

    def __init__(self, ex: ThreadPoolExecutor, threads: int) -> None:
        self._ex = ex
        self.threads = threads

    @staticmethod
    def _run(fn, item, tbuf=None, anchor=None):
        global _BUSY
        _LOCAL.in_worker = True
        with _LOCK:
            _BUSY += 1
        try:
            if tbuf is None:
                return fn(item)
            # re-attach the submitting query's trace buffer: prune
            # decisions inside a morsel/bucket scan then land in the
            # right span tree.  Inlined thread-local
            # swap rather than qtrace.use_buf — this runs once per
            # MORSEL, and at default morsel sizing the ctx-manager +
            # per-task anchor allocation alone are a measurable cost.
            tls = _qtrace()._tls
            prev_buf = getattr(tls, "buf", None)
            prev_span = getattr(tls, "span", None)
            tls.buf = tbuf
            tls.span = anchor
            try:
                return fn(item)
            finally:
                tls.buf = prev_buf
                tls.span = prev_span
        finally:
            with _LOCK:
                _BUSY -= 1
            _LOCAL.in_worker = False

    def map(self, fn, items: list) -> list:
        """fn over items on the pool; results in input order. The first
        task raising propagates (after every future resolves, so no task
        outlives the call and touches freed state)."""
        global _DISPATCHED
        with _LOCK:
            _DISPATCHED += len(items)
        qtrace = _qtrace()
        tbuf = qtrace.current_buf()
        anchor = None
        if tbuf is not None:
            tsid = qtrace.current_span_id()
            if tsid:
                # one anchor shared by every task of this map call:
                # span() only reads .span_id off it for parenting, and
                # stray annotate()/bump() land in an attrs dict nobody
                # records
                anchor = qtrace.Span.__new__(qtrace.Span)
                anchor.span_id = tsid
                anchor.attrs = {}
        futs = [self._ex.submit(self._run, fn, it, tbuf, anchor)
                for it in items]
        out, err = [], None
        for f in futs:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if err is None:
                    err = e
        if err is not None:
            raise err
        return out
