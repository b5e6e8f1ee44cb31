"""Dogfooded query tracing: one span tree per query.

Own copy of ``deepflow_tpu/query/qtrace.py``. Every DF-SQL, PromQL and
Tempo query the port's querier serves gets a trace id and a span tree:
parse, plan, execute, the cache lookup, the scan with its prune decision
and morsel degree, the partial merge; a federated query's shards adopt
its context (``adopt``, ``ctx_for_wire``), so their spans join it.
Spans land in the server's own ``deepflow_system.query_trace`` table, the
same self-monitoring channel the DFSTATS rows use.

Design constraints that shaped the module:

* **One tracer per Server** (like ``Telemetry``): tests run several
  servers per process, so the only process-global state is a
  thread-local pointing at the ACTIVE trace buffer.  ``span()`` /
  ``annotate()`` / ``bump()`` read that thread-local and are no-ops
  (one dict lookup, no allocation) when no trace is active.
* **Propagation is explicit**: pool workers don't inherit thread-locals,
  so ``current_buf()``/``use_buf()`` let the scan pool re-attach a
  worker thread to the submitting query's buffer.
* **Sampling is head+tail**: deterministic head sampling on the trace
  id, with a tail upgrade that always keeps slow or errored queries.
  Dropped traces are accounted in the ``query.trace`` hop ledger with a
  reason, so ``emitted == delivered + dropped`` holds for spans like it
  does for frames everywhere else in the pipeline.

Kill-switch: ``DF_QUERY_TRACE=0`` (read live, like ``DF_NO_SELFMON``).
Knobs: ``DF_QUERY_TRACE_SAMPLE`` (keep 1/N of bulk traces, default 8 —
bulk traces of healthy fast queries are downsampled so the span sink
stays off the query path's budget; slow/errored queries are always
tail-kept regardless), ``DF_QUERY_TRACE_SLOW_MS`` (tail-keep threshold,
default 250).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time

log = logging.getLogger("df.qtrace")

# hard cap on spans buffered per trace: a runaway instrumented loop
# degrades to a truncated trace + a counted drop, never unbounded memory
MAX_SPANS_PER_TRACE = 512

# completed traces queued on the tracer before a background flush is
# kicked; readers (flush/snapshot) drain
# inline, so this only bounds how much a write-only workload can buffer
_DRAIN_TRACES = 128

_tls = threading.local()


def _enabled() -> bool:
    return os.environ.get("DF_QUERY_TRACE", "") not in ("0", "false", "off")


def _sample_n() -> int:
    try:
        return max(1, int(os.environ.get("DF_QUERY_TRACE_SAMPLE", "8")))
    except ValueError:
        return 8


def _slow_ns() -> int:
    ms = os.environ.get("DF_QUERY_TRACE_SLOW_MS")
    if ms is None:
        return 250_000_000
    try:
        return int(float(ms) * 1e6)
    except ValueError:
        return 250_000_000


# span/trace ids: a process-unique counter seeded from os.urandom.
# uuid4 costs ~10us a call and a traced query mints ~9 ids; next() on an
# itertools.count is a single C-level op (atomic under the GIL) and the
# random 64-bit start keeps ids from colliding across processes.
_ids = itertools.count(int.from_bytes(os.urandom(8), "big"))


def _new_id() -> str:
    return "%016x" % (next(_ids) & 0xFFFFFFFFFFFFFFFF)


def _head_keep(trace_id: str, n: int) -> bool:
    """Deterministic head-sampling decision: the same trace id always
    reaches the same verdict."""
    if n <= 1:
        return True
    # ids are hex and the low digits carry the entropy; int() parses at
    # C speed (a python hash loop over 32 chars costs ~3us/query).  The
    # splitmix-style finalizer matters: counter-minted ids advance by a
    # near-constant stride per trace, and a bare modulo over a constant
    # stride keeps 0% or 2/n of traces instead of 1/n.
    try:
        v = int(trace_id[-16:], 16)
    except ValueError:
        v = -1
    if v >= 0:
        v ^= v >> 33
        v = (v * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
        v ^= v >> 33
        return v % n == 0
    # stable across processes (unlike hash()) for non-hex foreign ids
    h = 0
    for ch in trace_id:
        h = (h * 131 + ord(ch)) & 0xFFFFFFFF
    return h % n == 0


class Span:
    """One timed operation.  Mutable while open; ``to_dict()`` after
    close yields the wire/table shape of a query_trace row (``rows_from_spans``)."""

    __slots__ = ("span_id", "parent_span_id", "name", "start_ns", "end_ns",
                 "cpu_start_ns", "cpu_ns", "status", "attrs", "_buf",
                 "_prev")

    def __init__(self, buf: "_TraceBuf", name: str,
                 parent_span_id: str, attrs: dict | None) -> None:
        self.span_id = _new_id()
        self.parent_span_id = parent_span_id
        self.name = name
        self.start_ns = time.time_ns()
        # thread CPU time is a real syscall (no vDSO) and only EXPLAIN
        # ANALYZE's stage table reads cpu_ns, so bulk traces skip both
        # clock reads — two syscalls x ~9 spans/query adds up on every
        # query
        self.cpu_start_ns = time.thread_time_ns() if buf.capture else 0
        self.end_ns = 0
        self.cpu_ns = 0
        self.status = "ok"
        # callers build attrs fresh from **kwargs; take ownership
        self.attrs = attrs if attrs is not None else {}
        self._buf = buf

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Span":
        self._prev = getattr(_tls, "span", None)
        _tls.span = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.finish()
        _tls.span = self._prev

    def finish(self) -> None:
        if self.end_ns:
            return
        self.end_ns = time.time_ns()
        if self.cpu_start_ns:
            self.cpu_ns = time.thread_time_ns() - self.cpu_start_ns
        self._buf.add(self)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def bump(self, key: str, n: int = 1) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + n

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    @property
    def trace_id(self) -> str:
        return self._buf.trace_id

    def trace_spans(self) -> list[dict]:
        """Finished span dicts of this span's trace so far — the
        capture=True hand-back used by EXPLAIN ANALYZE."""
        buf = self._buf
        finished = list(buf.spans)  # snapshot; append-only under GIL
        return [s.to_dict(buf) for s in finished]

    def to_dict(self, buf: "_TraceBuf") -> dict:
        return {
            "trace_id": buf.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "service": buf.service,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ns": self.duration_ns,
            "cpu_ns": max(0, self.cpu_ns),
            "status": self.status,
            "kind": "query",
            "attrs": self.attrs,
        }


class _RootSpan(Span):
    """Root of a trace on this process: entering installs the trace
    buffer on the thread-local; exiting restores the previous buffer
    and hands the finished trace to the tracer for sampling verdict,
    ledger accounting, and sink flush.  enter/exit are flattened (no
    super() chain through Span.__exit__/finish/add): the root runs once
    per query and each interpreter frame on this path is paid by every
    query."""

    __slots__ = ("_prev_buf",)

    def __enter__(self) -> "_RootSpan":
        self._prev_buf = getattr(_tls, "buf", None)
        self._prev = getattr(_tls, "span", None)
        _tls.buf = self._buf
        _tls.span = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        if not self.end_ns:
            self.end_ns = time.time_ns()
            if self.cpu_start_ns:
                self.cpu_ns = time.thread_time_ns() - self.cpu_start_ns
            self._buf.spans.append(self)
        _tls.span = self._prev
        _tls.buf = self._prev_buf
        self._buf.tracer._complete(self._buf)


class _NullSpan:
    """Returned when no trace is active: all methods are no-ops and the
    singleton is reused, so disabled-path cost is one attr lookup."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def finish(self) -> None:
        pass

    def annotate(self, **attrs) -> None:
        pass

    def bump(self, key: str, n: int = 1) -> None:
        pass

    @property
    def trace_id(self) -> str:
        return ""

    @property
    def duration_ns(self) -> int:
        return 0

    def trace_spans(self) -> list:
        return []


_NULL_SPAN = _NullSpan()


class _TraceBuf:
    """All spans of one query on one process.  ``add`` is safe from
    morsel-scan worker threads without a lock: list.append is atomic
    under the GIL and the bookkeeping races are benign."""

    __slots__ = ("tracer", "trace_id", "root", "sampled", "capture",
                 "spans", "overflow", "_done")

    def __init__(self, tracer: "QueryTracer", trace_id: str,
                 sampled: bool | None, capture: bool) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.root: Span | None = None
        self.sampled = sampled      # head verdict; None = not yet decided
        self.capture = capture      # EXPLAIN ANALYZE: hand spans back
        self.spans: list[Span] = []
        self.overflow = 0
        self._done = False

    @property
    def service(self) -> str:
        return self.tracer.service

    def add(self, span: Span) -> None:
        # the Span OBJECT is buffered; the dict conversion runs at flush
        # (off the query thread for periodic flushes) or on read.
        # Lock-free: list.append is atomic under the GIL, and the
        # _done/overflow checks race benignly (a straggler span landing
        # during root exit misses the completion snapshot, it never
        # corrupts it) — the lock acquisition per span was a measurable
        # slice of the query-path overhead budget
        if self._done:
            return
        spans = self.spans
        if len(spans) >= MAX_SPANS_PER_TRACE:
            self.overflow += 1
            return
        spans.append(span)


class QueryTracer:
    """Per-server query tracer: root-span lifecycle, sampling verdicts,
    ledger accounting, buffered sink into deepflow_system.query_trace.

    ``sink`` is ``Callable[[list[dict]], None]`` taking finished span
    dicts (usually the querier appending rows to the system table); when
    None, kept spans stay pending (the ledger's in_flight) and only an
    EXPLAIN ANALYZE capture hands any back."""

    def __init__(self, telemetry=None, service: str = "deepflow-querier",
                 sink=None) -> None:
        self.service = service
        self.sink = sink
        self._hop = (telemetry.hop("query.trace") if telemetry is not None
                     else None)
        self._lock = threading.Lock()
        self._pending: list[Span] = []
        self._pending_since = 0.0
        # finished trace buffers queued by _complete (lock-free append
        # on the query thread) until a reader drains them
        self._completed: list[_TraceBuf] = []
        # hop-ledger deltas accumulated at drain time and synced into
        # the telemetry hop at flush/snapshot — hop.account takes its
        # own lock and feeds a histogram, which is too much work to pay
        # per query
        self._led = {"emitted": 0, "sampled_out": 0, "overflow": 0}
        self._led_wait: list[tuple[int, int]] = []
        self.stats = {"traces": 0, "spans": 0, "written": 0,
                      "sampled_out": 0, "overflow": 0, "flushes": 0,
                      "sink_errors": 0}

    # -- trace lifecycle -----------------------------------------------------

    def start_trace(self, name: str, trace_id: str | None = None,
                    capture: bool = False, **attrs) -> Span:
        """Open the ROOT span of a new trace on this thread.  Use as a
        context manager; on exit the whole trace is accounted+flushed.
        ``capture=True`` (EXPLAIN ANALYZE) keeps spans on the buf for the
        caller regardless of the sampling verdict."""
        if not _enabled() and not capture:
            return _NULL_SPAN  # type: ignore[return-value]
        if trace_id:
            tid = trace_id
        else:
            hi, lo = next(_ids), next(_ids)
            tid = "%016x%016x" % (hi & 0xFFFFFFFFFFFFFFFF,
                                  lo & 0xFFFFFFFFFFFFFFFF)
        # head-sampling verdict is LAZY (None): computed at drain time —
        # two env reads and a hash the query path never pays inline
        buf = _TraceBuf(self, tid, None, capture)
        root = _RootSpan(buf, name, "", attrs)
        buf.root = root
        return root

    def adopt(self, ctx, name: str, **attrs) -> Span:
        """Shard-side join of a propagated trace context (the ``qtrace``
        dict of a scatter body, ``cluster/wire.py``). Returns a root-like
        span parented under the coordinator's ``shard.call`` span; the
        sampling verdict is the coordinator's, so the whole trace lives
        or dies together."""
        if not isinstance(ctx, dict) or not ctx.get("tid"):
            return _NULL_SPAN  # type: ignore[return-value]
        if not _enabled():
            return _NULL_SPAN  # type: ignore[return-value]
        buf = _TraceBuf(self, str(ctx["tid"]), bool(ctx.get("sampled", True)),
                        False)
        root = _RootSpan(buf, name, str(ctx.get("sid", "")), attrs)
        buf.root = root
        return root

    def _complete(self, buf: _TraceBuf) -> None:
        """Hand a finished trace over.  Runs on the query thread at root
        exit, so it does the absolute minimum: one lock-free append onto
        the completed queue.  The sampling verdict, stats, ledger and
        pending-buffer work all run at drain time -- off the request
        path unless the caller explicitly wants read-your-writes."""
        buf._done = True
        completed = self._completed
        completed.append(buf)
        if buf.capture:
            # EXPLAIN ANALYZE wants read-your-writes: flush inline
            self.flush()
        elif len(completed) >= _DRAIN_TRACES:
            # the sink write is a columnar append (dict growth, chunk
            # seal) -- paying it inside a query request shows up in the
            # query's time, so periodic flushes run off-thread
            threading.Thread(target=self.flush, daemon=True,
                             name="df-qtrace-flush").start()

    def _drain_locked(self) -> None:
        """Process completed trace buffers: head/tail sampling verdict,
        stats, ledger deltas, pending extension.  Caller holds
        ``self._lock``; every reader (flush/snapshot)
        drains first, so the visible state is always consistent."""
        if not self._completed:
            return
        batch, self._completed = self._completed, []
        st = self.stats
        led = self._led
        for buf in batch:
            root = buf.root
            spans = buf.spans
            overflow = buf.overflow
            n = len(spans)
            if buf.sampled is None:
                buf.sampled = _head_keep(buf.trace_id, _sample_n())
            # tail upgrade: slow or errored traces are always kept;
            # capture (EXPLAIN ANALYZE) is an explicit request, never
            # sampled out
            keep = buf.sampled or buf.capture
            if root is not None and not keep:
                if (root.status != "ok"
                        or root.end_ns - root.start_ns >= _slow_ns()):
                    keep = True
            st["traces"] += 1
            st["spans"] += n
            led["emitted"] += n + overflow
            if overflow:
                st["overflow"] += overflow
                led["overflow"] += overflow
            if not keep:
                st["sampled_out"] += n
                led["sampled_out"] += n
                continue
            # kept spans are in_flight until the sink write delivers
            # them: in_flight on the ledger == the pending buffer,
            # exactly like a frame hop's queue
            self._pending.extend(spans)
            if root is not None:
                # wait observes the root's duration per emitted span --
                # how long spans sat on the trace before heading to the
                # sink queue
                self._led_wait.append(
                    (root.end_ns - root.start_ns, n + overflow))
            if not self._pending_since:
                self._pending_since = time.monotonic()

    def _sync_hop_locked(self) -> None:
        """Push accumulated ledger deltas into the telemetry hop.
        Caller holds ``self._lock`` — everyone reading the hop goes
        through flush() or snapshot(), so the hop is always consistent
        with the pending buffer at those points."""
        hop = self._hop
        if hop is None:
            return
        led = self._led
        if led["emitted"]:
            hop.account(emitted=led["emitted"])
            led["emitted"] = 0
        if led["sampled_out"]:
            hop.account(dropped=led["sampled_out"], reason="sampled_out")
            led["sampled_out"] = 0
        if led["overflow"]:
            hop.account(dropped=led["overflow"], reason="overflow")
            led["overflow"] = 0
        if self._led_wait:
            for wait_ns, weight in self._led_wait:
                hop.observe_wait(wait_ns, weight)
            self._led_wait = []

    # -- sink ----------------------------------------------------------------

    def flush(self) -> int:
        """Push pending span dicts to the sink.  Returns rows written."""
        with self._lock:
            self._drain_locked()
            self._sync_hop_locked()
            if not self._pending or self.sink is None:
                return 0
            batch, self._pending = self._pending, []
            self._pending_since = 0.0
        try:
            self.sink([s.to_dict(s._buf) for s in batch])
        except Exception:
            log.exception("query_trace sink failed (%d spans)", len(batch))
            with self._lock:
                self.stats["sink_errors"] += 1
            if self._hop is not None:
                self._hop.account(dropped=len(batch), reason="sink_error")
            return 0
        with self._lock:
            self.stats["written"] += len(batch)
            self.stats["flushes"] += 1
        if self._hop is not None:
            self._hop.account(delivered=len(batch))
        return len(batch)

    def pending_spans(self, trace_id: str) -> list[dict]:
        """Read-your-writes: the span dicts of one trace kept but not yet
        flushed to the table (as the trace trees' ``pending_spans``)."""
        with self._lock:
            self._drain_locked()
            kept = [s for s in self._pending
                    if s._buf.trace_id == trace_id]
        return [s.to_dict(s._buf) for s in kept]

    def snapshot(self) -> dict:
        with self._lock:
            self._drain_locked()
            self._sync_hop_locked()
            out = dict(self.stats)
            out["pending"] = len(self._pending)
        out["enabled"] = _enabled()
        out["sample_n"] = _sample_n()
        if self._hop is not None:
            out["ledger"] = self._hop.snapshot()
        return out


def rows_from_spans(spans: list[dict]) -> list[dict]:
    """Span dicts -> deepflow_system.query_trace rows (missing universal
    tags take the table defaults)."""
    rows = []
    for d in spans:
        rows.append({
            "time": int(d.get("start_ns", 0)),
            "trace_id": str(d.get("trace_id", "")),
            "span_id": str(d.get("span_id", "")),
            "parent_span_id": str(d.get("parent_span_id", "")),
            "name": str(d.get("name", "")),
            "service": str(d.get("service", "")),
            "duration_ns": int(d.get("duration_ns", 0)),
            "cpu_ns": int(d.get("cpu_ns", 0)),
            "status": str(d.get("status", "ok")),
            "attr_json": json.dumps(d.get("attrs") or {}, sort_keys=True,
                                    default=str),
        })
    return rows


def spans_from_rows(rows) -> list[dict]:
    """Inverse of ``rows_from_spans``: table row dicts -> span dicts."""
    out = []
    for r in rows:
        try:
            attrs = json.loads(r.get("attr_json") or "{}")
        except ValueError:
            attrs = {}
        start = int(r.get("time", 0))
        out.append({
            "trace_id": str(r.get("trace_id", "")),
            "span_id": str(r.get("span_id", "")),
            "parent_span_id": str(r.get("parent_span_id", "")),
            "name": str(r.get("name", "")),
            "service": str(r.get("service", "")),
            "start_ns": start,
            "end_ns": start + int(r.get("duration_ns", 0)),
            "duration_ns": int(r.get("duration_ns", 0)),
            "cpu_ns": int(r.get("cpu_ns", 0)),
            "status": str(r.get("status", "ok")),
            "kind": "query",
            "attrs": attrs,
        })
    return out


# -- module-level API (reads the thread-local active buffer) -----------------

def active() -> bool:
    return getattr(_tls, "buf", None) is not None


def span(name: str, **attrs):
    """Child span under the current thread's open span; no-op singleton
    when no trace is active on this thread."""
    buf = getattr(_tls, "buf", None)
    if buf is None:
        return _NULL_SPAN
    parent = getattr(_tls, "span", None)
    pid = parent.span_id if isinstance(parent, Span) else (
        buf.root.span_id if buf.root is not None else "")
    return Span(buf, name, pid, attrs)


def annotate(**attrs) -> None:
    cur = getattr(_tls, "span", None)
    if isinstance(cur, Span):
        cur.attrs.update(attrs)


def bump(key: str, n: int = 1) -> None:
    cur = getattr(_tls, "span", None)
    if isinstance(cur, Span):
        cur.attrs[key] = cur.attrs.get(key, 0) + n


def current_buf():
    """Opaque capture handle for cross-thread propagation (see
    ``use_buf``); None when no trace is active."""
    return getattr(_tls, "buf", None)


def current_span_id() -> str:
    cur = getattr(_tls, "span", None)
    if isinstance(cur, Span):
        return cur.span_id
    buf = getattr(_tls, "buf", None)
    if buf is not None and buf.root is not None:
        return buf.root.span_id
    return ""


def ctx_for_wire() -> dict | None:
    """The context dict a scatter body carries: the receiving shard
    adopts it so its spans stitch under the coordinator's."""
    buf = getattr(_tls, "buf", None)
    if buf is None:
        return None
    if buf.sampled is None:
        # fan-out forces the head verdict now so every shard of this
        # trace lives or dies together (local traces decide at drain)
        buf.sampled = _head_keep(buf.trace_id, _sample_n())
    return {"tid": buf.trace_id, "sid": current_span_id(),
            "sampled": buf.sampled}


class use_buf:
    """Attach a worker thread to a captured trace buffer for the scope
    of one unit of work (a morsel or bucket scan).  ``parent_sid``
    parents the worker's spans under the span open at submit time."""

    __slots__ = ("buf", "parent_sid", "_prev_buf", "_prev_span")

    def __init__(self, buf, parent_sid: str = "") -> None:
        self.buf = buf
        self.parent_sid = parent_sid

    def __enter__(self) -> "use_buf":
        self._prev_buf = getattr(_tls, "buf", None)
        self._prev_span = getattr(_tls, "span", None)
        _tls.buf = self.buf
        # synthesize an anchor so span() parents under parent_sid: the
        # anchor itself is never finished/recorded
        if self.buf is not None and self.parent_sid:
            anchor = Span.__new__(Span)
            anchor.span_id = self.parent_sid
            anchor.attrs = {}  # annotate()/bump() land harmlessly here
            _tls.span = anchor
        else:
            _tls.span = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _tls.buf = self._prev_buf
        _tls.span = self._prev_span
