"""Exporters: re-export ingested telemetry to the systems users run.

Own copy of ``deepflow_tpu/server/exporters.py``. The decoders and the
integrations feed each table write to the ``ExporterManager``; each
exporter keeps the tables it takes, queues their rows, and a thread of
its own batches, converts and ships them, so a slow or dead destination
never blocks ingest:

- ``JsonLinesExporter``: gzip'd NDJSON over HTTP, one line a row with
  its table;
- ``OtlpJsonExporter``: ``flow_log.l7_flow_log`` rows as OTLP/HTTP JSON
  spans, and every ``profile.tpu_step_metrics`` row as one step span
  (its run, step, device count, skew, collective time and straggler), so
  a training job's step waterfall shows in any OTLP backend beside the
  request traces. The step span's ``traceId`` is ``steprun-<run_id>``,
  the reference's, not 32 hex digits;
- ``RemoteWriteExporter``: the 1 s flow-metric rows as a snappy
  Prometheus ``WriteRequest``, one series a meter;
- ``KafkaExporter``: rows as JSON messages to ``kafka://host:port/topic``
  over the Kafka wire protocol (``utils/kafkawire.py``: Metadata v0,
  Produce v2, acks=1, partitions round-robin).

A batch is retried, then spooled to disk with a ``spool_dir`` (replayed
oldest first when the destination answers again, a file it keeps
refusing quarantined as ``.bad``) or dropped. Each exporter accounts its
rows on its ``exporter.<kind>`` hop: emitted == delivered + dropped +
in flight (its queue and its spool). ``stats`` counts exported rows,
batches, drops, errors, spooled and replayed rows, and the wall ns spent
shipping (``ship_ns``).
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import pickle
import queue
import socket
import threading
import time
import urllib.request
from urllib.parse import urlparse

from deepflow_tpu_torch.utils import kafkawire, promwire, snappy

log = logging.getLogger("df.exporters")


class BaseExporter:
    """Background batch shipper; subclasses convert rows to a payload."""

    TABLES: tuple = ()

    SPOOL_MAX_FILES = 256     # ~bounded disk: oldest dropped beyond this

    def __init__(self, endpoint: str, batch_size: int = 256,
                 flush_interval_s: float = 2.0,
                 queue_size: int = 8192, max_retries: int = 2,
                 spool_dir: str | None = None) -> None:
        self.endpoint = endpoint
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.max_retries = max_retries
        # durability: exhausted retries land in a disk spool and replay
        # when the destination recovers (reference exporters buffer to
        # kafka; embedded design spools locally). None = legacy drop.
        self.spool_dir = spool_dir
        self._spool_seq = 0
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"exported": 0, "batches": 0, "dropped": 0,
                      "errors": 0, "spooled": 0, "replayed": 0,
                      "spool_dropped": 0, "ship_ns": 0}
        # conserved hop ledger (emitted == delivered + dropped + in_flight;
        # in_flight = queue + spool). Files spooled by a PREVIOUS process
        # were never emitted in this ledger: they account emitted at
        # adoption (first successful load), tracked via _spooled_rows.
        self._hop = None
        self._spooled_rows: dict[str, int] = {}  # fn -> rows, this ledger

    @property
    def kind(self) -> str:
        return type(self).__name__.removesuffix("Exporter").lower()

    def attach_telemetry(self, telemetry) -> "BaseExporter":
        self._hop = telemetry.hop(f"exporter.{self.kind}")
        return self

    def _acct(self, **kw) -> None:
        if self._hop is not None:
            self._hop.account(**kw)

    def accepts(self, table: str) -> bool:
        return not self.TABLES or table in self.TABLES

    def feed(self, table: str, rows: list[dict]) -> None:
        if not self.accepts(table):
            return
        full = 0
        for row in rows:
            try:
                self._q.put_nowait((table, row))
            except queue.Full:
                full += 1
        if full:
            self.stats["dropped"] += full
        # every accepted row enters the ledger; queue-full rows enter and
        # immediately drop so the books still balance
        self._acct(emitted=len(rows), dropped=full, reason="queue_full")

    def start(self) -> "BaseExporter":
        self._thread = threading.Thread(
            target=self._run, name=f"df-exporter-{type(self).__name__}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3.0)

    def _run(self) -> None:
        batch: list = []
        while not self._stop.is_set() or not self._q.empty():
            try:
                batch.append(self._q.get(timeout=self.flush_interval_s))
            except queue.Empty:
                pass
            if batch and (len(batch) >= self.batch_size or self._q.empty()):
                shipped = False
                for attempt in range(1 + self.max_retries):
                    try:
                        self._timed_ship(batch)
                        shipped = True
                        self.stats["exported"] += len(batch)
                        self.stats["batches"] += 1
                        self._acct(delivered=len(batch))
                        break
                    except Exception as e:
                        self.stats["errors"] += 1
                        log.debug("export failed (try %d): %s", attempt, e)
                        if self._stop.is_set():
                            break  # shutdown mid-retry: still a drop
                        time.sleep(min(0.5 * (attempt + 1), 2.0))
                if not shipped:
                    if self._spool(batch):
                        self.stats["spooled"] += len(batch)
                        # spooled rows stay in_flight until replayed
                    else:
                        self.stats["dropped"] += len(batch)
                        self._acct(dropped=len(batch),
                                   reason="ship_failed")
                batch = []
            # disk-driven replay: runs whether the spool predates this
            # process or filled this run, throttled between attempts
            self._maybe_replay_spool()

    def _spool(self, batch: list) -> bool:
        if not self.spool_dir:
            return False
        try:
            os.makedirs(self.spool_dir, exist_ok=True)
            files = sorted(f for f in os.listdir(self.spool_dir)
                           if f.endswith(".spool"))
            while len(files) >= self.SPOOL_MAX_FILES:
                victim = files.pop(0)  # oldest out; drops stay VISIBLE
                n = 0
                try:
                    with open(os.path.join(self.spool_dir, victim),
                              "rb") as f:
                        n = len(pickle.load(f))
                    self.stats["spool_dropped"] += n
                except Exception:
                    pass
                if victim in self._spooled_rows:
                    # rows this ledger already emitted: close them out
                    self._acct(dropped=self._spooled_rows.pop(victim),
                               reason="spool_evict")
                elif n:
                    # foreign file (previous process): adopt-then-drop so
                    # the eviction is visible without going negative
                    self._acct(emitted=n, dropped=n, reason="spool_evict")
                os.unlink(os.path.join(self.spool_dir, victim))
            self._spool_seq += 1
            path = os.path.join(
                self.spool_dir,
                f"{time.time_ns():020d}_{self._spool_seq:06d}.spool")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(batch, f)
            os.replace(path + ".tmp", path)
            self._spooled_rows[os.path.basename(path)] = len(batch)
            return True
        except OSError as e:
            log.warning("spool write failed: %s", e)
            return False

    def _maybe_replay_spool(self) -> None:
        if not self.spool_dir:
            return
        now = time.monotonic()
        if now < getattr(self, "_next_replay", 0):
            return
        self._next_replay = now + 5.0
        self._replay_spool()

    def _replay_spool(self, max_files: int = 8) -> None:
        """Drain spooled batches oldest-first (including batches spooled
        by a PREVIOUS process run)."""
        try:
            files = sorted(f for f in os.listdir(self.spool_dir)
                           if f.endswith(".spool"))
        except OSError:
            return
        attempts = getattr(self, "_replay_attempts", None)
        if attempts is None:
            attempts = self._replay_attempts = {}
        for fn in files[:max_files]:
            path = os.path.join(self.spool_dir, fn)
            try:
                with open(path, "rb") as f:
                    batch = pickle.load(f)
                self._timed_ship(batch)
                os.unlink(path)
                attempts.pop(fn, None)
                self.stats["replayed"] += len(batch)
                self.stats["exported"] += len(batch)
                if fn in self._spooled_rows:
                    self._spooled_rows.pop(fn)
                    self._acct(delivered=len(batch))
                else:
                    # foreign spool file: adopted into this ledger only
                    # once it actually ships
                    self._acct(emitted=len(batch), delivered=len(batch))
            except Exception as e:
                # a file the destination deterministically rejects must not
                # block everything behind it forever: quarantine after 5
                # tries (visible in spool_dropped + the .bad file on disk)
                attempts[fn] = attempts.get(fn, 0) + 1
                if attempts.get(fn, 0) >= 5:
                    try:
                        n = 0
                        try:
                            with open(path, "rb") as f:
                                n = len(pickle.load(f))
                        except Exception:
                            pass
                        os.replace(path, path + ".bad")
                        self.stats["spool_dropped"] += n
                        attempts.pop(fn, None)
                        if fn in self._spooled_rows:
                            self._acct(
                                dropped=self._spooled_rows.pop(fn),
                                reason="spool_poison")
                        elif n:
                            self._acct(emitted=n, dropped=n,
                                       reason="spool_poison")
                        log.warning("quarantined poison spool file %s", fn)
                        continue
                    except OSError:
                        pass
                log.debug("spool replay stopped at %s: %s", fn, e)
                return  # destination flapped again; keep the file

    def _timed_ship(self, batch: list) -> None:
        t0 = time.perf_counter_ns()
        try:
            self._ship(batch)
        finally:
            self.stats["ship_ns"] += time.perf_counter_ns() - t0

    def _ship(self, batch: list) -> None:
        raise NotImplementedError

    def _post(self, data: bytes, content_type: str,
              headers: dict | None = None) -> None:
        req = urllib.request.Request(
            self.endpoint, data=data,
            headers={"Content-Type": content_type, **(headers or {})})
        with urllib.request.urlopen(req, timeout=10):
            pass


class JsonLinesExporter(BaseExporter):
    """NDJSON over HTTP (the kafka-topic analog for environments without
    kafka: any collector that takes line-delimited JSON)."""

    def __init__(self, endpoint: str, tables: tuple = (), **kw) -> None:
        super().__init__(endpoint, **kw)
        self.TABLES = tables

    def _ship(self, batch: list) -> None:
        lines = b"\n".join(
            json.dumps({"table": t, **row}, default=str).encode()
            for t, row in batch)
        self._post(gzip.compress(lines), "application/x-ndjson",
                   {"Content-Encoding": "gzip"})


class OtlpJsonExporter(BaseExporter):
    """l7_flow_log rows -> OTLP/HTTP JSON traces; tpu_step_metrics rows
    ride along as one span per (host, step) so a training-step waterfall
    shows up next to the request traces in any OTLP backend."""

    TABLES = ("flow_log.l7_flow_log", "profile.tpu_step_metrics")

    @staticmethod
    def _step_span(row: dict) -> dict:
        start = int(row.get("time", 0))
        end = int(row.get("end_ns", 0)) or start
        rid = int(row.get("run_id", 0))
        step = int(row.get("step", 0))
        return {
            "traceId": f"steprun-{rid}",
            "spanId": f"step-{rid}-{step}-{row.get('host', '')}",
            "parentSpanId": "",
            "name": f"{row.get('job', '') or 'step'}/{step}",
            "kind": 1,  # INTERNAL
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(end),
            "attributes": [
                {"key": "tpu.run_id", "value": {"intValue": rid}},
                {"key": "tpu.step", "value": {"intValue": step}},
                {"key": "tpu.device_count",
                 "value": {"intValue": int(row.get("device_count", 0))}},
                {"key": "tpu.device_skew_ns",
                 "value": {"intValue": int(row.get("device_skew_ns", 0))}},
                {"key": "tpu.collective_ns",
                 "value": {"intValue": int(row.get("collective_ns", 0))}},
                {"key": "tpu.straggler_device",
                 "value": {"intValue": int(row.get("straggler_device", 0))}},
                {"key": "host.name",
                 "value": {"stringValue": str(row.get("host", ""))}},
            ],
            "status": {"code": 1},
        }

    def _ship(self, batch: list) -> None:
        spans = []
        for table, row in batch:
            if table == "profile.tpu_step_metrics":
                spans.append(self._step_span(row))
                continue
            start = int(row.get("time", 0))
            dur = int(row.get("response_duration", 0))
            spans.append({
                "traceId": row.get("trace_id", ""),
                "spanId": (row.get("span_id", "")
                           or f"flow-{row.get('flow_id', 0)}"),
                "parentSpanId": row.get("parent_span_id", ""),
                "name": (f"{row.get('request_type', '')} "
                         f"{row.get('endpoint', '')}").strip() or "span",
                "kind": 2,
                "startTimeUnixNano": str(start),
                "endTimeUnixNano": str(start + dur),
                "attributes": [
                    {"key": "l7.protocol",
                     "value": {"stringValue":
                               str(row.get("l7_protocol", ""))}},
                    {"key": "http.status_code",
                     "value": {"intValue": int(row.get("response_code", 0))}},
                    {"key": "net.peer.ip",
                     "value": {"stringValue": row.get("ip_dst", "")}},
                ],
                "status": {"code": 1 if row.get("response_status")
                           in (1, "ok") else 2},
            })
        payload = {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": "deepflow-tpu"}}]},
            "scopeSpans": [{"spans": spans}]}]}
        self._post(json.dumps(payload).encode(), "application/json")


class RemoteWriteExporter(BaseExporter):
    """flow_metrics rows -> prometheus remote-write (snappy WriteRequest)."""

    TABLES = ("flow_metrics.network.1s", "flow_metrics.application.1s")

    _METERS = {
        "flow_metrics.network.1s": (
            "flow_metrics_network_", ("byte_tx", "byte_rx", "packet_tx",
                                      "packet_rx", "retrans")),
        "flow_metrics.application.1s": (
            "flow_metrics_application_", ("request", "response",
                                          "error_client", "error_server")),
    }
    _LABELS = ("ip_src", "ip_dst", "server_port", "host", "app_service")

    def _ship(self, batch: list) -> None:
        series = []
        for table, row in batch:
            prefix, meters = self._METERS.get(table, ("", ()))
            labels = {lbl: str(row[lbl]) for lbl in self._LABELS
                      if row.get(lbl) not in (None, "", 0)}
            ts_ms = int(row.get("time", 0)) * 1000
            for meter in meters:
                # zeros export too: downstream series must return to 0
                # after a burst, not go stale inside the staleness window
                series.append((prefix + meter, labels,
                               [(ts_ms, float(row.get(meter, 0)))]))
        if series:
            self._post(snappy.compress(promwire.write_request(series)),
                       "application/x-protobuf",
                       {"Content-Encoding": "snappy",
                        "X-Prometheus-Remote-Write-Version": "0.1.0"})


class KafkaExporter(BaseExporter):
    """Rows -> Kafka topic as JSON messages over the raw wire protocol
    (reference: ingester/exporters/kafka_exporter; there is no client
    library, so utils/kafkawire.py speaks the protocol).

    Endpoint form: kafka://host:port/topic. Partition-leader discovery via
    Metadata v0, messages partitioned round-robin, acks=1; broker errors
    raise so the Base retry/spool machinery engages."""

    def __init__(self, endpoint: str, tables: tuple = (), **kw) -> None:
        super().__init__(endpoint, **kw)
        self.TABLES = tables
        u = urlparse(endpoint)
        if u.scheme != "kafka" or not u.hostname or not u.path.strip("/"):
            raise ValueError(
                f"kafka endpoint must be kafka://host:port/topic, "
                f"got {endpoint!r}")
        self.bootstrap = (u.hostname, u.port or 9092)
        self.topic = u.path.strip("/")
        self._corr = 0
        self._rr = 0
        self._conns: dict = {}       # (host, port) -> socket
        self._leaders: dict = {}     # partition -> (host, port)

    def stop(self) -> None:
        super().stop()
        for sock in self._conns.values():
            try:
                sock.close()
            except OSError:
                pass
        self._conns.clear()

    def _next_corr(self) -> int:
        self._corr += 1
        return self._corr

    def _connect(self, addr: tuple):
        sock = self._conns.get(addr)
        if sock is not None:
            return sock
        sock = socket.create_connection(addr, timeout=10)
        sock.settimeout(10)
        self._conns[addr] = sock
        return sock

    def _drop_conn(self, addr: tuple) -> None:
        sock = self._conns.pop(addr, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _refresh_metadata(self) -> None:
        corr = self._next_corr()
        sock = self._connect(self.bootstrap)
        try:
            sock.sendall(kafkawire.metadata_request([self.topic], corr))
            got_corr, body = kafkawire.read_response(sock)
        except OSError:
            self._drop_conn(self.bootstrap)
            raise
        if got_corr != corr:
            self._drop_conn(self.bootstrap)
            raise kafkawire.KafkaWireError(
                f"correlation mismatch {got_corr} != {corr}")
        md = kafkawire.parse_metadata_response(body, self.topic)
        if md.topic_error not in (0, 5):  # 5: leader election in progress
            raise kafkawire.KafkaWireError(
                f"topic {self.topic!r}: "
                f"{kafkawire.error_name(md.topic_error)}")
        self._leaders = {
            pid: md.brokers[leader]
            for pid, leader in md.partition_leaders.items()
            if leader in md.brokers}
        if not self._leaders:
            raise kafkawire.KafkaWireError(
                f"no leaders for topic {self.topic!r}")

    def _ship(self, batch: list) -> None:
        if not self._leaders:
            self._refresh_metadata()
        parts = sorted(self._leaders)
        partition = parts[self._rr % len(parts)]
        self._rr += 1
        now_ms = int(time.time() * 1000)
        msgs = [(None, json.dumps({"table": t, **row},
                                  default=str).encode(), now_ms)
                for t, row in batch]
        corr = self._next_corr()
        req = kafkawire.produce_request(self.topic, partition,
                                 kafkawire.message_set(msgs), corr)
        addr = self._leaders[partition]
        try:
            sock = self._connect(addr)
            sock.sendall(req)
            got_corr, body = kafkawire.read_response(sock)
        except OSError:
            # connect failures too: a dead leader must invalidate the
            # cached topology or failover never recovers
            self._drop_conn(addr)
            self._leaders = {}
            raise
        if got_corr != corr:
            self._drop_conn(addr)
            raise kafkawire.KafkaWireError(
                f"correlation mismatch {got_corr} != {corr}")
        res = kafkawire.parse_produce_response(body)
        if res.error_code != 0:
            if res.error_code in kafkawire.RETRIABLE_ERRORS:
                self._leaders = {}  # re-discover on next attempt
            raise kafkawire.KafkaWireError(
                f"produce to {self.topic}[{partition}]: "
                f"{kafkawire.error_name(res.error_code)}")


class ExporterManager:
    def __init__(self, telemetry=None) -> None:
        self.exporters: list[BaseExporter] = []
        self.telemetry = telemetry

    def add(self, exporter: BaseExporter) -> BaseExporter:
        """Idempotent on (type, endpoint): re-adding returns the existing
        exporter instead of leaking threads and double-shipping."""
        for e in self.exporters:
            if (type(e) is type(exporter)
                    and e.endpoint == exporter.endpoint):
                return e
        if self.telemetry is not None:
            exporter.attach_telemetry(self.telemetry)
        self.exporters.append(exporter.start())
        return exporter

    def remove(self, endpoint: str) -> int:
        removed = [e for e in self.exporters if e.endpoint == endpoint]
        self.exporters = [e for e in self.exporters
                          if e.endpoint != endpoint]
        for e in removed:
            e.stop()
        return len(removed)

    def feed(self, table: str, rows: list[dict]) -> None:
        for e in self.exporters:
            e.feed(table, rows)

    def wants(self, table: str) -> bool:
        """Does any registered exporter accept this table? Lets hot-path
        writers skip materializing row dicts when nobody is listening."""
        return any(e.accepts(table) for e in self.exporters)

    def stop(self) -> None:
        for e in self.exporters:
            e.stop()

    def stats(self) -> dict:
        out = {}
        for e in self.exporters:
            st = dict(e.stats)
            if e._hop is not None:
                st["ledger"] = e._hop.snapshot()
            out[f"{type(e).__name__}:{e.endpoint}"] = st
        return out
