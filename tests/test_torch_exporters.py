"""The port's exporters held against the JAX package's.

Each exporter kind, given the same rows, must ship the reference's
decoded payload (NDJSON lines, OTLP spans with the step spans, the
remote-write ``WriteRequest`` bytes, Kafka messages to the stub broker of
``tests/kafka_stub.py``). Both servers fed the same frames (the span,
memory, step, profile and stats frames of ``test_torch_server.py`` and
the flow frames of ``test_torch_flow_ingest.py``) must export the same
rows from every decoder, the native columnar ones included; with no
exporter that wants a table, the columnar path builds no row dict. The
disk spool and its replay, a retriable broker error, idempotent add and
remove, the ``exporter.<kind>`` hop ledger through a destination's
outage, and ``dfctl exporter`` / ``dfctl events`` against the reference's
dfctl. Every exporter here flushes every 0.05 s and is stopped in a
``finally``; every wait is bounded (5 s or less).
"""

import collections
import contextlib
import gzip
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import kafka_stub
import test_torch_flow_ingest as tfi
import test_torch_server as tsrv
from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu.server import exporters as ref_exp
from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu.telemetry import Telemetry as RefTelemetry
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import exporters as exp
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.telemetry import Telemetry
from deepflow_tpu_torch.utils import snappy

FLUSH_S = 0.05
WAIT_S = 5.0


class Sink:
    """An HTTP destination on a local port keeping each body (gunzipped);
    ``refuse`` makes it answer 503."""

    def __init__(self) -> None:
        self.received: list[tuple[str, dict, bytes]] = []
        self.refuse = False
        sink = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if sink.refuse:
                    self.send_response(503)
                    self.end_headers()
                    return
                if self.headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
                sink.received.append((self.path, dict(self.headers), body))
                self.send_response(200)
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}/ingest"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@contextlib.contextmanager
def _sinks(n: int):
    sinks = [Sink() for _ in range(n)]
    try:
        yield sinks
    finally:
        for s in sinks:
            s.stop()


def _wait(pred, timeout: float = WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@contextlib.contextmanager
def _running(*exporters):
    for e in exporters:
        e.start()
    try:
        yield exporters
    finally:
        for e in exporters:
            e.stop()


# rows of the tables the exporters take, Python numbers as the decoders
# hand them over
L7_ROWS = [{"time": 1_700_000_000_000_000_000 + i * 1000, "flow_id": i,
            "trace_id": f"{i:032x}" if i % 3 else "",
            "span_id": f"{i:016x}" if i % 2 else "",
            "parent_span_id": "", "request_type": "GET" if i % 2 else "",
            "endpoint": f"/api/{i}" if i % 4 else "",
            "response_duration": i * 7, "response_code": 200 + i,
            "response_status": i % 5, "l7_protocol": i % 4,
            "ip_dst": f"10.0.0.{i}"} for i in range(12)]
STEP_ROWS = [{"time": 1_700_000_000_000_000_000 + s * 10**8,
              "end_ns": 1_700_000_000_000_000_000 + s * 10**8 + 9 * 10**7
              if s % 3 else 0, "run_id": 3, "step": s,
              "job": "llama" if s % 2 else "", "device_count": 8,
              "device_skew_ns": 1000 * s, "collective_ns": 50 * s,
              "straggler_device": s % 8, "host": "gpu-node-0"}
             for s in range(9)]
NET_ROWS = [{"time": 1_700_000_000 + i, "ip_src": f"10.0.1.{i}",
             "ip_dst": "10.0.2.1", "server_port": 443 if i % 2 else 0,
             "host": "", "app_service": "web", "byte_tx": i * 100,
             "byte_rx": 0, "packet_tx": i, "packet_rx": 1, "retrans": 0}
            for i in range(5)]
APP_ROWS = [{"time": 1_700_000_000 + i, "ip_src": "10.0.1.1",
             "ip_dst": "10.0.2.1", "server_port": 80, "host": "h",
             "request": i, "response": i, "error_client": 0,
             "error_server": i % 2} for i in range(4)]


def _ship_both(make, feeds) -> list[list[bytes]]:
    """Each package's exporter from ``make(module, url)`` fed ``feeds``
    ((table, rows) ...) before it starts, so both cut the same batches:
    the bodies each sink took, in order."""
    with _sinks(2) as sinks:
        exps = [make(mod, s.url) for mod, s in zip((exp, ref_exp), sinks)]
        for e in exps:
            for table, rows in feeds:
                e.feed(table, rows)
        with _running(*exps):
            n = sum(len(r) for t, r in feeds if exps[0].accepts(t))
            assert _wait(lambda: all(e.stats["exported"] >= n
                                     for e in exps))
        return [[b for _, _, b in s.received] for s in sinks]


def test_json_lines_ships_the_references_lines():
    got, want = _ship_both(
        lambda m, url: m.JsonLinesExporter(
            url, tables=("flow_log.l7_flow_log", "event.event"),
            flush_interval_s=FLUSH_S, batch_size=5),
        [("flow_log.l7_flow_log", L7_ROWS), ("profile.tpu_step_metrics",
                                             STEP_ROWS),
         ("event.event", [{"time": 1, "event_type": "x", "attrs": "{}"}])])
    assert got == want
    lines = [json.loads(ln) for b in got for ln in b.splitlines()]
    assert len(lines) == len(L7_ROWS) + 1
    assert {ln["table"] for ln in lines} == {"flow_log.l7_flow_log",
                                             "event.event"}


def test_otlp_json_ships_the_references_spans_and_step_spans():
    got, want = _ship_both(
        lambda m, url: m.OtlpJsonExporter(url, flush_interval_s=FLUSH_S,
                                          batch_size=7),
        [("flow_log.l7_flow_log", L7_ROWS),
         ("profile.tpu_step_metrics", STEP_ROWS),
         ("flow_log.l4_flow_log", [{"time": 1}])])
    assert [json.loads(b) for b in got] == [json.loads(b) for b in want]
    spans = [s for b in got for rs in json.loads(b)["resourceSpans"]
             for ss in rs["scopeSpans"] for s in ss["spans"]]
    steps = [s for s in spans if s["traceId"] == "steprun-3"]
    assert len(steps) == len(STEP_ROWS)
    for s, row in zip(steps, STEP_ROWS):
        attrs = {a["key"]: next(iter(a["value"].values()))
                 for a in s["attributes"]}
        assert attrs == {"tpu.run_id": 3, "tpu.step": row["step"],
                         "tpu.device_count": 8,
                         "tpu.device_skew_ns": row["device_skew_ns"],
                         "tpu.collective_ns": row["collective_ns"],
                         "tpu.straggler_device": row["straggler_device"],
                         "host.name": "gpu-node-0"}
        assert s["endTimeUnixNano"] == str(row["end_ns"] or row["time"])


def test_remote_write_ships_the_references_bytes():
    got, want = _ship_both(
        lambda m, url: m.RemoteWriteExporter(url, flush_interval_s=FLUSH_S,
                                             batch_size=3),
        [("flow_metrics.network.1s", NET_ROWS),
         ("flow_metrics.application.1s", APP_ROWS)])
    assert got == want
    from deepflow_tpu_torch.server.integration import parse_write_request
    series = [s for b in got
              for s in parse_write_request(snappy.decompress(b))]
    assert len(series) == 5 * len(NET_ROWS) + 4 * len(APP_ROWS)
    first = series[0]
    assert first[0] == "flow_metrics_network_byte_tx"
    assert first[1] == {"ip_src": "10.0.1.0", "ip_dst": "10.0.2.1",
                        "app_service": "web"}
    assert first[2] == [(1_700_000_000_000, 0.0)]


def _kafka_values(broker) -> list:
    return sorted(json.dumps(json.loads(v), sort_keys=True)
                  for vs in broker.messages.values() for v in vs)


def test_kafka_ships_the_references_messages():
    brokers = [kafka_stub.StubBroker(n_partitions=2) for _ in range(2)]
    for b in brokers:
        b.start()
    try:
        exps = [m.KafkaExporter(f"kafka://127.0.0.1:{b.port}/telemetry",
                                tables=("flow_log.l7_flow_log",),
                                batch_size=4, flush_interval_s=FLUSH_S)
                for m, b in zip((exp, ref_exp), brokers)]
        for e in exps:
            e.feed("flow_log.l7_flow_log", L7_ROWS)
            e.feed("profile.tpu_step_metrics", STEP_ROWS)
        with _running(*exps):
            assert _wait(lambda: all(e.stats["exported"] >= len(L7_ROWS)
                                     for e in exps))
        assert _kafka_values(brokers[0]) == _kafka_values(brokers[1])
        assert sorted(json.dumps({"table": "flow_log.l7_flow_log", **r},
                                 sort_keys=True) for r in L7_ROWS) == \
            _kafka_values(brokers[0])
        assert len(brokers[0].messages) == 2  # round-robin
        assert brokers[0].crc_failures == 0
        assert (3, 0) in brokers[0].api_versions_seen
        assert (0, 2) in brokers[0].api_versions_seen
    finally:
        for b in brokers:
            b.stop()


def test_kafka_retries_a_retriable_error_like_the_reference():
    """NOT_LEADER_FOR_PARTITION on the first produce: the retry finds
    the leader again and ships."""
    stats = []
    for m in (exp, ref_exp):
        broker = kafka_stub.StubBroker(n_partitions=1, produce_errors=[6])
        broker.start()
        try:
            e = m.KafkaExporter(f"kafka://127.0.0.1:{broker.port}/flows",
                                batch_size=2, flush_interval_s=FLUSH_S,
                                max_retries=2)
            with _running(e):
                e.feed("t", [{"x": 1}, {"x": 2}])
                assert _wait(lambda: len(broker.messages.get(0, [])) >= 2)
            stats.append({k: e.stats[k] for k in ref_exp.BaseExporter(
                "x").stats})
        finally:
            broker.stop()
    assert stats[0] == stats[1]
    assert stats[0]["errors"] == 1 and stats[0]["exported"] == 2


def test_kafka_endpoint_validation():
    for bad in ("http://host:9092/topic", "kafka://host:9092"):
        with pytest.raises(ValueError):
            exp.KafkaExporter(bad)


def _ledger(e) -> dict:
    snap = e._hop.snapshot()
    return {k: snap[k] for k in ("emitted", "delivered", "dropped",
                                 "in_flight")}


def test_spool_and_replay_with_the_references_ledger(tmp_path):
    """A destination that refuses: every batch goes to the disk spool
    and stays in flight. An exporter started later on the same spool
    (a restart) replays it once the destination answers, adopting the
    rows into its own ledger as it ships them."""
    views = []
    for m, tel in ((exp, Telemetry), (ref_exp, RefTelemetry)):
        spool = str(tmp_path / m.__name__.split(".")[0])
        with _sinks(1) as (sink,):
            sink.refuse = True
            first = m.JsonLinesExporter(
                sink.url, flush_interval_s=FLUSH_S, batch_size=4,
                max_retries=0, spool_dir=spool).attach_telemetry(
                    tel("server", enabled=True))
            with _running(first):
                first.feed("event.event", [{"i": i} for i in range(10)])
                assert _wait(lambda: first.stats["spooled"] == 10)
            sink.refuse = False
            second = m.JsonLinesExporter(
                sink.url, flush_interval_s=FLUSH_S, spool_dir=spool
            ).attach_telemetry(tel("server", enabled=True))
            with _running(second):
                assert _wait(lambda: second.stats["replayed"] == 10)
            lines = sorted(json.loads(ln)["i"] for _, _, b in sink.received
                           for ln in b.splitlines())
        views.append((_ledger(first), _ledger(second),
                      {k: first.stats[k] for k in ("spooled", "dropped")},
                      {k: second.stats[k] for k in ("replayed",
                                                    "exported")},
                      lines))
    assert views[0] == views[1]
    first, second, _, _, lines = views[0]
    assert first == {"emitted": 10, "delivered": 0, "dropped": {},
                     "in_flight": 10}
    assert second == {"emitted": 10, "delivered": 10, "dropped": {},
                      "in_flight": 0}
    assert lines == list(range(10))


def test_ledger_balances_through_an_outage():
    """No spool: a batch the destination refuses through every retry is
    dropped (ship_failed). At every look emitted == delivered + dropped
    + in flight; after the stop nothing is in flight."""
    with _sinks(1) as (sink,):
        # no retry: a refused batch costs one 0.5 s back-off, so the six
        # rows drop well inside the wait however the feed is batched
        e = exp.OtlpJsonExporter(sink.url, flush_interval_s=FLUSH_S,
                                 batch_size=3, max_retries=0)
        e.attach_telemetry(Telemetry("server", enabled=True))
        with _running(e):
            e.feed("flow_log.l7_flow_log", L7_ROWS[:6])
            assert _wait(lambda: e.stats["exported"] == 6)
            sink.refuse = True
            e.feed("flow_log.l7_flow_log", L7_ROWS[6:])
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline and \
                    e.stats["dropped"] < len(L7_ROWS) - 6:
                snap = e._hop.snapshot()
                assert snap["emitted"] == snap["delivered"] + \
                    snap["dropped_total"] + snap["in_flight"]
                time.sleep(0.02)
            sink.refuse = False
            e.feed("flow_log.l7_flow_log", L7_ROWS[:3])
            assert _wait(lambda: e.stats["exported"] == 9)
        snap = e._hop.snapshot()
    assert snap["emitted"] == 15 and snap["delivered"] == 9
    assert snap["dropped"] == {"ship_failed": 6} and snap["in_flight"] == 0
    assert e.stats["errors"] >= 2


def test_queue_full_rows_enter_and_leave_the_ledger():
    e = exp.JsonLinesExporter("http://127.0.0.1:9/x", queue_size=4)
    e.attach_telemetry(Telemetry("server", enabled=True))
    e.feed("t", [{"i": i} for i in range(10)])  # not started: queue fills
    snap = e._hop.snapshot()
    assert (snap["emitted"], snap["dropped"], snap["in_flight"]) == \
        (10, {"queue_full": 6}, 4)
    assert e.stats["dropped"] == 6


def test_manager_add_is_idempotent_and_remove_stops():
    mgr = exp.ExporterManager(telemetry=Telemetry("server", enabled=True))
    try:
        a = mgr.add(exp.JsonLinesExporter("http://127.0.0.1:9/a",
                                          flush_interval_s=FLUSH_S))
        assert mgr.add(exp.JsonLinesExporter(
            "http://127.0.0.1:9/a", flush_interval_s=FLUSH_S)) is a
        mgr.add(exp.OtlpJsonExporter("http://127.0.0.1:9/a",
                                     flush_interval_s=FLUSH_S))
        assert len(mgr.exporters) == 2
        assert mgr.wants("flow_log.l7_flow_log")
        assert set(mgr.stats()) == {"JsonLinesExporter:http://127.0.0.1:9/a",
                                    "OtlpJsonExporter:http://127.0.0.1:9/a"}
        assert mgr.remove("http://127.0.0.1:9/a") == 2
        assert mgr.exporters == [] and not mgr.wants("event.event")
        assert not a._thread.is_alive()
        assert mgr.remove("http://127.0.0.1:9/a") == 0
    finally:
        mgr.stop()


# -- through the servers ------------------------------------------------------

def _api(port: int, path: str, body: dict | None = None) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def pair():
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    port = Server(ingest_port=0, query_port=0, sync_port=0,
                  selfstats_interval_s=3600).start()
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _frames_bytes() -> bytes:
    frames, _ = tsrv._frames()
    flows = tfi.flow_frames()
    return b"".join(frames) + b"".join(
        encode_frame(FrameHeader(MessageType(mt)), p) for mt, p in flows)


def _exported_rows(sink) -> dict:
    by = collections.defaultdict(list)
    for _, _, body in sink.received:
        for ln in body.splitlines():
            row = json.loads(ln)
            by[row.pop("table")].append(json.dumps(row, sort_keys=True))
    return {t: sorted(rows) for t, rows in by.items()}


def test_servers_export_the_references_rows_from_every_decoder(pair):
    """A json-lines exporter of every table on both servers: the rows
    each decoder exports (the native columnar TPU_SPAN, flow-log and
    document decodes among them) equal the reference's, key for key."""
    ref, port = pair
    with _sinks(2) as sinks:
        for srv, sink in zip(pair, sinks):
            code, out = _api(srv.query_port, "/v1/exporters",
                             {"type": "json-lines", "endpoint": sink.url})
            assert code == 200 and out["added"] == "json-lines"
        try:
            data = _frames_bytes()
            before = sum(d.stats["export_rows"] for d in port.decoders)
            for srv in pair:
                tsrv._send(srv.ingest_port, data)
            want_tables = {"profile.tpu_hlo_span", "profile.tpu_memory",
                           "profile.tpu_step_metrics",
                           "flow_log.l4_flow_log", "flow_log.l7_flow_log",
                           "flow_metrics.network.1s",
                           "flow_metrics.application.1s"}
            assert _wait(lambda: want_tables <= set(_exported_rows(
                sinks[0])) and _exported_rows(sinks[0]).keys()
                == _exported_rows(sinks[1]).keys()
                and all(len(v) == len(_exported_rows(sinks[1])[k])
                        for k, v in _exported_rows(sinks[0]).items()))
            got, want = (_exported_rows(s) for s in sinks)
            assert got == want
            built = sum(d.stats["export_rows"] for d in port.decoders) \
                - before
            columnar = ("profile.tpu_hlo_span", "profile.tpu_memory",
                        "flow_log.l4_flow_log", "flow_log.l7_flow_log",
                        "flow_metrics.network.1s",
                        "flow_metrics.application.1s")
            assert built == sum(len(got[t]) for t in columnar)
        finally:
            for srv, sink in zip(pair, sinks):
                assert _api(srv.query_port, "/v1/exporters/delete",
                            {"endpoint": sink.url})[1] == {"removed": 1}


def test_no_row_dicts_without_an_exporter_that_wants_the_table(pair):
    """With no exporter, and with one that takes other tables, the
    columnar decodes build no row dict."""
    _, port = pair
    with _sinks(1) as (sink,):
        for attach in (False, True):
            if attach:
                assert _api(port.query_port, "/v1/exporters",
                            {"type": "json-lines", "endpoint": sink.url,
                             "tables": ["event.event"]})[0] == 200
            before = {d.MSG_TYPE.name: (d.stats["export_rows"],
                                        d.stats["rows"])
                      for d in port.decoders}
            tsrv._send(port.ingest_port, _frames_bytes())
            assert _wait(lambda: all(
                d.stats["rows"] > before[d.MSG_TYPE.name][1]
                for d in port.decoders
                if d.MSG_TYPE.name in ("TPU_SPAN", "L7_LOG", "METRICS")))
            assert {d.MSG_TYPE.name: d.stats["export_rows"]
                    for d in port.decoders} == \
                {k: v[0] for k, v in before.items()}
        assert _api(port.query_port, "/v1/exporters/delete",
                    {"endpoint": sink.url})[1] == {"removed": 1}


def test_step_spans_from_the_servers_step_records(pair):
    """The otlp-json exporter on both servers: each step record the
    STEP_METRICS frames carry reaches the sink as one step span, the
    same span on both."""
    frames, counts = tsrv._frames()
    with _sinks(2) as sinks:
        for srv, sink in zip(pair, sinks):
            assert _api(srv.query_port, "/v1/exporters",
                        {"type": "otlp-json", "endpoint": sink.url})[0] \
                == 200
        try:
            for srv in pair:
                tsrv._send(srv.ingest_port, b"".join(frames))
            n = counts["profile.tpu_step_metrics"]

            def step_spans(sink):
                return sorted(
                    (json.dumps(s, sort_keys=True) for _, _, b in
                     list(sink.received)
                     for rs in json.loads(b)["resourceSpans"]
                     for ss in rs["scopeSpans"] for s in ss["spans"]
                     if s["traceId"].startswith("steprun-")))
            assert _wait(lambda: len(step_spans(sinks[0])) >= n
                         and len(step_spans(sinks[1])) >= n)
            assert step_spans(sinks[0]) == step_spans(sinks[1])
            assert len(step_spans(sinks[0])) == n
        finally:
            for srv, sink in zip(pair, sinks):
                _api(srv.query_port, "/v1/exporters/delete",
                     {"endpoint": sink.url})


def test_exporters_api_refuses_like_the_reference(pair):
    ref, port = pair
    for body in ({"type": "kafka", "endpoint": "kafka://x"},
                 {"type": "nope", "endpoint": "http://127.0.0.1:9/"},
                 {"type": "json-lines"}):
        got, want = (_api(s.query_port, "/v1/exporters", body)
                     for s in (port, ref))
        assert got == want and got[0] == 400
    assert _api(port.query_port, "/v1/exporters") == \
        (200, {"exporters": {}})


def _cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_dfctl_exporter_and_events_like_the_reference(pair, tmp_path):
    ref, port = pair
    with _sinks(1) as (sink,):
        spec = json.dumps({"type": "json-lines", "endpoint": sink.url,
                           "tables": ["event.event"]})
        path = tmp_path / "spec.json"
        path.write_text(spec)
        outs = []
        for srv, main in ((port, dfctl.main), (ref, ref_dfctl.main)):
            addr = ["--server", f"127.0.0.1:{srv.query_port}"]
            outs.append([
                _cli(main, addr + ["exporter", "list"]),
                _cli(main, addr + ["exporter", "add", spec]),
                _cli(main, addr + ["exporter", "add", f"@{path}"]),
                _cli(main, addr + ["exporter", "delete", sink.url]),
                _cli(main, addr + ["exporter", "delete", sink.url]),
                _cli(main, addr + ["exporter", "list"])])
        assert outs[0] == outs[1]
        assert outs[0][1] == f"added json-lines -> {sink.url}\n"
        assert outs[0][3] == "removed: 1\n" and outs[0][5] == "(none)\n"
    batch = wire.EventBatch([wire.Event(
        timestamp_ns=1_700_000_000_000_000_000 + i, event_type=t,
        resource_type="process", resource_name=f"p{i}", pid=i,
        description=f"event {i}") for i, t in enumerate(
            ["process-start", "process-exit", "process-start"])])
    frame = encode_frame(FrameHeader(MessageType.EVENT, agent_id=4),
                         batch.SerializeToString())
    for srv in pair:
        tsrv._send(srv.ingest_port, frame)
        assert srv.wait_for_rows("event.event", 3, timeout=WAIT_S)
    for extra in ([], ["--type", "process-start"], ["--limit", "1"]):
        got = _cli(dfctl.main, ["--server", f"127.0.0.1:{port.query_port}",
                                "events"] + extra)
        want = _cli(ref_dfctl.main, ["--server",
                                     f"127.0.0.1:{ref.query_port}",
                                     "events"] + extra)
        assert got == want
    assert "process-exit" not in _cli(dfctl.main, [
        "--server", f"127.0.0.1:{port.query_port}", "events", "--type",
        "process-start"])
